"""The reference-math side of the flagship comparison in the port's scripts
against the JAX scripts: posterior_torch.run_oracle_mh against
posterior_compare.run_oracle_mh draw for draw (uniform, covariance,
resumed), oracle_logll through a pool of spawned workers against
posterior_compare.oracle_logll bit for bit, extend_oracle_torch's set-up
against extend_oracle.main's, and flagship_torch's ll-check thinning and
table against posterior_compare.run_ll_check's."""

import builtins
import importlib.util
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
from torch_parity import REPO

SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import extend_oracle_torch as eot  # noqa: E402
import flagship_torch as ft  # noqa: E402
import posterior_torch as pt  # noqa: E402


def _load_script(name, module_name=None):
    """A fresh module object of scripts/<name>.py, so that presets applied
    to it touch no other test's copy."""
    spec = importlib.util.spec_from_file_location(
        module_name or name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def private_pc(monkeypatch):
    """A private posterior_compare, without the persistent compile cache."""
    monkeypatch.setenv("METROTRPL_NO_COMPILE_CACHE", "1")
    return _load_script("posterior_compare")


def _analytic_ll(true, active):
    """A cheap ll of a state dict: a Gaussian in log10 about the truth,
    0.03 decades wide per active parameter, so that the chain both accepts
    and refuses."""
    def ll(state):
        return -sum(float(np.log10(state[k] / true[k]) / 0.03) ** 2
                    for k in active)
    return ll


def _ridge_cov(d, seed=11):
    """A seeded correlated (d, d) log10 proposal covariance."""
    a = np.random.default_rng(seed).normal(0, 0.004, (d, d))
    return a @ a.T + 1e-6 * np.eye(d)


@pytest.mark.parametrize("proposal", ["uniform", "covariance"])
def test_run_oracle_mh_replays_the_reference_chain(private_pc, monkeypatch,
                                                   tmp_path, proposal):
    """Under the full preset, on one analytic ll put into both modules, the
    port's chain equals posterior_compare.run_oracle_mh's draw for draw over
    300 iterations, and again when both resume from their partials at 200;
    samples and acceptance exactly, the partial's draws too, and the port's
    partial records both runs (resumed_at 0, then 200)."""
    pc = private_pc
    pc.apply_preset("full")
    w = pt.std_workload()
    ll = _analytic_ll(pc.TRUE, pc.ACTIVE)
    monkeypatch.setattr(pc, "oracle_logll", lambda t, vals, state: ll(state))
    monkeypatch.setattr(pt, "oracle_logll",
                        lambda w_, t, vals, state, pool=None: ll(state))
    cov = _ridge_cov(len(w.active)) if proposal == "covariance" else None
    t, vals = np.zeros(1), [np.zeros(1)] * 6
    quiet = dict(log=lambda s: None)

    want, acc_want = pc.run_oracle_mh(t, vals, 300, cov=cov)
    got, acc_got = pt.run_oracle_mh(w, t, vals, 300, cov=cov, **quiet)
    assert acc_got == acc_want and 0.05 < acc_got < 0.95
    for k in w.active:
        np.testing.assert_array_equal(got[k], want[k])

    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    pc.run_oracle_mh(t, vals, 200, partial_path=jp, cov=cov)
    pt.run_oracle_mh(w, t, vals, 200, partial_path=tp, cov=cov, **quiet)
    zj, zt = dict(np.load(jp)), dict(np.load(tp))
    assert int(zt["n_done"]) == int(zj["n_done"]) == 200
    assert float(zt["acc"]) == float(zj["acc"])
    want, acc_want = pc.run_oracle_mh(t, vals, 300, resume=zj, cov=cov)
    got, acc_got = pt.run_oracle_mh(w, t, vals, 300, partial_path=tp,
                                    resume=zt, cov=cov, **quiet)
    assert acc_got == acc_want
    for k in w.active:
        np.testing.assert_array_equal(got[k], want[k])
    z = np.load(tp)
    assert int(z["n_done"]) == 300
    assert z["resumed_at"].tolist() == [0, 200]
    assert z["workers"].tolist() == [1, 1]
    for k in w.active:
        np.testing.assert_array_equal(z[k], want[k])


def test_run_oracle_mh_stops_at_a_partial(monkeypatch, tmp_path):
    """A chain asked to stop after its 150th iteration writes its partial
    there (n_done 150, the draws of an unstopped chain) and returns; the
    run resumed from it continues the partial's draws."""
    w = pt.std_workload()
    ll = _analytic_ll(w.true, w.active)
    monkeypatch.setattr(pt, "oracle_logll",
                        lambda w_, t, vals, state, pool=None: ll(state))
    t, vals = np.zeros(1), [np.zeros(1)] * 6
    full, _ = pt.run_oracle_mh(w, t, vals, 200, log=lambda s: None)
    asked = []
    path = str(tmp_path / "p.npz")
    pt.run_oracle_mh(w, t, vals, 200, partial_path=path, log=lambda s: None,
                     stop=lambda: asked.append(1) or len(asked) >= 150)
    z = dict(np.load(path))
    assert int(z["n_done"]) == 150 and len(asked) == 150
    for k in w.active:
        np.testing.assert_array_equal(z[k], full[k][:150])
    more, _ = pt.run_oracle_mh(w, t, vals, 200, partial_path=path, resume=z,
                               log=lambda s: None)
    assert np.load(path)["resumed_at"].tolist() == [0, 150]
    for k in w.active:
        np.testing.assert_array_equal(more[k][:150], full[k][:150])
        assert np.isfinite(more[k]).all()


def test_oracle_logll_in_a_pool_equals_the_reference(private_pc):
    """At two full-preset states (nx=32), oracle_logll with its 6 curves
    solved in 2 spawned workers, and oracle_logll_states over the same
    pool, equal posterior_compare.oracle_logll bit for bit; so does the
    serial oracle_logll."""
    pc = private_pc
    pc.apply_preset("full")
    w = pt.std_workload()
    t, vals = pt.make_dataset(w)
    states = [dict(w.start),
              {k: v * {"mu_n": 1.5, "Sf": 3.0}.get(k, 1.0)
               for k, v in w.true.items()}]
    want = [pc.oracle_logll(t, vals, s) for s in states]
    assert all(np.isfinite(want))
    with pt.oracle_pool(2) as pool:
        got = [pt.oracle_logll(w, t, vals, s, pool) for s in states]
        many, rows = pt.oracle_logll_states(w, t, vals, states, pool)
    serial = [pt.oracle_logll(w, t, vals, s) for s in states]
    np.testing.assert_array_equal(
        rows, [pt.oracle_row_ll(w, t, vals, s) for s in states])
    for a in (got, many, serial):
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float64),
                                      np.asarray(want, dtype=np.float64))


def test_pool_workers_stay_in_the_group_and_ignore_sigterm():
    """The oracle's workers share the caller's process group, so that a
    SIGKILL to the group reaches them, and ignore SIGTERM, so that a
    SIGTERM to the group stops the caller between tasks and no worker in
    the middle of one. Checked in a session of its own, killed whole if
    it hangs (a worker that dies of SIGTERM can take the pool's queue lock
    with it)."""
    code = (
        "import os, signal, sys, time\n"
        f"sys.path[:0] = [{SCRIPTS!r}, {REPO!r}]\n"
        "import posterior_torch as pt\n"
        "with pt.oracle_pool(1) as pool:\n"
        "    pid = pool.apply(os.getpid)\n"
        "    print(pool.apply(os.getpgrp) == os.getpgrp(), flush=True)\n"
        "    os.kill(pid, signal.SIGTERM)\n"
        "    time.sleep(0.5)\n"
        "    print(pool.apply(os.getpid) == pid, flush=True)\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=90)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    assert out.split() == ["True", "True"] and proc.returncode == 0, out


@pytest.mark.parametrize("start_from", ["committed", "partial"])
def test_extension_setup_equals_extend_oracle(private_pc, monkeypatch,
                                              tmp_path, start_from):
    """extend_oracle_torch.main and extend_oracle.main (run unedited, their
    chain runner and dataset stubbed, their files under tmp_path, target
    3300) call their run_oracle_mh with the same target, covariance,
    start, resume and draw substream; from the committed chain and from a
    partial of each at 3250."""
    pc = private_pc
    monkeypatch.setitem(sys.modules, "posterior_compare", pc)
    eo = _load_script("extend_oracle", "extend_oracle_under_test")
    w = ft.flagship_workload()
    t, vals = np.zeros(1), [np.zeros(1)] * 6
    if start_from == "partial":
        z = np.load(ft.ORACLE_CHAIN)
        rng = np.random.default_rng(4)
        draws = {k: np.concatenate([z[k], z[k][-1] * 10 ** rng.normal(
            0, 0.01, 50)]) for k in w.active}
        for name in (f".oracle_tmh_ext_3300_{w.seed}.npz",
                     f".oracle_tmh_ext_torch_3300_{w.seed}.npz"):
            np.savez(tmp_path / (name + ".partial.npz"), n_done=3250,
                     acc=0.41, **draws)
    seen = {}

    def stub(key):
        def run(*args, **kw):
            seen[key] = (args, kw)
            if kw.get("partial_path") and key == "port":
                np.savez(kw["partial_path"], n_done=3300,
                         resumed_at=[3250], s_per_iter=[1.0], workers=[6])
            return {k: np.zeros(3) for k in w.active}, 0.5
        return run

    monkeypatch.setattr(pc, "run_oracle_mh", stub("jax"))
    monkeypatch.setattr(pc, "make_dataset", lambda: (t, vals))
    monkeypatch.setattr(eo, "HERE", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["extend_oracle.py", "3300"])
    eo.main()
    monkeypatch.setattr(pt, "run_oracle_mh", stub("port"))
    monkeypatch.setattr(ft, "checked_dataset", lambda w_: (t, vals, "-"))
    monkeypatch.setattr(eot, "HERE", str(tmp_path))
    eot.main(["3300", "--workers", "3"])

    (ja, jk), (ta, tk) = seen["jax"], seen["port"]
    assert ja[2] == ta[3] == 3300 and ta[0] == w
    assert tk["workers"] == 3
    assert tk["partial_path"] == str(
        tmp_path / f".oracle_tmh_ext_torch_3300_{w.seed}.npz.partial.npz")
    np.testing.assert_array_equal(tk["cov"], jk["cov"])
    assert tk["start"] == jk["start"]
    rj, rt = jk["resume"], tk["resume"]
    n0 = 3250 if start_from == "partial" else 3200
    assert int(rt["n_done"]) == int(rj["n_done"]) == n0
    assert rt["acc"] == rj["acc"]
    for k in w.active:
        np.testing.assert_array_equal(rt[k], rj[k])
    assert pt.oracle_seed(w, tk["cov"], int(rt["n_done"])) == \
        pc.SEED + 100001 + n0


def test_ll_check_thinning_and_table_equal_run_ll_check(private_pc,
                                                        monkeypatch,
                                                        tmp_path):
    """posterior_compare.run_ll_check (run unedited under the flagship
    preset: its cached chains, oracle and kernel replaced by seeded
    arrays, its report written to tmp_path) evaluates the states that
    flagship_torch.ll_check_states thins from the same three sources, bit
    for bit, and reports the |dll| table row, finite count and tails that
    ll_table_lines gives on the same ll arrays."""
    import metrotrpl_tpu.inference.likelihood as jl
    import metrotrpl_tpu.inference.metropolis as jm
    import metrotrpl_tpu.inference.moves as jmv

    pc = private_pc
    pc.apply_preset("flagship")
    w = ft.flagship_workload()
    rng = np.random.default_rng(8)

    def chain(shape):
        return {k: w.true[k] * 10 ** rng.normal(0, 0.2, shape)
                for k in w.active}

    warm_n, ridge_n, tpu_n, n_states = 90, 120, 60, 30
    warm, ridge, tpu = chain(warm_n), chain(ridge_n), chain((tpu_n, 4))
    S = n_states
    ll_o = -1010 - rng.exponential(1.0, S)
    ll_o[3] = -np.inf
    ll_t = (ll_o + rng.normal(0, 0.8, S)).astype(np.float32)
    ll_t[5] = ll_o[5] - 25.0
    seen = []

    def oracle(t, vals, state):
        seen.append(dict(state))
        return ll_o[len(seen) - 1]

    class Kernel:
        def init_ll(self, block):
            assert block.shape[0] == 64
            return np.diag(np.concatenate([ll_t, np.zeros(64 - S,
                                                          np.float32)]))

    monkeypatch.setattr(pc, "_cached_oracle_mh", lambda t, v, n: (warm, 0.4))
    monkeypatch.setattr(pc, "_cached_oracle_ridge",
                        lambda t, v, n, wn: (ridge, 0.4))
    monkeypatch.setattr(pc, "_cached_tpu_mh",
                        lambda t, v, n, h, r: (tpu, 0.3))
    monkeypatch.setattr(pc, "oracle_logll", oracle)
    monkeypatch.setattr(jl, "build_likelihood_plan", lambda *a, **k: None)
    monkeypatch.setattr(jmv, "build_move_plan", lambda *a, **k: None)
    monkeypatch.setattr(jm, "build_mh_kernel", lambda *a, **k: Kernel())
    out = tmp_path / "ll.md"
    monkeypatch.setattr(pc, "open", lambda p, m="r": builtins.open(out, m),
                        raising=False)
    t = np.linspace(0, pc.T_END, pc.NT)
    pc.run_ll_check(t, [np.zeros(pc.NT)] * 6, n_states, 48.0, 4, warm_n,
                    ridge_n, "LL.md", tpu_n=tpu_n)

    flat = {k: v[tpu_n // 3:].ravel() for k, v in tpu.items()}
    states = ft.ll_check_states(w, [(warm, warm_n, warm_n // 3),
                                    (ridge, ridge_n, ridge_n // 3),
                                    (flat, len(flat["mu_n"]), 0)], n_states)
    assert len(seen) == len(states) == S
    for s, row in zip(seen, states):
        assert s == dict(zip(w.names, row.tolist()))
    text = out.read_text().splitlines()
    lines = ft.ll_table_lines(ft.ll_table(ll_t.astype(np.float64), ll_o))
    row = next(ln for ln in text if re.match(r"\| [0-9.]+ \| ", ln))
    assert row == lines[2]
    for key in ("states finite in both", "Tail:"):
        want = next(ln for ln in text if key in ln)
        got = next(ln for ln in lines if key in ln)
        assert got == want
    tab = ft.ll_table(ll_t.astype(np.float64), ll_o)
    assert (tab["finite"], tab["over20"], tab["suppress"] >= 1) == (
        S - 1, 1, True)


def test_file_states_split_at_the_ridge():
    """file_states takes 8 states above mu_n 50 and 8 at or below it, in
    the check's order, and refuses when a side has fewer."""
    mu = np.concatenate([np.linspace(20, 49, 30), np.linspace(51, 99, 20)])
    idx = ft.file_states(mu)
    assert len(idx) == 16 and (mu[idx[:8]] > 50).all() \
        and (mu[idx[8:]] <= 50).all()
    assert idx[0] == 30 and idx[7] == 49 and idx[8] == 0 and idx[15] == 29
    with pytest.raises(RuntimeError):
        ft.file_states(mu[:35])
