"""scripts/esc_validation_torch.py against scripts/esc_validation.py: the
row classes and |dll| percentiles on the same arrays, the thinned states
and the oracle rows, and the escalate-free float64 evaluation against the
JAX XLA path at nx=32."""

import builtins
import importlib
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import REPO

SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import esc_validation_torch as ev  # noqa: E402
import posterior_torch as pt  # noqa: E402


@pytest.fixture(scope="module")
def jax_esc():
    """scripts/esc_validation.py (posterior_compare under the full preset)
    without the persistent compile cache."""
    old = os.environ.get("METROTRPL_NO_COMPILE_CACHE")
    os.environ["METROTRPL_NO_COMPILE_CACHE"] = "1"
    try:
        esc = importlib.import_module("esc_validation")
    finally:
        if old is None:
            del os.environ["METROTRPL_NO_COMPILE_CACHE"]
        else:
            os.environ["METROTRPL_NO_COMPILE_CACHE"] = old
    esc.pc.apply_preset("full")
    return esc


def _rows(n, M, seed=5):
    """Seeded (n, M) rows of every kind esc_validation.py tells apart:
    residuals over and under tol and NaN, escalate-free ll finite and
    -inf, inline ll finite and -inf, oracle ll finite and -inf."""
    rng = np.random.default_rng(seed)
    resid = rng.uniform(0, 0.2, (n, M))
    resid[rng.random((n, M)) < 0.05] = np.nan
    ll_off = -rng.uniform(50, 200, (n, M))
    ll_off[rng.random((n, M)) < 0.1] = -np.inf
    ll_in = ll_off + rng.normal(0, 0.3, (n, M))
    flagged = ~(resid < 0.1) | ~np.isfinite(ll_off)
    ll_in[flagged] = -rng.uniform(50, 200, int(flagged.sum()))
    ll_in[flagged & (rng.random((n, M)) < 0.2)] = -np.inf
    ll_o = ll_in + rng.normal(0, 0.5, (n, M))
    ll_o[rng.random((n, M)) < 0.03] = -np.inf
    return resid, ll_off, ll_in, ll_o


def test_row_classes_and_percentiles_equal_esc_validation(jax_esc, tmp_path,
                                                          monkeypatch):
    """esc_validation.main() run unedited on seeded rows (its walk,
    evaluations and oracle replaced by the arrays, its report written to
    tmp_path) reports the flag rate, class counts and |dll| percentiles
    that the port's row_classes and dll_percentiles give on them; the
    states it thins are thin_states'; and the mu_n bands split the
    states."""
    esc = jax_esc
    pc = esc.pc
    n, M, n_iters = 24, len(pc.LENGTHS), 30
    resid, ll_off, ll_in, ll_o = _rows(n, M)
    rng = np.random.default_rng(6)
    samples = {k: pc.TRUE[k] * 10 ** rng.uniform(-0.2, 0.2, (n_iters, 4))
               for k in pc.ACTIVE}
    t = np.linspace(0, pc.T_END, pc.NT)
    vals = [np.zeros(pc.NT)] * M
    seen = {}

    class Plan:
        newton_div_tol = None

    def fake_eval(plan, dtype=None, escalate="inline", eval_chunk=None):
        def f(states, temps):
            seen.setdefault("states", np.asarray(states))
            pm = ll_off if escalate == "off" else ll_in
            return {"resid": resid, "per_meas": pm[..., None]}
        return f

    calls = iter(ll_o)
    monkeypatch.setattr(pc, "make_dataset", lambda: (t, vals))
    monkeypatch.setattr(pc, "_cached_tpu_mh",
                        lambda *a, **k: (samples, 0.3))
    monkeypatch.setattr(esc, "build_likelihood_plan", lambda *a, **k: Plan)
    monkeypatch.setattr(esc, "make_eval_logll", fake_eval)
    monkeypatch.setattr(esc, "jax", types.SimpleNamespace(jit=lambda f: f))
    monkeypatch.setattr(esc, "oracle_row_ll", lambda *a: next(calls))
    out = tmp_path / "esc.md"
    monkeypatch.setattr(esc, "open", lambda p, m="r": builtins.open(out, m),
                        raising=False)
    monkeypatch.setattr(sys, "argv", ["esc_validation.py", str(n),
                                      str(n_iters)])
    esc.main()
    text = out.read_text()

    w = pt.std_workload()
    np.testing.assert_array_equal(
        ev.thin_states(w, samples, n).astype(np.float32), seen["states"])
    cls = ev.row_classes(resid, ll_off, ll_in, 0.1)
    assert f"**{cls['flagged'].mean():.3f}** of rows; " \
           f"{int(cls['flagged'].any(axis=1).sum())}/{n} states" in text
    assert f"finite post-repair): {int(cls['repaired'].sum())}/{n * M}" \
        in text
    assert f"(-inf post-repair): {int(cls['conceded'].sum())}/{n * M}" \
        in text
    assert cls["repaired"].sum() and cls["conceded"].sum()
    d = ll_in - ll_o
    for c, label in (("repaired", "REPAIRED rows"),
                     ("unflagged", "unflagged rows")):
        q = ev.dll_percentiles(d[cls[c]])
        want = (f"p50 {q[0]:.3f}, p90 {q[1]:.3f}, p99 {q[2]:.3f}, "
                f"max {q[3]:.3f} (n={q[4]})")
        got = re.search(re.escape(label) + r"[^:]*: (.*)$", text, re.M)
        assert got.group(1) == want
    assert ev.dll_percentiles(np.array([np.inf, np.nan])) is None
    mu = np.array([10.0, 30.0, 30.5, 40.0, 45.0, 50.0, 50.1, 99.0])
    bands = ev.mu_band_masks(mu)
    assert [int(b.sum()) for b in bands.values()] == [2, 2, 2, 2]
    assert np.array_equal(sum(b.astype(int) for b in bands.values()),
                          np.ones(8, int))
    evals = {"resid": resid, "score": resid, "ll_off": ll_off,
             "ll_in": ll_in, "tol": 0.1, "repair_rows": 0}
    states = ev.thin_states(w, samples, n)
    lines = ev.shape_section("nx32", w, "seeded rows", states, evals, ll_o,
                             "the CPU", ref=("other states", states, ll_o))
    assert sum("oracle ll of a state median" in ln for ln in lines) == 2
    for c, k in (("unflagged", 5), ("repaired", 5), ("conceded", 1)):
        assert sum(ln.startswith(f"| {c} |") for ln in lines) == k


def test_oracle_rows_equal_esc_validation_in_worker_processes(jax_esc):
    """The port's oracle rows, computed in two spawned workers, equal
    esc_validation.oracle_row_ll at two full-preset states bit for bit."""
    esc = jax_esc
    pc = esc.pc
    w = pt.std_workload()
    t, vals = pt.make_dataset(w)
    states = np.stack([[w.start[k] for k in w.names],
                       [w.true[k] * (1.5 if k == "mu_n" else 1.0)
                        for k in w.names]])
    ll = ev.oracle_rows(w, t, vals, states, 2)
    assert ll.shape == (2, 6) and np.isfinite(ll).all()
    for s, row in zip(states, ll):
        want = esc.oracle_row_ll(t, vals, dict(zip(pc.NAMES, map(float, s))))
        np.testing.assert_array_equal(row, want)


def compare_float64_evaluation(esc, escalate):
    """At 2 full-preset states (nx=32), the port's plain float64
    evaluation on the fast plan (without the escalation ladder when
    escalate is False) against the JAX XLA path's (escalate="off" or
    "inline"): per_meas, resid and esc_score within rel 1e-9."""
    from metrotrpl_tpu.inference.likelihood import (
        build_likelihood_plan,
        make_eval_logll,
    )
    from metrotrpl_tpu_torch.inference.likelihood import (
        make_eval_logll as t_make_eval_logll,
    )

    pc = esc.pc
    w = pt.std_workload()
    t, vals = pt.make_dataset(w)
    states = np.stack([[w.start[k] for k in w.names],
                       [w.true[k] * {"mu_n": 3.0, "mu_p": 0.6}.get(k, 1.0)
                        for k in w.names]])
    M = len(w.lengths)
    c = pt.LEGS["fast"]
    param_info = {
        "names": pc.NAMES, "unit_conversions": pc.UC,
        "do_log": {n: 1 for n in pc.NAMES},
        "active": {n: int(n in pc.ACTIVE) for n in pc.NAMES},
        "init_guess": {**pc.TRUE, **pc.START},
        "prior_dist": {n: pc.PRIOR.get(n, (1e-32, 1e32)) for n in pc.NAMES},
        "trial_move": {n: pc.WIDTH for n in pc.NAMES},
    }
    sim_info = {"lengths": pc.LENGTHS, "nx": [pc.NX] * M,
                "meas_types": ["TRPL"] * M, "num_meas": M}
    mcmc = {"ini_mode": "fluence", "model": "std", "log_y": 1,
            "model_uncertainty": pc.SIGMA, "hard_bounds": 1}
    iniPar = np.array([[f, a, 1] for f, a in pc.FLU])
    e_data = ([t] * M, vals, [np.full(pc.NT, pc.UNC)] * M)
    jplan = build_likelihood_plan(sim_info, param_info, mcmc, e_data, iniPar,
                                  hmax=c["hmax"], align_outputs=False,
                                  refactor_every=c["refactor"])
    f64 = torch.float64
    tplan = pt.build_plans(w, t, vals, c["hmax"], c["refactor"], c["refine"],
                           escalate=escalate)[0]
    got = t_make_eval_logll(tplan, dtype=f64, device="cpu")(
        torch.as_tensor(states, dtype=f64), torch.ones(1, dtype=f64))
    mode = "inline" if escalate else "off"
    want = jax.jit(make_eval_logll(jplan, dtype=jnp.float64,
                                   escalate=mode))(jnp.asarray(states),
                                                   jnp.ones(1))
    for key in ("per_meas", "resid", "esc_score"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-9, atol=1e-12,
                                   err_msg=f"{mode} {key}")


def test_escalate_free_float64_evaluation_equals_the_jax_xla_path(jax_esc):
    """The escalate-free evaluation (the plan without the ladder) against
    JAX's escalate="off" at nx=32 (the inline one:
    tests/test_torch_esc_validation_inline.py)."""
    compare_float64_evaluation(jax_esc, escalate=False)


def test_nx128_states_come_only_from_the_saved_flagship_leg(tmp_path):
    """The nx128 shape reads its states from the f32 leg that
    flagship_torch.py --save-chains writes and walks no leg of its own:
    --chains is required, and a directory without the leg fails before
    anything is solved."""
    with pytest.raises(SystemExit):
        ev.main(["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="flagship_f32.npz"):
        ev.shape_states("nx128", str(tmp_path), "cpu", print)
