"""scripts/flagship_torch.py: its workload and dataset against
scripts/posterior_compare.py under apply_preset("flagship"), its
comparison table against scripts/assemble_r09.py's statistics, and a
short tempered leg with its report on the CPU."""

import builtins
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from torch_parity import REPO

SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

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
def flagship_pc(monkeypatch):
    """A private posterior_compare under apply_preset("flagship"), without
    the persistent compile cache."""
    monkeypatch.setenv("METROTRPL_NO_COMPILE_CACHE", "1")
    pc = _load_script("posterior_compare")
    pc.apply_preset("flagship")
    return pc


def test_workload_constants_starts_and_ic_equal_the_flagship_preset(
        flagship_pc):
    """Geometry, truth, active set, seeded starts, priors, widths, seed
    and every curve's initial profile are posterior_compare's after
    apply_preset("flagship"), exactly."""
    pc = flagship_pc
    w = ft.flagship_workload()
    assert (w.nx, w.nt, w.t_end, w.width, w.sigma, w.unc, w.seed) == (
        pc.NX, pc.NT, pc.T_END, pc.WIDTH, pc.SIGMA, pc.UNC, pc.SEED) == (
        128, 501, 2000.0, 0.01, 0.05, 0.05, 20260816)
    assert w.lengths == pc.LENGTHS and w.flu == pc.FLU
    assert w.names == list(pc.NAMES) and w.true == pc.TRUE
    assert w.active == pc.ACTIVE and len(w.active) == 10
    assert w.start == {**pc.TRUE, **pc.START}
    assert w.prior == {n: pc.PRIOR.get(n, (1e-32, 1e32)) for n in pc.NAMES}
    for m in range(len(w.lengths)):
        np.testing.assert_array_equal(pt._ic(w, m), pc._ic(m))


def test_dataset_equals_the_jax_script_and_its_digest(flagship_pc):
    """At a cut size (nx=32, nt=101) the port's oracle makes the JAX
    script's noisy flagship data (rel 1e-12); at full size the JAX
    script's data hashes to the digest the card run asserts."""
    pc = flagship_pc
    t, vals = pc.make_dataset()
    assert ft.dataset_sha256(t, vals) == ft.DATASET_SHA256
    pc.NX, pc.NT = 32, 101
    tj, vj = pc.make_dataset()
    t, vals = pt.make_dataset(ft.flagship_workload()._replace(nx=32, nt=101))
    np.testing.assert_array_equal(t, tj)
    assert len(vals) == len(vj) == 6
    for a, b in zip(vals, vj):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def _synthetic_chains(seed=3):
    """Seeded log-normal draws: an oracle chain (300 iterations, 240 of
    them done) and a leg of 4 cold chains x 150 iterations, both reaching
    mu_n > 50."""
    rng = np.random.default_rng(seed)
    w = ft.flagship_workload()

    def draw(shape, sd):
        return {k: w.true[k] * 10 ** (sd * np.cumsum(
            rng.standard_normal(shape), axis=0) / np.sqrt(shape[0])
            + (0.3 if k == "mu_n" else 0.0)) for k in w.active}

    return w, draw((300,), 0.4), draw((150, 4), 0.3)


def test_comparison_table_equals_assemble_r09(tmp_path, monkeypatch):
    """On the same seeded chains, assemble_r09.py (run unedited, its
    report written to tmp_path) and the port's report give the same table
    rows, ridge numbers and largest |z| and |z_mc|; the sample arrays
    each ESS is taken of, and the ESS values, are the same bit for bit."""
    w, oracle, leg = _synthetic_chains()
    np.savez(tmp_path / "oracle.npz", acc=0.43, n_done=240, **oracle)
    np.savez(tmp_path / "leg.npz", acc=0.25, **leg)

    monkeypatch.setenv("METROTRPL_NO_COMPILE_CACHE", "1")
    pc = _load_script("posterior_compare")
    monkeypatch.setitem(sys.modules, "posterior_compare", pc)
    seen = {"jax": [], "port": []}

    def recorder(key, fn):
        def ess(x):
            e = fn(x)
            seen[key].append((np.array(x), e))
            return e
        return ess

    monkeypatch.setattr(pc, "ess_log10", recorder("jax", pc.ess_log10))
    monkeypatch.setattr(pt, "ess_log10", recorder("port", pt.ess_log10))
    asm = _load_script("assemble_r09", "assemble_r09_under_test")
    out = tmp_path / "r09.md"
    monkeypatch.setattr(asm, "open", lambda p, m="r": builtins.open(out, m),
                        raising=False)
    monkeypatch.setattr(sys, "argv", ["assemble_r09.py",
                                      str(tmp_path / "oracle.npz"),
                                      str(tmp_path / "leg.npz")])
    asm.main()
    jax_lines = out.read_text().splitlines()

    smp, _, n = ft.read_chain(tmp_path / "leg.npz", w.active)
    summary = {"card": "the CPU", "dataset_sha256": ft.DATASET_SHA256,
               "n_iters": n, "n_ensembles": 4, "n_temps": 4,
               "draw_seed": w.seed, "acceptance": 0.25,
               "walker_steps_per_s": 1.0, "ms_per_iteration": 1.0,
               "seconds": 1.0, "launches_per_iteration": {},
               "repaired_rows_per_iteration": None, "rows_per_iteration": 96}
    lines = ft.report(w, {"f32": (smp, summary)},
                      oracle_path=str(tmp_path / "oracle.npz"))

    def table(ls):
        return [ln for ln in ls if ln.startswith("| ") and "10^(" in ln]

    assert len(table(lines)) == 13
    assert table(lines) == table(jax_lines)
    def calls(key):     # each ESS call's input bytes, shape and value
        return sorted((a.tobytes(), a.shape, e) for a, e in seen[key])

    assert len(seen["port"]) == len(seen["jax"]) == 26
    assert calls("port") == calls("jax")
    oracle_post, _, n_o = ft.read_chain(tmp_path / "oracle.npz", w.active)
    assert n_o == 240
    mx_o, hi_o = ft.ridge_lines(oracle_post)
    mx_t, hi_t = ft.ridge_lines(smp)
    assert hi_o > 0 and hi_t > 0
    text = "\n".join(jax_lines)
    assert (f"post-burn max mu_n {mx_t:.1f} (oracle {mx_o:.1f})" in text
            and f"tpu {hi_t:.2f}, oracle {hi_o:.2f}" in text)
    rows = ft.comparison_rows(w, oracle_post, {"f32": smp})
    z = max(r["f32"][3] for r in rows)
    z_mc = max(r["f32"][4] for r in rows)
    assert f"Largest |z|: **{z:.2f}**; largest MC-error-aware |z_mc|: " \
           f"**{z_mc:.2f}**" in text


def test_short_tempered_leg_and_report_on_the_cpu(tmp_path, monkeypatch):
    """A flagship leg cut to nx=8 and 100 ns, 2 ensembles x 4 temperatures
    x 4 iterations, walks on the CPU: only the cold chains enter the
    samples, every state stays finite and in the priors, a saved leg reads
    back equal, --assemble writes the report from it, and the card is the
    default device."""
    monkeypatch.setattr(ft, "N_ENSEMBLES", 2)
    w = ft.flagship_workload()._replace(nx=8, nt=11, t_end=100.0)
    t, vals = pt.make_dataset(w)
    r = ft.walk_leg(w, t, vals, "f32", 4, "cpu", log=lambda line: None)
    assert r["samples"]["mu_n"].shape == (4, 2)
    assert r["accept"].shape == (4, 2) and r["rows_per_iteration"] == 48
    assert r["states"].shape == (8, len(w.names)) and r["ll"].shape == (8,)
    assert np.isfinite(r["states"]).all() and np.isfinite(r["ll"]).all()
    cold = r["states"].reshape(2, 4, -1)[:, 0]
    np.testing.assert_array_equal(cold[:, w.names.index("mu_n")],
                                  r["samples"]["mu_n"][-1])
    lo = np.array([w.prior[n][0] for n in w.names])
    hi = np.array([w.prior[n][1] for n in w.names])
    assert np.all((r["states"] > lo) & (r["states"] < hi))
    summary = ft.leg_summary(r, "the CPU", "digest")
    ft.save_leg(tmp_path / "flagship_f32.npz", r["samples"], summary)
    smp, back = ft.load_leg(tmp_path / "flagship_f32.npz", w.active)
    assert back == summary
    for k in w.active:
        np.testing.assert_array_equal(smp[k], r["samples"][k])
    out = tmp_path / "report.md"
    ft.main(["--assemble", str(tmp_path), "--legs", "f32", "--out",
             str(out)])
    text = out.read_text()
    assert "port f32 mean +/- sigma (ESS)" in text and "Ridge" in text
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ft.main(["--out", str(tmp_path / "x.md")])
    assert not (tmp_path / "x.md").exists()
