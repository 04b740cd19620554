"""scripts/posterior_torch.py: its datasets and constants against the JAX
scripts that made the committed artifacts (scripts/posterior_compare.py
under the full preset, scripts/traps_posterior.py), its copies of their
statistics and the committed gold columns it reads (a short leg on the
CPU: tests/test_torch_posterior_leg.py)."""

import importlib
import os
import sys

import numpy as np
import pytest
from torch_parity import REPO

SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import posterior_torch as pt  # noqa: E402


@pytest.fixture(scope="module")
def jax_scripts():
    """posterior_compare under apply_preset("full"), and traps_posterior
    (imported without its persistent compile cache)."""
    old = os.environ.get("METROTRPL_NO_COMPILE_CACHE")
    os.environ["METROTRPL_NO_COMPILE_CACHE"] = "1"
    try:
        pc = importlib.import_module("posterior_compare")
        tp = importlib.import_module("traps_posterior")
    finally:
        if old is None:
            del os.environ["METROTRPL_NO_COMPILE_CACHE"]
        else:
            os.environ["METROTRPL_NO_COMPILE_CACHE"] = old
    pc.apply_preset("full")
    return pc, tp


def test_workload_constants_equal_the_jax_scripts(jax_scripts):
    """Geometry, truth, active set, seeded starts, priors, widths and
    seeds of both workloads are the JAX scripts' values."""
    pc, tp = jax_scripts
    w = pt.std_workload()
    assert (w.nx, w.nt, w.t_end, w.width, w.sigma, w.unc, w.seed) == (
        pc.NX, pc.NT, pc.T_END, pc.WIDTH, pc.SIGMA, pc.UNC, pc.SEED)
    assert w.lengths == pc.LENGTHS and w.flu == pc.FLU
    assert w.names == list(pc.NAMES) and w.true == pc.TRUE
    assert w.active == pc.ACTIVE and len(w.active) == 10
    assert w.start == {**pc.TRUE, **pc.START}
    assert w.prior == {n: pc.PRIOR.get(n, (1e-32, 1e32)) for n in pc.NAMES}
    T = tp.T
    w = pt.traps_workload()
    assert (w.nx, w.nt, w.t_end, w.sigma, w.unc, w.seed, w.width) == (
        T.NX, T.NT, T.T_END, T.SIGMA, T.UNC, T.SEED, tp.WIDTH)
    assert w.lengths == T.LENGTHS and w.flu == T.FLU
    assert w.names == T.NAMES and w.true == T.TRUE
    assert w.active == T.ACTIVE and len(w.active) == 13
    assert w.start == T.TRUE and w.prior == tp.PRIOR


def test_datasets_equal_the_jax_scripts_bit_for_bit(jax_scripts):
    """The port's oracle copy makes the JAX scripts' noisy datasets, bit
    for bit: std (6 curves) and traps (2 curves)."""
    pc, tp = jax_scripts
    for w, (tj, vj) in ((pt.std_workload(), pc.make_dataset()),
                        (pt.traps_workload(), tp.make_dataset())):
        t, vals = pt.make_dataset(w)
        np.testing.assert_array_equal(t, tj)
        assert len(vals) == len(vj) == len(w.lengths)
        for a, b in zip(vals, vj):
            np.testing.assert_array_equal(a, b)


def test_ess_and_z_formulas_equal_the_jax_scripts(jax_scripts):
    """The copied ess_log10 gives posterior_compare's on seeded one- and
    many-chain AR(1) samples, and z / z_mc are run_gold_check's."""
    pc, _ = jax_scripts
    rng = np.random.default_rng(11)
    for shape, phi in (((600,), 0.9), ((400, 4), 0.7), ((300, 3), 0.0)):
        e = rng.standard_normal(shape)
        x = np.empty(shape)
        x[0] = e[0]
        for i in range(1, shape[0]):
            x[i] = phi * x[i - 1] + e[i]
        s = 10 ** (0.1 * x)
        assert pt.ess_log10(s) == pc.ess_log10(s)
    g = 10 ** (0.2 * rng.standard_normal((500, 4)) + 1.0)
    f = 10 ** (0.25 * rng.standard_normal((500, 4)) + 1.05)
    lg, lf = np.log10(g.ravel()), np.log10(f.ravel())
    mg, s_g, mf, s_f = lg.mean(), lg.std(), lf.mean(), lf.std()
    essg, essf = pc.ess_log10(g), pc.ess_log10(f)
    z = abs(mg - mf) / np.hypot(s_g, s_f)
    z_mc = abs(mg - mf) / np.sqrt(
        s_g ** 2 + s_f ** 2 + s_g ** 2 / essg + s_f ** 2 / essf)
    stats = pt.summarize({"a": g, "b": f}, 0)
    assert stats["a"] == (mg, s_g, essg) and stats["b"] == (mf, s_f, essf)
    assert pt.z_scores(*stats["a"], *stats["b"]) == pytest.approx(
        (z, z_mc), rel=1e-15)


def test_committed_gold_columns_are_read():
    """The gold column of each committed artifact, for every active
    parameter of its workload."""
    for w, p0 in ((pt.std_workload(), (15.4798, 0.0199, 2734.0)),
                  (pt.traps_workload(), (15.4271, 0.0445, 515.0))):
        gold = pt.read_committed_gold(os.path.join(REPO, w.artifact))
        assert set(gold) == set(w.active)
        assert gold["p0"] == p0


def test_ll_error_mode_on_the_cpu():
    """--ll-error's pieces: states around the committed gold column keep
    the inactive parameters at the start, and on a tiny traps workload
    (nx=8, 100 ns) each leg's float32 log-likelihood lies near float64."""
    w = pt.traps_workload()
    st = pt.gold_column_states(w, 3)
    assert st.shape == (3, len(w.names))
    for i, n in enumerate(w.names):
        if n not in w.active:
            assert (st[:, i] == w.start[n]).all()
    w = w._replace(nx=8, t_end=100.0, nt=11)
    t, vals = pt.make_dataset(w)
    err = pt.ll_error(w, t, vals, "cpu", n=2)
    assert set(err) == set(pt.LEGS)
    for e in err.values():
        assert e["finite"] and e["rows"] == 4 and e["max"] < 1e-2


def test_acceptance_check_walks_the_fast_leg_in_both_dtypes(monkeypatch):
    """--acceptance-check's walk: the fast leg in float32 and float64 on
    the tiny traps workload, each with an acceptance in [0, 1]."""
    monkeypatch.setattr(pt, "N_CHAINS", 2)
    w = pt.traps_workload()._replace(nx=8, t_end=100.0, nt=11)
    t, vals = pt.make_dataset(w)
    out = pt.acceptance_check(w, t, vals, "cpu", 3)
    assert set(out) == {"float32", "float64"}
    for acc, rep in out.values():
        assert 0.0 <= acc <= 1.0 and rep is None
