"""PyTorch port on the reference-pinned likelihood fixtures of
tests/test_reference_parity.py:64-186 (reference
Tests/test_eval_trial_move.py): the port's float64 plain path holds four
of them to the reference's pinned constants at decimal=0 and the
force_min_y one to its monotonicity, and every per-measurement value
equals the JAX XLA path's within rel 1e-9.

The fixtures' material is spatially uniform (uniform profiles, no surface
recombination, zero or tiny mobility), so nx=32 gives the pinned values
of nx=128. Each fixture runs 1001 output knots through the chord-free
solver, which costs the plain path ~20 s an evaluation on a CPU; since
rows are independent, the four fixtures without force_min_y share one
plan whose measurements are the union of theirs (the time-cutoff curves
beside the full-range ones) and whose 3 states are theirs, and the
force_min_y fixture's two states share one evaluation: two port and two
JAX evaluations in all.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (the suite's torch thread count)
from test_reference_parity import BASE_GUESS, PARAM_NAMES, UNIT_CONVERSIONS

from metrotrpl_tpu.inference import likelihood as jl
from metrotrpl_tpu_torch.inference import likelihood as tl

NX = 32
FULL = np.linspace(0, 100, 1001)
HALF = np.linspace(0, 50, 501)
MCMC = {"solver": ("solveivp",), "model": "std", "ini_mode": "density",
        "hmax": 4, "log_y": 1}


def _pi(names, guess):
    return {"names": list(names), "unit_conversions": dict(UNIT_CONVERSIONS),
            "active": {n: 0 for n in names}, "init_guess": dict(guess),
            "trial_move": {n: 0 for n in names}}


def _both(sim_info, names, mcmc, e_data, ini, states):
    """per_meas (K, M) at T=1 of the port's float64 plain path and of the
    JAX XLA path on the same fixture, both without the escalation ladder:
    no fixture row needs it (tests/test_reference_parity.py runs them with
    it), and the union's TRTS row at zero mobility has no signal, so it is
    conceded as -inf in both instead of being solved again."""
    pi = _pi(names, BASE_GUESS)
    tplan = tl.build_likelihood_plan(sim_info, pi, mcmc, e_data, ini,
                                     escalate=False)
    jplan = jl.build_likelihood_plan(sim_info, pi, mcmc, e_data, ini,
                                     escalate=False)
    st = np.array([[s[n] for n in names] for s in states])
    # JAX traces and compiles in a thread while the port evaluates
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(lambda: np.asarray(jl.make_eval_logll(jplan)(
            jnp.asarray(st), jnp.ones(1))["per_meas"])[..., 0])
        with torch.inference_mode():
            out_t = tl.make_eval_logll(tplan, device="cpu")(
                torch.as_tensor(st), torch.ones(1, dtype=torch.float64))
        return out_t["per_meas"][..., 0].numpy(), fut.result()


def _union():
    """The fixtures two_trpl, time_cutoff, scale_factors and
    mixed_trpl_trts as one plan: measurements TRPL 1e15, TRPL 1e16, TRTS
    1e15 over [0, 100] and TRPL 1e15, TRPL 1e16 over [0, 50] (2000 nm,
    data 23 / -2 decades, u = 1e-99); states BASE_GUESS (the first two
    fixtures), the scale-factor guess and the mixed guess (mu 0.01)."""
    sim_info = {"lengths": [2000] * 5, "nx": [NX] * 5,
                "meas_types": ["TRPL", "TRPL", "TRTS", "TRPL", "TRPL"],
                "num_meas": 5}
    ini = np.array([p * np.ones(NX) for p in (1e15, 1e16, 1e15, 1e15,
                                              1e16)])
    times = [FULL, FULL, FULL, HALF, HALF]
    vals = [np.full(len(t), v) for t, v in zip(times, (23, 23, -2, 23, 23))]
    uncs = [np.full(len(t), 1e-99) for t in times]
    mcmc = dict(MCMC, model_uncertainty={"TRPL": 1, "TRTS": 10},
                scale_factor=[0.02, [0, 1], None, [1, 1]])
    names = PARAM_NAMES + ["_s0", "_s1"]
    base = dict(BASE_GUESS, _s0=1.0, _s1=1.0)
    scaled = dict(base, ks=1e-20, _s0=2e-17 ** -1, _s1=2e-15 ** -1)
    mixed = dict(base, mu_n=0.01, mu_p=0.01)
    return _both(sim_info, names, mcmc, (times, vals, uncs), ini,
                 [base, scaled, mixed])


def _force_min_y():
    """test_depletion_monotonicity_with_force_min_y: one TRPL curve of a
    depleting decay, force_min_y on, lifetimes 4 and 4.01 ns."""
    sim_info = {"lengths": [2000], "nx": [NX], "meas_types": ["TRPL"],
                "num_meas": 1}
    vals = [np.log10(2e14 * np.exp(-FULL / 8))]
    mcmc = dict(MCMC, force_min_y=1, model_uncertainty={"TRPL": 1})
    guess = dict(BASE_GUESS, n0=1e8, p0=1e17, ks=1e-13, tauN=4, tauP=4)
    return _both(sim_info, PARAM_NAMES, mcmc,
                 ([FULL], vals, [np.full(len(FULL), 1e-99)]),
                 np.array([1e15 * np.ones(NX)]),
                 [guess, dict(guess, tauN=4.01, tauP=4.01)])


@functools.cache
def _results():
    """Both evaluations: {"union": ..., "force_min_y": ...}, each (port
    per_meas, JAX per_meas)."""
    return {"union": _union(), "force_min_y": _force_min_y()}


#: fixture -> (evaluation, state (None: all), measurements, pinned
#: per-measurement values or None, pinned sum or None)
FIXTURES = {
    "two_trpl": ("union", 0, [0, 1], [-59340.105083, -32560.139058],
                 -59340.105083 - 32560.139058),
    "time_cutoff": ("union", 0, [3, 4], None, -45982),
    "scale_factors": ("union", 1, [0, 1], None, 0),
    "mixed_trpl_trts": ("union", 2, [0, 2], [-59340.105083, -517.98],
                        -59340.105083 - 517.98),
    "force_min_y": ("force_min_y", None, [0], None, None),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_pinned_fixture(name):
    """The fixture's per-measurement values from the port equal JAX's
    within rel 1e-9 and the reference's pinned constants at decimal=0
    (force_min_y: both states finite, the move toward the data's decay
    improves the likelihood)."""
    run, k, meas, pinned, total = FIXTURES[name]
    pm_t, pm_j = _results()[run]
    rows = slice(None) if k is None else k
    a, b = pm_t[rows][..., meas], pm_j[rows][..., meas]
    assert np.isfinite(a).all()
    # atol: scale_factors' perfect fit leaves a rounding residue ~1e-22
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    if pinned is not None:
        np.testing.assert_almost_equal(a, pinned, decimal=0)
    if total is not None:
        np.testing.assert_almost_equal(a.sum(), total, decimal=0)
    if name == "force_min_y":
        assert a[1, 0] > a[0, 0]
