"""PyTorch port parity of the traps-model (C=4) batched forward solve:
the plain PyTorch solve (what the solve kernel's wrapper runs for CPU
tensors) against the JAX XLA path at float64."""

import numpy as np
from torch_parity import rel_err, solve_traps_both, traps_raw

from metrotrpl_tpu_torch.solver import forward as tf


def test_traps_solve_matches_xla_f64():
    """Plain PyTorch traps solve vs the JAX XLA path at float64 on B=4
    TRPL/TRTS rows (+-0.2 dex around the traps truth, fluences +-0.5
    dex), fast chord plan (hmax 16, chord blocks of 4, one plateau Newton
    iteration) with the residual stream: observables rel 1e-9, residuals
    on the scale of the Newton update."""
    B = 4
    plan = tf.make_forward_plan(
        [311.0, 2000.0] * 2, [16] * B, ["TRPL", "TRTS"] * 2,
        [np.linspace(0, 200, 21)] * B, hmax=16.0, align_outputs=False,
        refactor_every=4, ramp_block=2, newton_plateau=1)
    rng = np.random.default_rng(6)
    raw = {k: (v * 10.0 ** rng.uniform(-0.2, 0.2, B)
               if k not in ("n0", "eps", "Tm") else np.full(B, v))
           for k, v in traps_raw().items()}
    fl = np.full((B, 1), 2.12e-3) * 10.0 ** rng.uniform(-0.5, 0.5, (B, 1))
    al = np.full((B, 1), 6e-3)
    (st, rt), (sj, rj) = solve_traps_both(
        plan, raw, fl, al, np.float64, "xla",
        refactor_every=plan.refactor_every, n_ramp=plan.n_ramp,
        ramp_block=plan.ramp_block, newton_plateau=plan.newton_plateau,
        with_diag=True)
    assert plan.n_ramp is not None
    assert np.isfinite(sj).all() and np.isfinite(st).all()
    assert rel_err(st, sj) < 1e-9
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-12)
