"""PyTorch port parity with the JAX package's fused solve kernel on the
traps model (C=4): the float32 plain PyTorch solve against the Pallas
kernel in interpret mode."""

import numpy as np
from torch_parity import solve_traps_both, traps_raw

from metrotrpl_tpu_torch.solver import forward as tf


def test_traps_f32_solve_matches_jax_pallas_kernel():
    """Float32 plain PyTorch traps solve on B=8 mixed TRPL/TRTS rows (9
    points to 50 ns) against the JAX package's Pallas solve kernel in
    interpret mode with one Newton iteration per stage, as
    tests/test_torch_pallas.py holds the std model, at nx=8 (interpret
    mode compiles the C=4 kernel for about a minute at nx=16): rtol 2e-5,
    reassociated float32 reductions."""
    B, nx, newton_iters = 8, 8, 1
    plan = tf.make_forward_plan([311.0, 2000.0] * 4, [nx] * B,
                                ["TRPL", "TRTS"] * 4,
                                [np.linspace(0, 50, 9)] * B,
                                newton_iters=newton_iters)
    raw = {k: np.full(B, v, np.float32) for k, v in traps_raw().items()}
    fl = np.full((B, 1), 2.12e-3, np.float32)
    al = np.full((B, 1), 6e-3, np.float32)
    st, sj = solve_traps_both(plan, raw, fl, al, np.float32,
                              "pallas_interpret", block_b=8,
                              newton_iters=newton_iters)
    np.testing.assert_allclose(st, sj, rtol=2e-5)
