"""PyTorch port parity of the shallow-trap model (C=4): its RHS and
symbolic Jacobian against the JAX package and torch autograd, the 2x2 and
4x4 block inverses, PCR with 4x4 blocks, the null-trap limit against the
std model, and the plain solve against the float64 LSODA oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    params_both,
    plane_rel,
    rel_err,
    staub_raw,
    traps_raw,
)

from metrotrpl_tpu.ops import blocktridiag as jbt
from metrotrpl_tpu.oracle import solve_reference
from metrotrpl_tpu.oracle.scipy_reference import beer_lambert as bl_np
from metrotrpl_tpu.physics import models as jm
from metrotrpl_tpu_torch.ops import blocktridiag as tbt
from metrotrpl_tpu_torch.physics import models as tm
from metrotrpl_tpu_torch.solver import forward as tf

T64 = torch.float64


def _random_traps_state(B, nx, seed):
    """O(1) scaled traps states (dN, Ntrap, dD, E) with a trapped density
    around the trap density, and per-row scaled parameters around the
    traps truth (+-0.3 dex)."""
    rng = np.random.default_rng(seed)
    raw = {k: v * 10.0 ** rng.uniform(-0.3, 0.3, B)
           for k, v in traps_raw().items()}
    dx = np.full(B, 311.0 / nx)
    ns = rng.uniform(0.5, 2.0, B) * 1e-6
    y = (rng.uniform(0.05, 1.0, (B, nx)),
         rng.uniform(0.0, 2.0, (B, nx)) * (raw["Nt"] / ns)[:, None],
         rng.uniform(-1e-3, 1e-3, (B, nx)),
         rng.uniform(-1e-2, 1e-2, (B, nx)))
    return y, raw, dx, ns


def test_traps_rhs_and_jacobian_planes_match_jax():
    """RHS and (L, D, U) planes of the traps model at float64, nx=16:
    each plane within 1e-12 of its max magnitude (same algebra, op for op;
    the JAX functions run under jit)."""
    y, raw, dx, ns = _random_traps_state(4, 16, seed=1)
    pj, pt = params_both(raw, dx, ns)
    for fj, ft in zip(pj, pt):
        assert rel_err(ft.numpy(), np.asarray(fj)) < 1e-14
    yj = tuple(jnp.asarray(a) for a in y)
    yt = tuple(torch.as_tensor(a, dtype=T64) for a in y)
    rj = jax.jit(jm.rhs_traps_planes)(yj, pj)
    rt = tm.rhs_traps_planes(yt, pt)
    assert len(rt) == len(rj) == 4
    for a, b in zip(rt, rj):
        assert plane_rel(a.numpy(), b) < 1e-12
    Jj = jax.jit(jm.jac_traps_planes)(yj, pj)
    Jt = tm.jac_traps_planes(yt, pt)
    for Mj, Mt in zip(Jj, Jt):
        assert len(Mt) == 4
        for rowj, rowt in zip(Mj, Mt):
            for a, b in zip(rowt, rowj):
                assert plane_rel(a.numpy(), np.asarray(b)) < 1e-12


def test_traps_jacobian_matches_autograd():
    """The symbolic traps Jacobian equals torch autograd's dense Jacobian
    of the traps RHS (float64; relative to the largest entry)."""
    nx = 8
    y, raw, dx, ns = _random_traps_state(1, nx, seed=2)
    _, pt = params_both(raw, dx, ns)
    y0 = torch.as_tensor(np.concatenate(y, axis=-1)[0], dtype=T64)

    def planes(flat):
        return tuple(flat[c * nx:(c + 1) * nx][None] for c in range(4))

    def f(flat):
        return torch.cat([r[0] for r in tm.rhs_traps_planes(planes(flat),
                                                            pt)])

    dense = torch.autograd.functional.jacobian(f, y0).numpy()
    L, D, U = tm.jac_traps_planes(planes(y0), pt)
    sym = np.zeros_like(dense)
    for a in range(4):
        for b in range(4):
            for i in range(nx):
                sym[a * nx + i, b * nx + i] = D[a][b][0, i]
                if i > 0:
                    sym[a * nx + i, b * nx + i - 1] = L[a][b][0, i]
                if i < nx - 1:
                    sym[a * nx + i, b * nx + i + 1] = U[a][b][0, i]
    assert np.max(np.abs(sym - dense)) <= 1e-11 * np.max(np.abs(dense))


def test_null_traps_equal_std():
    """With no traps (kC = 0, Nt = 0) the traps model is the std model:
    the RHS planes equal the std planes exactly (the trapped density stays
    0), and the plain float64 solve gives the std observables to rounding
    (rel 1e-12)."""
    y, raw, dx, ns = _random_traps_state(3, 16, seed=3)
    raw = {**raw, "kC": np.zeros(3), "Nt": np.zeros(3)}
    _, pt = params_both(raw, dx, ns)
    dN, _, dD, E = (torch.as_tensor(a, dtype=T64) for a in y)
    zero = torch.zeros_like(dN)
    rt = tm.rhs_traps_planes((dN, zero, dD, E), pt)
    rs = tm.rhs_std_planes((dN, dD, E), pt)
    for a, b in zip((rt[0], rt[2], rt[3]), rs):
        assert torch.equal(a, b)
    assert torch.equal(rt[1], zero)

    plan = tf.make_forward_plan([311.0, 2000.0], [16, 16], ["TRPL", "TRTS"],
                                [np.linspace(0, 200, 21)] * 2)
    x = torch.as_tensor(plan.x_centers)
    init = tm.beer_lambert(torch.full((2, 1), 2.12e-3, dtype=T64),
                           torch.full((2, 1), 6e-3, dtype=T64), x)
    args = (torch.as_tensor(plan.dx), torch.as_tensor(plan.dt),
            torch.as_tensor(plan.out_idx), torch.as_tensor(plan.is_trpl))
    std = {k: torch.full((2,), v, dtype=T64) for k, v in staub_raw().items()}
    null = {**std, "kC": torch.zeros(2, dtype=T64),
            "Nt": torch.zeros(2, dtype=T64),
            "tauE": torch.full((2,), 300.0, dtype=T64)}
    s_std = tf.solve_forward_batch(init, std, *args).numpy()
    s_null = tf.solve_forward_batch(init, null, *args, model="traps").numpy()
    assert rel_err(s_null, s_std) < 1e-12


def _random_blocks(C, B, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.3, (B, C, C, n)) + 2.0 * np.eye(C)[None, :, :,
                                                             None]


@pytest.mark.parametrize("C", [2, 4])
def test_p_inv_small_matches_jax_and_linalg(C):
    """Closed-form 2x2 and 4x4 (Schur) plane inverses against the JAX
    twin (under jit, same operand order) within 1e-14 and against
    torch.linalg.inv within 1e-12 of the largest entry, float64."""
    A = _random_blocks(C, 3, 5, seed=C)
    At = tuple(tuple(torch.as_tensor(A[:, i, j]) for j in range(C))
               for i in range(C))
    mine = np.stack([np.stack([a.numpy() for a in row], axis=1)
                     for row in tbt.p_inv_small(At)], axis=1)
    Aj = tuple(tuple(jnp.asarray(A[:, i, j]) for j in range(C))
               for i in range(C))
    ref = jax.jit(jbt.p_inv_small)(Aj)
    ref = np.stack([np.stack([np.asarray(a) for a in row], axis=1)
                    for row in ref], axis=1)
    assert plane_rel(mine, ref) < 1e-14
    dense = torch.linalg.inv(torch.as_tensor(A).permute(0, 3, 1, 2))
    assert plane_rel(mine, dense.permute(0, 2, 3, 1).numpy()) < 1e-12


@pytest.mark.parametrize("n", [1, 13, 32])
def test_pcr_4x4_matches_thomas(n):
    """PCR with 4x4 blocks (the traps model's) against the sequential
    block-Thomas oracle, float64, rel 1e-10."""
    rng = np.random.default_rng(n)
    C = 4
    L = rng.normal(0, 0.2, (2, C, C, n))
    U = rng.normal(0, 0.2, (2, C, C, n))
    D = _random_blocks(C, 2, n, seed=n + 1)
    L[..., 0] = 0.0
    U[..., -1] = 0.0
    b = rng.normal(0, 1, (2, C, n))

    def planes(M):
        return tuple(tuple(torch.as_tensor(M[:, i, j]) for j in range(C))
                     for i in range(C))

    bt = tuple(torch.as_tensor(b[:, c]) for c in range(C))
    xp = tbt.pcr_solve(planes(L), planes(D), planes(U), bt)
    xt = tbt.thomas_solve(planes(L), planes(D), planes(U), bt)
    assert rel_err(np.stack([a.numpy() for a in xp]),
                   np.stack([a.numpy() for a in xt])) < 1e-10


def test_solve_single_traps_matches_lsoda():
    """solve_single (plain float64 solve) of the traps model against the
    float64 LSODA oracle, the case of the JAX package's
    test_matches_lsoda_traps_model (nx=48, 101 points to 500 ns): log10
    PL within 1e-4."""
    thickness, nx = 311.0, 48
    params = traps_raw()
    dx = thickness / nx
    x = np.linspace(dx / 2, thickness - dx / 2, nx)
    ic = bl_np(2.12e11 * 1e-14, 6e4 * 1e-7, x)
    t_out = np.linspace(0, 500, 101)
    ref = solve_reference(ic, thickness, nx, t_out, params, model="traps")
    mine = tf.solve_single(ic, params, thickness, nx, t_out, model="traps",
                           device="cpu")
    assert np.max(np.abs(np.log10(mine) - np.log10(ref))) < 1e-4
