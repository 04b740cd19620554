"""PyTorch port parity: grid planning, the std model's RHS and symbolic
Jacobian, the PCR block-tridiagonal solver, interpolation and the IRF
convolution, each against its metrotrpl_tpu counterpart on the same
numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import params_both, plane_rel, rel_err, staub_raw

import metrotrpl_tpu.physics.grid as jgrid
import metrotrpl_tpu_torch.physics.grid as tgrid
from metrotrpl_tpu.ops import blocktridiag as jbt
from metrotrpl_tpu.physics import models as jm
from metrotrpl_tpu_torch.ops import blocktridiag as tbt
from metrotrpl_tpu_torch.physics import models as tm

T64 = torch.float64


@pytest.mark.parametrize("kw", [
    dict(),
    dict(hmax=16.0, align_outputs=False),
    dict(hmax=48.0, align_outputs=False, ramp_block=4),
    dict(hmax=8.0, align_outputs=False, tail_growth=1.2, tail_block=3,
         refine=2),
])
def test_grid_equals_reference(kw):
    """The numpy copy of physics/grid.py gives exactly the JAX package's
    grids (outputs compared bit for bit)."""
    t_out = np.linspace(0, 2000, 501)
    ref = jgrid.plan_time_grid(t_out, **kw)
    mine = tgrid.plan_time_grid(t_out, **kw)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))
    n_steps, nt = len(ref.dt) + 7, len(ref.out_idx) + 3
    pr = jgrid.pad_time_grid(ref, n_steps, nt)
    pm = tgrid.pad_time_grid(mine, n_steps, nt)
    for f in pr._fields:
        np.testing.assert_array_equal(getattr(pm, f), getattr(pr, f))
    for th, nx in ((311.0, 128), (2000.0, 16)):
        assert tuple(tgrid.make_space_grid(th, nx)[:3]) == \
            tuple(jgrid.make_space_grid(th, nx)[:3])
        np.testing.assert_array_equal(tgrid.make_space_grid(th, nx)[3],
                                      jgrid.make_space_grid(th, nx)[3])


def _random_state(B, nx, seed):
    """O(1) scaled states with a small charge separation and field, plus
    per-row scaled parameters around the staub truth."""
    rng = np.random.default_rng(seed)
    dN = rng.uniform(0.05, 1.0, (B, nx))
    dD = rng.uniform(-1e-3, 1e-3, (B, nx))
    E = rng.uniform(-1e-2, 1e-2, (B, nx))
    raw = {k: v * 10.0 ** rng.uniform(-0.3, 0.3, B)
           for k, v in staub_raw().items()}
    dx = np.full(B, 311.0 / nx)
    ns = rng.uniform(0.5, 2.0, B) * 1e-6
    return (dN, dD, E), raw, dx, ns


def test_rhs_and_jacobian_planes_match_jax():
    """RHS and (L, D, U) Jacobian planes at float64: each plane within
    1e-12 of its max magnitude (same algebra, op for op; only libm and
    fused-op rounding differ)."""
    y, raw, dx, ns = _random_state(4, 16, seed=1)
    pj, pt = params_both(raw, dx, ns)
    for fj, ft in zip(pj, pt):
        assert rel_err(ft.numpy(), np.asarray(fj)) < 1e-14
    yj = tuple(jnp.asarray(a) for a in y)
    yt = tuple(torch.as_tensor(a, dtype=T64) for a in y)
    rj = jax.jit(jm.rhs_std_planes)(yj, pj)
    rt = tm.rhs_std_planes(yt, pt)
    for a, b in zip(rt, rj):
        assert plane_rel(a.numpy(), b) < 1e-12
    Jj = jax.jit(jm.jac_std_planes)(yj, pj)
    Jt = tm.jac_std_planes(yt, pt)
    for Mj, Mt in zip(Jj, Jt):
        for rowj, rowt in zip(Mj, Mt):
            for a, b in zip(rowt, rowj):
                assert plane_rel(a.numpy(), np.asarray(b)) < 1e-12


def test_jacobian_matches_autograd():
    """The symbolic block-tridiagonal Jacobian equals torch autograd's
    dense Jacobian of the RHS (float64; relative to the largest entry)."""
    nx = 8
    y, raw, dx, ns = _random_state(1, nx, seed=2)
    _, pt = params_both(raw, dx, ns)
    y0 = torch.as_tensor(np.concatenate(y, axis=-1)[0], dtype=T64)

    def f(flat):
        planes = tuple(flat[c * nx:(c + 1) * nx][None] for c in range(3))
        return torch.cat([r[0] for r in tm.rhs_std_planes(planes, pt)])

    dense = torch.autograd.functional.jacobian(f, y0).numpy()
    L, D, U = tm.jac_std_planes(tuple(y0[c * nx:(c + 1) * nx][None]
                                      for c in range(3)), pt)
    sym = np.zeros_like(dense)
    for a in range(3):
        for b in range(3):
            for i in range(nx):
                sym[a * nx + i, b * nx + i] = D[a][b][0, i]
                if i > 0:
                    sym[a * nx + i, b * nx + i - 1] = L[a][b][0, i]
                if i < nx - 1:
                    sym[a * nx + i, b * nx + i + 1] = U[a][b][0, i]
    assert np.max(np.abs(sym - dense)) <= 1e-11 * np.max(np.abs(dense))


def _random_system(B, n, seed):
    """A diagonally dominant block-tridiagonal system like I - h*gamma*J."""
    rng = np.random.default_rng(seed)
    C = 3
    L = rng.normal(0, 0.2, (B, C, C, n))
    U = rng.normal(0, 0.2, (B, C, C, n))
    D = rng.normal(0, 0.2, (B, C, C, n)) + 2.0 * np.eye(C)[None, :, :, None]
    L[..., 0] = 0.0
    U[..., -1] = 0.0
    b = rng.normal(0, 1, (B, C, n))
    return L, D, U, b


def _planes_m(A):
    return tuple(tuple(torch.as_tensor(A[:, i, j], dtype=T64)
                       for j in range(A.shape[2])) for i in range(A.shape[1]))


@pytest.mark.parametrize("n", [1, 13, 32])
def test_pcr_matches_jax_and_thomas(n):
    """Port PCR vs JAX pcr_solve (stacked layout, jit) and vs the port's
    sequential Thomas oracle, float64, rel 1e-10."""
    L, D, U, b = _random_system(3, n, seed=n)
    xj = np.asarray(jax.jit(jbt.pcr_solve)(
        jnp.asarray(L), jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)))
    bt = tuple(torch.as_tensor(b[:, c], dtype=T64) for c in range(3))
    xp = tbt.pcr_solve(_planes_m(L), _planes_m(D), _planes_m(U), bt)
    xt = tbt.thomas_solve(_planes_m(L), _planes_m(D), _planes_m(U), bt)
    xp = np.stack([a.numpy() for a in xp], axis=1)
    xt = np.stack([a.numpy() for a in xt], axis=1)
    assert rel_err(xp, xj) < 1e-10
    assert rel_err(xp, xt) < 1e-10


def test_solver_constants_match_reference():
    """Scheme tables and ladder constants are the JAX package's values
    (config/validate.py reads NEWTON_DAMP from the JAX stepper)."""
    from metrotrpl_tpu.inference import likelihood as jl
    from metrotrpl_tpu.solver import sdirk as js
    from metrotrpl_tpu_torch.inference import likelihood as tl
    from metrotrpl_tpu_torch.solver import sdirk as ts

    assert ts.NEWTON_DAMP == js.NEWTON_DAMP
    assert ts.SDIRK_SCHEMES.keys() == js.SDIRK_SCHEMES.keys()
    for name, sc in js.SDIRK_SCHEMES.items():
        mine = ts.SDIRK_SCHEMES[name]
        np.testing.assert_array_equal(mine.A, sc.A)
        assert (mine.gamma, mine.order) == (sc.gamma, sc.order)
    for c in ("NEWTON_DIV_TOL", "ESCALATE_MU_MODEL", "ESCALATE_GATE_SCORE"):
        assert getattr(tl, c) == getattr(jl, c)
    for nx in (16, 64, 80, 96, 128):
        assert tl.newton_div_tol_default(nx) == jl.newton_div_tol_default(nx)


def test_interp_and_irf_convolution_match_jax():
    """interp1d (batched rows, NaN outside the range), the IRF moment
    tables and the moment convolution against the JAX ops, float64."""
    from metrotrpl_tpu.ops import convolve as jc
    from metrotrpl_tpu.ops import interp as ji
    from metrotrpl_tpu_torch.ops import convolve as tc
    from metrotrpl_tpu_torch.ops import interp as ti

    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 10, (4, 20)), axis=1)
    y = rng.normal(0, 1, (4, 20))
    xq = rng.uniform(-1, 11, (4, 31))
    ref = np.asarray(jax.vmap(ji.interp1d)(jnp.asarray(xq), jnp.asarray(x),
                                           jnp.asarray(y)))
    mine = ti.interp1d(torch.as_tensor(xq), torch.as_tensor(x),
                       torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(np.isnan(mine), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(mine[ok], ref[ok], rtol=1e-13, atol=1e-13)

    jt = jc.load_irf_tables([520, 745], irf_dir="IRFs")
    tt = tc.load_irf_tables([520, 745], irf_dir="IRFs")
    for w in jt:
        np.testing.assert_array_equal(tt[w][0], jt[w][0])
        np.testing.assert_array_equal(tt[w][1], jt[w][1])

    table = np.stack([jt[745][0][:40], jt[520][0][:40]])
    sig = np.abs(rng.normal(0, 1, (2, 2 * 30 + 1)))
    ref = np.asarray(jax.jit(jc.convolve_moments)(jnp.asarray(sig),
                                                  jnp.asarray(table)))
    mine = tc.convolve_moments(torch.as_tensor(sig),
                               torch.as_tensor(table)).numpy()
    np.testing.assert_allclose(mine, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
