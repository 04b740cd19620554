"""The solve kernel's wrapper (solver/solve_kernel.py): its plain PyTorch
path and checks on the CPU, the kernel's per-cell arithmetic built with
g++, and — on a machine with a card only — the CUDA kernel against the
plain version.

This file imports no jax, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_kernel.py -q

(``--noconftest`` skips tests/conftest.py, which imports jax.)
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from metrotrpl_tpu_torch.physics.models import (
    beer_lambert,
    initial_state,
    make_scaled_params,
)
from metrotrpl_tpu_torch.solver import solve_kernel as sk
from metrotrpl_tpu_torch.workloads import STAUB_TRUE, STAUB_UC, TRAPS_TRUE


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (tests marked
    ``cuda`` run only on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(a, b):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _kernel_inputs(B, nx, n_steps, dtype, device, seed=0, n_ramp=None,
                   model="std"):
    """Scaled params, initial state, step sizes and cell sizes of B staub
    rows (+-0.1 dex; the traps model adds its trap parameters), as the
    wrapper takes them. Steps grow geometrically over the first n_ramp
    (default: all) and stay constant after, as a chord plan's grid does."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    truth = {k: v * STAUB_UC.get(k, 1) for k, v in STAUB_TRUE.items()}
    if model == "traps":
        truth.update(TRAPS_TRUE)
    raw = {k: t(v * 10.0 ** rng.uniform(-0.1, 0.1, B))
           for k, v in truth.items()}
    th = np.where(np.arange(B) % 2, 2000.0, 311.0)
    dx = t(th / nx)
    x = t((np.arange(nx)[None, :] + 0.5) * (th / nx)[:, None])
    init = beer_lambert(t(np.full((B, 1), 2.12e-3)),
                        t(np.full((B, 1), 6e-3)), x)
    ns = torch.amax(init, dim=-1) + raw["p0"] + raw["n0"]
    p = make_scaled_params(raw, dx, ns)
    p = type(p)(*(a[..., None] for a in p))
    y0 = initial_state(init, ns[..., None], model=model)
    n_ramp = n_steps if n_ramp is None else n_ramp
    dt = np.concatenate([np.geomspace(1e-3, 2.0, n_ramp),
                         np.full(n_steps - n_ramp, 2.0)])
    dts = t(dt[:, None].repeat(B, 1))
    return p, y0, dts, dx


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    """For CPU tensors the wrapper is the plain version: no kernel build,
    no launch counted, the (n_steps + 1, B) layout of the Pallas
    wrapper."""
    sk.reset_launch_counts()
    p, y0, dts, dx = _kernel_inputs(3, 8, 5, torch.float64, "cpu")
    pl, tr, rs = sk.integrate_observables_cuda(p, y0, dts, dx)
    assert pl.shape == tr.shape == rs.shape == (6, 3)
    assert torch.isfinite(pl).all() and (rs[0] == 0).all()
    assert set(sk.LAUNCHES.values()) == {0}
    assert set(sk.LAUNCHES) == {(m, d) for m in ("std", "traps")
                                for d in (torch.float32, torch.float64)}
    assert sk._LIB is None


@pytest.mark.parametrize("bad, match", [
    (dict(refactor_every=3, n_ramp=2), "refactor_every"),
    (dict(ramp_block=4, n_ramp=6, refactor_every=2), "ramp_block"),
    (dict(n_ramp=None, newton_plateau=1), "newton_plateau"),
])
def test_wrapper_checks_chord_contract(bad, match):
    """The chord blocks must tile their phases (the kernel uses each
    block's first dt for the whole block), and plateau iterations need a
    chord plan, as the plain version requires."""
    with pytest.raises(ValueError, match=match):
        sk._normalize_chord(10, bad.get("refactor_every", 1),
                            bad["n_ramp"], bad.get("ramp_block", 1), 2,
                            bad.get("newton_plateau"))
    assert sk._normalize_chord(10, 1, 4, 1, 2, None) == (None, 1, 1, 2)
    assert sk._normalize_chord(10, 2, 4, 2, 2, 1) == (4, 2, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-9),
                                         (torch.float32, 1e-4)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, rtol):
    """The CUDA kernel against the plain PyTorch version on the same
    inputs on the card, chord phases included (constant dt on the
    plateau, as the plan guarantees): float64 rel 1e-9, float32 rtol 1e-4
    (the reduction order differs; at nx=32 the float32 solve is well
    conditioned)."""
    p, y0, dts, dx = _kernel_inputs(6, 32, 40, dtype, cuda_device,
                                    n_ramp=20)
    kw = dict(refactor_every=4, n_ramp=20)
    sk.reset_launch_counts()
    out_k = sk.integrate_observables_cuda(p, y0, dts, dx, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[("std", dtype)] == 1
    out_p = sk.integrate_observables_plain(p, y0, dts, dx, **kw)
    assert sum(sk.LAUNCHES.values()) == 1
    for a, b in zip(out_k[:2], out_p[:2]):
        assert _rel_err(a.cpu().numpy(), b.cpu().numpy()) < rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 1e-9),
                                         (torch.float32, 1e-4)])
def test_cuda_traps_kernel_matches_plain_version(cuda_device, dtype, rtol):
    """The traps instantiation (C=4) against the plain PyTorch version on
    the card, chord phases included, at the std test's tolerances:
    float64 rel 1e-9, float32 rtol 1e-4 at nx=32. The call launches the
    traps instantiation and nothing else."""
    p, y0, dts, dx = _kernel_inputs(6, 32, 40, dtype, cuda_device,
                                    n_ramp=20, model="traps")
    kw = dict(model="traps", refactor_every=4, n_ramp=20)
    sk.reset_launch_counts()
    out_k = sk.integrate_observables_cuda(p, y0, dts, dx, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[("traps", dtype)] == 1
    assert sum(sk.LAUNCHES.values()) == 1
    out_p = sk.integrate_observables_plain(p, y0, dts, dx, **kw)
    for a, b in zip(out_k[:2], out_p[:2]):
        assert _rel_err(a.cpu().numpy(), b.cpu().numpy()) < rtol


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    p, y0, dts, dx = _kernel_inputs(2, 8, 4, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        sk.integrate_observables_cuda(p, y0.half(), dts, dx)
    with pytest.raises(ValueError):
        sk.integrate_observables_cuda(p, y0, dts, dx.double())
    with pytest.raises(ValueError):
        sk.integrate_observables_cuda(p, y0, dts[:, :1], dx)
    with pytest.raises(ValueError, match="traps"):   # a std state
        sk.integrate_observables_cuda(p, y0, dts, dx, model="traps")


_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "sdirk_solve.cuh"
using namespace sdirk;
// HARNESS_NC (3: std, 4: traps) comes from the command line. Reads nx,
// the 17 scaled parameters and the (C, nx) state; prints, per cell, the RHS,
// the Jacobian blocks (L, D, U) and inv(I - 0.1 D), with each edge
// computed once and shared as sdirk_solve.cu does.
template <int C>
int run() {
  using Mo = Model<C>;
  constexpr int NB = C * C;
  int n;
  if (std::scanf("%d", &n) != 1) return 1;
  double par[N_PARAM];
  for (double& v : par) std::scanf("%lf", &v);
  std::vector<double> y(C * n);
  for (double& v : y) std::scanf("%lf", &v);
  const Params<double> p = load_params(par);
  std::vector<Cell<double>> c(n);
  for (int i = 0; i < n; ++i)
    c[i] = make_cell(y[Mo::N * n + i], y[Mo::D * n + i], y[Mo::E * n + i], p);
  std::vector<double> jn(n), F(n);
  std::vector<EdgeJac<double>> ej(n);
  for (int i = 0; i < n; ++i) {
    const Cell<double>& hi = c[i < n - 1 ? i + 1 : i];
    right_edge_flux(i, n, c[i], hi, p, &jn[i], &F[i]);
    ej[i] = own_edge_jac(i, n, c[i], hi, p);
  }
  for (int i = 0; i < n; ++i) {
    double jl, Fl;
    if (i > 0) { jl = jn[i - 1]; Fl = F[i - 1]; }
    else { jl = surface_flux(c[0], p.sf); Fl = 0.0; }
    double out[C], L[NB], D[NB], U[NB], M[NB], Mi[NB];
    EdgeJac<double> ep = {0, 0, 0, 0, 0, 0, 0, 0};
    if (i > 0) ep = ej[i - 1];
    if constexpr (C == 3) {
      rhs_cell(i, n, c[i], jl, Fl, jn[i], F[i], p, out);
      jac_cell(i, n, c[i], ej[i], ep, p, L, D, U);
    } else {
      const double Ntr = y[Mo::T * n + i];
      rhs_cell_traps(i, n, c[i], Ntr, jl, Fl, jn[i], F[i], p, out);
      jac_cell_traps(i, n, c[i], Ntr, ej[i], ep, p, L, D, U);
    }
    for (int e = 0; e < NB; ++e)
      M[e] = (e % (C + 1) == 0 ? 1.0 : 0.0) - 0.1 * D[e];
    inv<C>(M, Mi);
    for (double v : out) std::printf("%.17g ", v);
    for (const double* A : {(const double*)L, (const double*)D,
                            (const double*)U, (const double*)Mi})
      for (int e = 0; e < NB; ++e) std::printf("%.17g ", A[e]);
    std::printf("\n");
  }
  return 0;
}

int main() { return run<HARNESS_NC>(); }
"""


def _cell_math_vs_plain(tmp_path, model):
    """Build the per-cell harness for ``model`` with g++ (no contracted
    multiply-adds, as nvcc builds the kernel with -fmad=false), feed it a
    random state, and return its output and the plain PyTorch RHS,
    Jacobian blocks and block inverse of I - 0.1 D, as (nx, C + 4 C^2)
    columns."""
    from metrotrpl_tpu_torch.ops.blocktridiag import p_inv_small
    from metrotrpl_tpu_torch.physics import models as tm
    from metrotrpl_tpu_torch.solver._build import CSRC

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    C = tm.N_COMP[model]
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    f"-DHARNESS_NC={C}", "-I", str(CSRC), str(src), "-o",
                    str(exe)], check=True)

    nx = 16
    p, y0, _, _ = _kernel_inputs(1, nx, 2, torch.float64, "cpu", seed=3,
                                 model=model)
    rng = np.random.default_rng(4)
    y = y0[0].numpy().copy()
    slot = {"std": (1, 2), "traps": (2, 3)}[model]
    y[slot[0]] = rng.uniform(-1e-3, 1e-3, nx)    # charge separation
    y[slot[1]] = rng.uniform(-1e-2, 1e-2, nx)    # field
    if model == "traps":
        y[1] = rng.uniform(0.0, 2.0, nx) * p.nt_s.item()   # trapped density
    par = torch.cat([f.reshape(1) for f in p]).numpy()
    stdin = " ".join(map(repr, [nx, *par.tolist(), *y.ravel().tolist()]))
    out = subprocess.run([str(exe)], input=stdin, capture_output=True,
                         text=True, check=True).stdout
    got = np.array([[float(v) for v in line.split()]
                    for line in out.strip().splitlines()])

    yt = tuple(torch.as_tensor(y[c])[None] for c in range(C))
    rhs = [r[0].numpy() for r in tm.RHS_PLANES[model](yt, p)]
    L, D, U = tm.JAC_PLANES[model](yt, p)
    M = tuple(tuple((1.0 if a == b else 0.0) - 0.1 * D[a][b]
                    for b in range(C)) for a in range(C))
    Mi = p_inv_small(M)
    want = np.stack(rhs + [A[a][b][0].numpy() for A in (L, D, U, Mi)
                           for a in range(C) for b in range(C)], axis=1)
    assert got.shape == want.shape == (nx, C + 4 * C * C)
    return got, want


def _plane_rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def test_kernel_cell_math_matches_plain_version_on_cpu(tmp_path):
    """The kernel's per-cell arithmetic of the std model
    (solver/csrc/sdirk_solve.cuh), built for the CPU with g++ and no
    contracted multiply-adds (as nvcc builds it with -fmad=false), against
    the plain PyTorch RHS, symbolic Jacobian and 3x3 inverse at float64:
    each plane within 1e-13 of its max magnitude (libm and reassociation
    are the only differences)."""
    got, want = _cell_math_vs_plain(tmp_path, "std")
    for col in range(want.shape[1]):
        assert _plane_rel(got[:, col], want[:, col]) < 1e-13, col


def test_kernel_traps_cell_math_matches_plain_version_on_cpu(tmp_path):
    """The traps model's per-cell arithmetic (rhs_cell_traps,
    jac_cell_traps, inv4 in the Schur order of p_inv_small) against the
    plain PyTorch RHS, Jacobian and 4x4 inverse at float64, as the std
    test: each plane within 1e-13 of its max magnitude."""
    got, want = _cell_math_vs_plain(tmp_path, "traps")
    for col in range(want.shape[1]):
        assert _plane_rel(got[:, col], want[:, col]) < 1e-13, col


def _newton_blocks(model, nx, hg=0.7):
    """Blocks (L, D, U) of I - hg*J at a random state of ``model`` (as the
    per-cell harness makes it), as (C, C, nx) float64 arrays."""
    from metrotrpl_tpu_torch.physics import models as tm

    C = tm.N_COMP[model]
    p, y0, _, _ = _kernel_inputs(1, nx, 2, torch.float64, "cpu", seed=3,
                                 model=model)
    rng = np.random.default_rng(4)
    y = y0[0].numpy().copy()
    slot = {"std": (1, 2), "traps": (2, 3)}[model]
    y[slot[0]] = rng.uniform(-1e-3, 1e-3, nx)
    y[slot[1]] = rng.uniform(-1e-2, 1e-2, nx)
    if model == "traps":
        y[1] = rng.uniform(0.0, 2.0, nx) * p.nt_s.item()
    yt = tuple(torch.as_tensor(y[c])[None] for c in range(C))
    JL, JD, JU = (np.array([[e[0].numpy() for e in row] for row in B])
                  for B in tm.JAC_PLANES[model](yt, p))
    return -hg * JL, np.eye(C)[:, :, None] - hg * JD, -hg * JU, JL, JD, JU


@pytest.mark.parametrize("model", ["std", "traps"])
def test_pcr_patterns_match_plain_factorization(model):
    """The non-zero patterns solve_flops counts on (each PCR level's alpha
    and beta) are those of the plain version's pcr_factor at a random
    state: no block is counted wider or narrower than the data is."""
    from metrotrpl_tpu_torch.ops.blocktridiag import pcr_factor

    nx = 32
    L, D, U = (tuple(tuple(torch.as_tensor(row[b]) for b in range(len(row)))
                     for row in B)
               for B in _newton_blocks(model, nx)[:3])
    alphas, betas, _ = pcr_factor(L, D, U)
    levels = sk.pcr_patterns(model, nx)
    assert len(levels) == len(alphas) == 5
    for (s, alpha, beta, _, _), a_k, b_k in zip(levels, alphas, betas):
        for want, got in ((alpha, a_k), (beta, b_k)):
            nz = np.array([[bool((e != 0).any()) for e in row]
                           for row in got])
            np.testing.assert_array_equal(want, nz, err_msg=f"shift {s}")
    if model == "traps":          # trapping is cell-local: row T is zero
        for op in (*alphas, *betas):
            assert not any(e.any() for e in op[1])


def _factor_and_apply_flops_on_data(model, nx):
    """FLOPs of one PCR factorization (with the Jacobian and I - hg*J) and
    one apply, counted cell by cell on the entries that are non-zero in
    the data: the least work, without the pattern's boundary excess."""
    from metrotrpl_tpu_torch.ops.blocktridiag import n_pcr_levels

    def mm(A, B):
        k = ((A[:, :, None, :] != 0) & (B[None, :, :, :] != 0)).sum(1)
        return int((2 * k - 1)[k > 0].sum()), np.einsum("ikn,kjn->ijn", A, B)

    def shift(A, s):          # out[..., i] = A[..., i - s], zero-padded
        out = np.zeros_like(A)
        if s > 0:
            out[..., s:] = A[..., :-s]
        else:
            out[..., :s] = A[..., -s:]
        return out

    L, D, U, JL, JD, JU = _newton_blocks(model, nx)
    C = D.shape[0]
    inv = sk._INV_FLOPS[C]
    fac = nx * (sk._CELL_FLOPS[model]["jac"] + C) + int(
        (JL != 0).sum() + (JD != 0).sum() + (JU != 0).sum())
    app, s = nx * C * (2 * C - 1), 1
    for _ in range(n_pcr_levels(nx)):
        Dinv = np.moveaxis(np.linalg.inv(np.moveaxis(D, -1, 0)), 0, -1)
        f1, alpha = mm(L, shift(Dinv, s))
        f2, beta = mm(U, shift(Dinv, -s))
        alpha, beta = -alpha, -beta
        f3, L_next = mm(alpha, shift(L, s))
        f4, t = mm(alpha, shift(U, s))
        f5, u = mm(beta, shift(L, -s))
        f6, U_next = mm(beta, shift(U, -s))
        fac += nx * inv + f1 + f2 + f3 + f4 + f5 + f6 + int(
            (t != 0).sum() + (u != 0).sum())
        for a in (alpha, beta):
            r = (a != 0).sum(1)
            app += int((2 * r - 1)[r > 0].sum() + (r > 0).sum())
        D, L, U = D + (t + u), L_next, U_next
        s *= 2
    return fac + nx * inv, app


@pytest.mark.parametrize("model", ["std", "traps"])
def test_solve_flops_counts_the_work_on_the_data(model):
    """factor_flops and apply_flops (the pattern count behind the kernel's
    bound) against a count made cell by cell on the data: never below it,
    and above it by at most 2 % at nx=32 (boundary cells whose blocks hold
    extra zeros)."""
    fac, app = _factor_and_apply_flops_on_data(model, 32)
    assert fac <= sk.factor_flops(model, 32) <= 1.02 * fac
    assert app <= sk.apply_flops(model, 32) <= 1.02 * app


def test_solve_flops_counts_one_factorization_per_chord_block():
    """A chord plan saves exactly the factorizations it skips: 40 steps
    chord-free factor 40 times; a ramp of 20 steps in blocks of 2 and a
    plateau in blocks of 4 factor 10 + 5 times; the Newton work is the
    same."""
    free = sk.solve_flops("traps", 32, 40, newton_iters=2)
    chord = sk.solve_flops("traps", 32, 40, newton_iters=2, n_ramp=20,
                           ramp_block=2, refactor_every=4)
    assert free - chord == (40 - 15) * sk.factor_flops("traps", 32)
    assert sk.solve_flops("std", 32, 40) < free
