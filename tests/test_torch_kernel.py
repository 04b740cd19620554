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


def _flags_and_errors(out_k, out_p, thr=0.5):
    """(kernel flags, plain flags, max rel error, max |d log10|) of two
    (pl, tr, resid) outputs; the errors over the rows neither flags."""
    pl_k, tr_k, rs_k = (a.double().cpu().numpy() for a in out_k)
    pl_p, tr_p, rs_p = (a.double().cpu().numpy() for a in out_p)
    fk, fp = ~(rs_k.max(axis=0) < thr), ~(rs_p.max(axis=0) < thr)
    ok = ~(fk | fp)
    pairs = ((pl_k[:, ok], pl_p[:, ok]), (tr_k[:, ok], tr_p[:, ok]))
    rel = max(_rel_err(a, b) for a, b in pairs)
    dlog = max(float(np.max(np.abs(np.log10(np.abs(a))
                                   - np.log10(np.abs(b)))))
               for a, b in pairs)
    return fk, fp, rel, dlog


@pytest.mark.cuda
@pytest.mark.parametrize("nx", [17, 32, 33, 100, 128, 129, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_cuda_kernel_matches_plain_across_widths(cuda_device, model, dtype,
                                                 nx):
    """Kernel vs plain version at widths that leave ragged warps (17, 33,
    100, 129), fill them (32, 128) and pass 128 cells (129, 256), chord
    phases included: in float a thread per cell in one warp (17, 32), two
    (33) and four (100, 128), past 128 cells (and in double at every
    width) a thread per block row of one cell (up to 128) or of two
    (129, 256). The same rows over the Newton threshold 0.5, and on the
    others float64 rel <= 1e-9, float32 |d log10| <= 1e-4 (the chord
    solve amplifies float32 rounding with nx, and the reduction orders
    differ)."""
    p, y0, dts, dx = _kernel_inputs(4, nx, 16, dtype, cuda_device,
                                    n_ramp=8, model=model)
    kw = dict(model=model, refactor_every=4, n_ramp=8)
    out_k = sk.integrate_observables_cuda(p, y0, dts, dx, **kw)
    out_p = sk.integrate_observables_plain(p, y0, dts, dx, **kw)
    torch.cuda.synchronize()
    fk, fp, rel, dlog = _flags_and_errors(out_k, out_p)
    np.testing.assert_array_equal(fk, fp)
    assert (~fk).any()
    if dtype == torch.float64:
        assert rel <= 1e-9
    else:
        assert dlog <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_cuda_kernel_row_independent_of_batch(cuda_device, model, dtype):
    """A row's outputs do not depend on the batch it is solved in: the
    first row alone, and the first 48 rows in 9, 48, 384 (8 fused
    ensembles x 8 chains x 6 curves) and 48 more rows than the card holds
    at once, bit for bit, on a chord plan as the walk's fast plan is. The
    last batch runs in two waves, so later waves run the same rows (one
    block per row, nothing shared between blocks)."""
    occ = sk.occupancy(model, dtype, 128)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    waves = occ["blocks_per_sm"] * n_sm + 48
    p, y0, dts, dx = _kernel_inputs(max(384, waves), 128, 16, dtype,
                                    cuda_device, n_ramp=8, model=model)
    kw = dict(model=model, refactor_every=4, n_ramp=8)
    outs = {}
    sizes = (1, 9, 48, 384, waves)
    for B in sizes:
        sub = (type(p)(*(a[:B] for a in p)), y0[:B], dts[:, :B], dx[:B])
        outs[B] = [a[:, :48].cpu() for a in
                   sk.integrate_observables_cuda(*sub, **kw)]
    for B in sizes[1:]:
        for a, b in zip(outs[1], outs[B]):
            assert torch.equal(a[:, :1], b[:, :1])
        for a, b in zip(outs[48], outs[B]):
            assert torch.equal(a[:, :min(B, 48)], b[:, :min(B, 48)])


@pytest.mark.cuda
def test_cuda_occupancy_of_each_instantiation(cuda_device):
    """The occupancy query answers for every entry point with the
    launch's block shape: in float a thread per cell up to 128 cells (32,
    64 or 128 threads: one warp per 32 cells, a power of two), at nx=128
    3 std and 2 traps blocks per SM (396 and 264 resident rows, so the
    fused E=8 walk's 384 std rows run in one wave); past 128 cells, and
    in double, a thread per block row of a cell (NC x 128 threads at
    nx=128, NC x 96 at nx=150 with two cells a thread), at least one
    block per SM."""
    for model, nc in (("std", 3), ("traps", 4)):
        for nx, threads in ((17, 32), (32, 32), (33, 64), (100, 128),
                            (128, 128), (150, nc * 96)):
            occ = sk.occupancy(model, torch.float32, nx)
            assert occ["threads"] == threads, (model, nx)
            assert occ["blocks_per_sm"] >= 1 and occ["smem_bytes"] > 0
        occ = sk.occupancy(model, torch.float32, 128)
        assert occ["blocks_per_sm"] >= (3 if model == "std" else 2)
        occ = sk.occupancy(model, torch.float64, 128)
        assert occ["threads"] == nc * 128
        assert occ["blocks_per_sm"] >= 1 and occ["smem_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_cuda_kernel_flags_nan_row_like_plain(cuda_device, model, dtype):
    """A NaN in one row's initial state reaches that row's residual in the
    kernel as in the plain version (the sparse block algebra skips
    structural zeros, but NaN still wins every max), and only there."""
    p, y0, dts, dx = _kernel_inputs(4, 32, 8, dtype, cuda_device,
                                    model=model)
    y0 = y0.clone()
    y0[2, 0, 16] = float("nan")
    out_k = sk.integrate_observables_cuda(p, y0, dts, dx, model=model)
    out_p = sk.integrate_observables_plain(p, y0, dts, dx, model=model)
    torch.cuda.synchronize()
    fk, fp, rel, _ = _flags_and_errors(out_k, out_p)
    np.testing.assert_array_equal(fk, [False, False, True, False])
    np.testing.assert_array_equal(fk, fp)
    assert torch.isnan(out_k[2][1:, 2]).all()


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
#include <cstring>
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
  Params<double> p;  // the fields in their order, as the kernel reads them
  std::memcpy(&p, par, sizeof p);
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
    for (int r = 0; r < C; ++r) {
      double* Lr = L + C * r;
      double* Dr = D + C * r;
      double* Ur = U + C * r;
      if constexpr (C == 3) {
        out[r] = rhs_row(r, i, n, c[i], jl, Fl, jn[i], F[i], p);
        jac_row(r, i, n, c[i], ej[i], ep, p, Lr, Dr, Ur);
      } else {
        const double Ntr = y[Mo::T * n + i];
        out[r] = rhs_row_traps(r, i, n, c[i], Ntr, jl, Fl, jn[i], F[i], p);
        jac_row_traps(r, i, n, c[i], Ntr, ej[i], ep, p, Lr, Dr, Ur);
      }
    }
    for (int e = 0; e < NB; ++e)
      M[e] = (e % (C + 1) == 0 ? 1.0 : 0.0) - 0.1 * D[e];
    for (int r = 0; r < C; ++r)
      inv_row<C>(r, [&M](int k, int j) { return M[k * C + j]; }, Mi + C * r);
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
    """The traps model's per-cell arithmetic (rhs_row_traps,
    jac_row_traps, inv4_row in the Schur order of p_inv_small) against the
    plain PyTorch RHS, Jacobian and 4x4 inverse at float64, as the std
    test: each plane within 1e-13 of its max magnitude."""
    got, want = _cell_math_vs_plain(tmp_path, "traps")
    for col in range(want.shape[1]):
        assert _plane_rel(got[:, col], want[:, col]) < 1e-13, col


_PCR_HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "sdirk_solve.cuh"
using namespace sdirk;
// HARNESS_NC (3: std, 4: traps) comes from the command line.
// "patterns": prints, for each of 10 PCR levels, the compile-time non-zero
// patterns of the level's L, U, alpha and beta as 0/1 C x C matrices.
// "pcr": reads nx and the (L, D, U) blocks and a right-hand side of nx
// cells, runs the PCR factorization and apply row by row with the
// kernel's helpers (inv_row, pcr_level_row, pcr_apply_row), the
// neighbours' blocks read from the previous level as the kernel's shared
// memory holds them, and prints every level's alpha and beta, the final
// Dinv and the solution.
constexpr int C = HARNESS_NC, NB = C * C;
using V = std::vector<double>;

void inv_of(const double* D, int r, double* row) {
  inv_row<C>(r, [D](int k, int c) { return D[k * C + c]; }, row);
}

void print(const V& v) {
  for (double x : v) std::printf("%.17g ", x);
  std::printf("\n");
}

int main(int argc, char** argv) {
  using Pa = Pattern<C>;
  if (std::strcmp(argv[1], "patterns") == 0) {
    for (int lev = 0; lev < 10; ++lev) {
      const unsigned L = lev == 0 ? Pa::L0 : Pa::LS;
      const unsigned U = lev == 0 ? Pa::U0 : Pa::US;
      for (int a = 0; a < C; ++a)
        for (int b = 0; b < C; ++b)
          std::printf("%d %d %d %d ", pbit(L, a, b), pbit(U, a, b),
                      pbit(Pa::ALPHA, 0, a), pbit(Pa::BETA, 0, a));
      std::printf("\n");
    }
    return 0;
  }
  int n;
  if (std::scanf("%d", &n) != 1) return 1;
  V L(n * NB), D(n * NB), U(n * NB), b(n * C);
  for (V* v : {&L, &D, &U, &b})
    for (double& x : *v) std::scanf("%lf", &x);
  int levels = 0;
  while ((1 << levels) < n) ++levels;
  std::vector<V> fa, fb;
  for (int lev = 0, s = 1; lev < levels; ++lev, s *= 2) {
    V Di(n * NB), L0 = L, U0 = U, al(n * NB), be(n * NB);
    for (int i = 0; i < n; ++i)
      for (int r = 0; r < C; ++r) inv_of(&D[i * NB], r, &Di[i * NB + r * C]);
    for (int i = 0; i < n; ++i) {
      const int im = i - s >= 0 ? i - s : i, ip = i + s < n ? i + s : i;
      auto blk = [](const V& v, int j) {
        return [&v, j](int k, int c) { return v[j * NB + k * C + c]; };
      };
      for (int r = 0; r < C; ++r) {
        auto go = [&](auto first) {
          pcr_level_row<C, decltype(first)::value>(
              r, &L[i * NB + r * C], &D[i * NB + r * C], &U[i * NB + r * C],
              i - s >= 0, i + s < n, blk(Di, im), blk(L0, im), blk(U0, im),
              blk(Di, ip), blk(L0, ip), blk(U0, ip), &al[i * NB + r * C],
              &be[i * NB + r * C]);
        };
        if (lev == 0)
          go(std::true_type{});
        else
          go(std::false_type{});
      }
    }
    fa.push_back(al);
    fb.push_back(be);
    print(al);
    print(be);
  }
  V Dinv(n * NB);
  for (int i = 0; i < n; ++i)
    for (int r = 0; r < C; ++r) inv_of(&D[i * NB], r, &Dinv[i * NB + r * C]);
  print(Dinv);
  for (int lev = 0, s = 1; lev < levels; ++lev, s *= 2) {
    const V b0 = b;
    for (int i = 0; i < n; ++i)
      for (int r = 0; r < C; ++r) {
        const V &al = fa[lev], &be = fb[lev];
        b[i * C + r] = pcr_apply_row<C>(
            r, b0[i * C + r], i - s >= 0, i + s < n,
            [&](int c) { return al[i * NB + r * C + c]; },
            [&](int c) { return be[i * NB + r * C + c]; },
            [&](int k) { return b0[(i - s) * C + k]; },
            [&](int k) { return b0[(i + s) * C + k]; });
      }
  }
  V x(n * C);
  for (int i = 0; i < n; ++i)
    for (int r = 0; r < C; ++r) {
      double acc = 0.0;
      for (int k = 0; k < C; ++k)
        acc = madd(Dinv[i * NB + r * C + k], b[i * C + k], acc);
      x[i * C + r] = acc;
    }
  print(x);
  return 0;
}
"""


def _pcr_harness(tmp_path, model):
    """Build the PCR row harness for ``model`` with g++ (FMA where the
    kernel's double algebra has it, no other contraction)."""
    from metrotrpl_tpu_torch.physics.models import N_COMP
    from metrotrpl_tpu_torch.solver._build import CSRC

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = tmp_path / "pcr.cpp"
    src.write_text(_PCR_HARNESS)
    exe = tmp_path / "pcr"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    f"-DHARNESS_NC={N_COMP[model]}", "-I", str(CSRC),
                    str(src), "-o", str(exe)], check=True)
    return exe


@pytest.mark.parametrize("nx", [32, 100, 128, 256])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_kernel_patterns_match_pcr_patterns(tmp_path, model, nx):
    """The compile-time non-zero patterns of the kernel's header
    (Pattern<NC>: each level's L, U, alpha and beta) are those
    solve_kernel.pcr_patterns derives from the model's Jacobian and counts
    the bound on, at every level of an nx-cell grid."""
    exe = _pcr_harness(tmp_path, model)
    out = subprocess.run([str(exe), "patterns"], capture_output=True,
                         text=True, check=True).stdout.split("\n")
    C = 3 if model == "std" else 4
    levels = sk.pcr_patterns(model, nx)
    assert 0 < len(levels) <= 10
    for lev, (s, alpha, beta, L, U) in enumerate(levels):
        got = np.array(out[lev].split(), dtype=int).reshape(C, C, 4)
        for k, want in enumerate((L, U, alpha, beta)):
            np.testing.assert_array_equal(got[..., k].astype(bool), want,
                                          err_msg=f"level {lev}, shift {s}")


@pytest.mark.parametrize("nx", [16, 33])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_kernel_pcr_rows_match_plain_factor_and_apply(tmp_path, model, nx):
    """The kernel's per-row PCR helpers (a row of each block product on
    the level's non-zero pattern, a row of the block inverse, the row's
    apply update, FMA in double) against the plain pcr_factor / pcr_apply
    at float64 on random blocks with the model's Jacobian pattern: every
    level's alpha and beta, the final Dinv and the solution within 1e-12
    of each plane's largest magnitude."""
    from metrotrpl_tpu_torch.ops.blocktridiag import pcr_apply, pcr_factor

    exe = _pcr_harness(tmp_path, model)
    C = 3 if model == "std" else 4
    JL, JD, JU = sk.jacobian_pattern(model)
    rng = np.random.default_rng(nx)
    L = rng.uniform(-1, 1, (nx, C, C)) * JL
    U = rng.uniform(-1, 1, (nx, C, C)) * JU
    D = rng.uniform(-1, 1, (nx, C, C)) * JD + 6.0 * np.eye(C)
    L[0], U[-1] = 0.0, 0.0
    b = rng.uniform(-1, 1, (nx, C))
    stdin = f"{nx} " + " ".join(repr(float(v)) for v in
                                [*L.ravel(), *D.ravel(), *U.ravel(),
                                 *b.ravel()])
    out = subprocess.run([str(exe), "pcr"], input=stdin, capture_output=True,
                         text=True, check=True).stdout.strip().split("\n")
    rows = [np.array(line.split(), dtype=float) for line in out]

    def planes(A):       # (nx, C, C) -> nested tuple of (nx,) planes
        return tuple(tuple(torch.as_tensor(A[:, a, c]) for c in range(C))
                     for a in range(C))

    alphas, betas, dinv = pcr_factor(planes(L), planes(D), planes(U))
    x = pcr_apply((alphas, betas, dinv),
                  tuple(torch.as_tensor(b[:, c]) for c in range(C)))
    want = [blk for ab in zip(alphas, betas) for blk in ab] + [dinv]
    assert len(rows) == len(want) + 1
    for got, blk in zip(rows, want):
        got = got.reshape(nx, C, C)
        for a in range(C):
            for c in range(C):
                w = blk[a][c].numpy()
                assert _plane_rel(got[:, a, c], w) < 1e-12, (a, c)
    got_x = rows[-1].reshape(nx, C)
    for c in range(C):
        assert _plane_rel(got_x[:, c], x[c].numpy()) < 1e-12, c


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


# ---- the kernel's own source, run on the CPU ----
#
# The CUDA source with its launcher cut, compiled with g++ against a
# stand-in for the CUDA built-ins it uses: one std::thread per CUDA
# thread, __syncthreads a block-wide std::barrier, the warp collectives a
# per-warp barrier around a shared buffer, shared memory a buffer filled
# with NaN bytes (a read of a plane no thread wrote shows up as NaN).
# Every block of a launch runs in turn.

_EMU_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __grid_constant__
#define __launch_bounds__(...)
struct Dim { unsigned x; };
namespace emu {
inline thread_local Dim tid, bid;
inline Dim bdim;
inline unsigned char* smem;
inline std::barrier<>* block_bar;
inline std::vector<std::barrier<>*> warp_bar;
inline double wbuf[1024];
inline unsigned ubuf[1024];
}
#define threadIdx emu::tid
#define blockIdx emu::bid
#define blockDim emu::bdim
inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
// v of lane src of this warp
template <typename T>
T emu_shfl(T v, int src) {
  const unsigned t = threadIdx.x, w = t >> 5;
  emu::wbuf[t] = (double)v;
  emu::warp_bar[w]->arrive_and_wait();
  const T o = (T)emu::wbuf[(w << 5) | src];
  emu::warp_bar[w]->arrive_and_wait();
  return o;
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int off) {
  return emu_shfl(v, (int)(threadIdx.x & 31) ^ off);
}
template <typename T>
T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return emu_shfl(v, lane >= d ? lane - d : lane);
}
template <typename T>
T __shfl_down_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return emu_shfl(v, lane + d < 32 ? lane + d : lane);
}
template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  return emu_shfl(v, src & 31);
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu::warp_bar[threadIdx.x >> 5]->arrive_and_wait();
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  const unsigned t = threadIdx.x, w = t >> 5;
  emu::ubuf[t] = v;
  emu::warp_bar[w]->arrive_and_wait();
  unsigned m = 0;
  for (unsigned l = 0; l < 32; ++l)
    m = emu::ubuf[(w << 5) | l] > m ? emu::ubuf[(w << 5) | l] : m;
  emu::warp_bar[w]->arrive_and_wait();
  return m;
}
inline unsigned __float_as_uint(float f) {
  unsigned u; std::memcpy(&u, &f, 4); return u;
}
inline float __uint_as_float(unsigned u) {
  float f; std::memcpy(&f, &u, 4); return f;
}
inline long long __double_as_longlong(double d) {
  long long u; std::memcpy(&u, &d, 8); return u;
}
inline double __longlong_as_double(long long u) {
  double d; std::memcpy(&d, &u, 8); return d;
}
"""

_EMU_MAIN = r"""
// Reads one launch from stdin (B nx n_steps n_stages newton_iters
// n_phase1 ramp_block refactor ni_plateau gamma, the Butcher table, then
// dt, y0, par, dx as the C entry points take them) and prints the three
// (B, n_steps + 1) outputs, one per line. The launch takes the design,
// block shape and shared memory that launch() gives it (shape_of), or
// with a third argument "rows" the thread-per-row design (row_shape).
#include <cstdio>
#include <thread>
#include "kernel_cpu.h"
using namespace sdirk;

template <typename S, int NC>
void run(Kern<S, NC> kern, const Shape& v, int B, int nx, const Scheme<S>& sc,
         const Plan& plan, const std::vector<S>* in, std::vector<S>* out) {
  const int T = v.threads;
  std::vector<unsigned char> smem(v.smem + 64);
  for (int b = 0; b < B; ++b) {
    std::memset(smem.data(), 0xFF, smem.size());
    emu::smem = smem.data();
    emu::bdim.x = T;
    std::barrier<> bar(T);
    emu::block_bar = &bar;
    std::vector<std::barrier<>*> wb;
    for (int w = 0; w < T / 32; ++w) wb.push_back(new std::barrier<>(32));
    emu::warp_bar = wb;
    std::vector<std::thread> th;
    for (int t = 0; t < T; ++t)
      th.emplace_back([&, t] {
        emu::tid.x = t;
        emu::bid.x = b;
        kern(in[0].data(), in[1].data(), in[2].data(), in[3].data(),
             out[0].data(), out[1].data(), out[2].data(), nx, v.n_levels,
             v.W, v.cpt, sc, plan);
      });
    for (auto& x : th) x.join();
    for (auto* x : wb) delete x;
  }
}

template <typename S, int NC>
int go(bool rows) {
  int B, nx, n_steps, nst, ni, n_phase1, R, Fr, nip;
  double gamma;
  if (std::scanf("%d %d %d %d %d %d %d %d %d %lf", &B, &nx, &n_steps, &nst,
                 &ni, &n_phase1, &R, &Fr, &nip, &gamma) != 10)
    return 1;
  Scheme<S> sc;
  sc.n_stages = nst;
  std::vector<double> A(nst * nst);
  for (double& v : A) std::scanf("%lf", &v);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      sc.A[r][c] = (r < nst && c < nst) ? S(A[r * nst + c]) : S(0);
  sc.gamma = S(gamma);
  const Plan plan{n_steps, ni, n_phase1, R, Fr, nip};
  const size_t sizes[4] = {(size_t)B * n_steps, (size_t)B * NC * nx,
                           (size_t)B * N_PARAM, (size_t)B};
  std::vector<S> in[4], out[3];
  for (int k = 0; k < 4; ++k) {
    in[k].resize(sizes[k]);
    for (S& x : in[k]) {
      double d;
      std::scanf("%lf", &d);
      x = S(d);
    }
  }
  for (auto& o : out) o.assign((size_t)B * (n_steps + 1), S(0));
  const Shape v = rows ? row_shape<S, NC>(nx) : shape_of<S, NC>(nx);
  // Sim's one-cell variant in float runs here only
  const Kern<S, NC> k = v.cpt == 1 && !v.cell ? sdirk_solve_kernel<S, NC, 1>
                                              : kernel_of<S, NC>(v);
  run<S, NC>(k, v, B, nx, sc, plan, in, out);
  for (auto& o : out) {
    for (S x : o) std::printf("%.17g ", (double)x);
    std::printf("\n");
  }
  return 0;
}

int main(int argc, char** argv) {
  const bool f64 = argv[2][0] == 'd';
  const bool rows = argc > 3 && std::strcmp(argv[3], "rows") == 0;
  if (argv[1][0] == '3')
    return f64 ? go<double, 3>(rows) : go<float, 3>(rows);
  return f64 ? go<double, 4>(rows) : go<float, 4>(rows);
}
"""


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """The solve kernel's CUDA source built with g++ into a CPU program
    (the launcher cut, the built-ins emulated); no FP contraction but the
    source's own fma, as nvcc builds it with -fmad=false."""
    from metrotrpl_tpu_torch.solver._build import CSRC

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("kernel_cpu")
    src = (CSRC / "sdirk_solve.cu").read_text()
    src = src[:src.index("// ---- host side")]
    src = src.replace("#include <cuda_runtime.h>", '#include "emu_rt.h"')
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu::smem;")
    (d / "kernel_cpu.h").write_text(src + "}  // namespace sdirk\n")
    (d / "emu_rt.h").write_text(_EMU_RUNTIME)
    (d / "main.cpp").write_text(_EMU_MAIN)
    exe = d / "kernel_cpu"
    subprocess.run([gxx, "-O1", "-std=c++20", "-pthread",
                    "-ffp-contract=off", "-I", str(CSRC), "-I", str(d),
                    str(d / "main.cpp"), "-o", str(exe)], check=True)
    return exe


def _run_kernel_on_cpu(exe, model, p, y0, dts, dx, rows=False, **kw):
    """The kernel's outputs (pl, tr, resid), each (n_steps + 1, B), from
    the CPU build, on the wrapper's inputs and plan arguments; ``rows``
    runs the thread-per-row design whatever the launch would pick."""
    from metrotrpl_tpu_torch.solver.sdirk import SDIRK_SCHEMES

    n_steps, B = dts.shape
    ni = kw.get("newton_iters", 2)
    ramp, R, Fr, ni_p = sk._normalize_chord(
        n_steps, kw.get("refactor_every", 1), kw.get("n_ramp"),
        kw.get("ramp_block", 1), ni, kw.get("newton_plateau"))
    sch = SDIRK_SCHEMES["sdirk3"]
    par = torch.cat([f.reshape(B, 1) for f in p], 1)
    head = [B, y0.shape[-1], n_steps, sch.A.shape[0], ni,
            n_steps if ramp is None else ramp, R, Fr, ni_p,
            repr(float(sch.gamma))]
    vals = [*sch.A.ravel().tolist(), *dts.T.reshape(-1).tolist(),
            *y0.reshape(-1).tolist(), *par.reshape(-1).tolist(),
            *dx.tolist()]
    stdin = " ".join(map(str, head)) + " " + " ".join(
        repr(float(v)) for v in vals)
    C = "3" if model == "std" else "4"
    dt = "d" if y0.dtype == torch.float64 else "f"
    out = subprocess.run([str(exe), C, dt] + ["rows"] * rows, input=stdin,
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout
    return [np.array(line.split(), dtype=float).reshape(B, n_steps + 1).T
            for line in out.strip().split("\n")]


@pytest.mark.parametrize("nx", [17, 100, 150])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_kernel_source_on_cpu_matches_plain_version(kernel_on_cpu, model,
                                                    dtype, nx):
    """The kernel's CUDA source, run on the CPU thread for thread, against
    the plain version, chord phases included, in the design the launch
    picks: in float a thread per cell in one ragged warp (nx=17: every
    exchange a warp shuffle) and in four warps (nx=100: the neighbours and
    the levels at shifts 1 and 2 through shared memory, shifts 4 to 64 by
    shuffles), in double a thread per block row of one cell (17, 100),
    and past 128 cells two cells per thread (nx=150, factors
    thread-local). float64 within rel 1e-12 (the kernel's fma against the
    plain version's separate roundings), float32 within |d log10| 1e-5
    on the observables (the block sums run in another order); the
    residuals alike."""
    n_steps = 6 if nx < 100 else 3
    kw = dict(refactor_every=2, n_ramp=n_steps - 2)
    p, y0, dts, dx = _kernel_inputs(2, nx, n_steps, dtype, "cpu",
                                    n_ramp=n_steps - 2, model=model)
    got = _run_kernel_on_cpu(kernel_on_cpu, model, p, y0, dts, dx, **kw)
    want = [a.double().numpy() for a in sk.integrate_observables_plain(
        p, y0, dts, dx, model=model, **kw)]
    assert all(np.isfinite(a).all() for a in got)
    for a, b in zip(got[:2], want[:2]):
        if dtype == torch.float64:
            assert _rel_err(a, b) < 1e-12
        else:
            assert np.max(np.abs(np.log10(a) - np.log10(b))) < 1e-5
    np.testing.assert_allclose(got[2], want[2],
                               rtol=1e-6 if dtype == torch.float64 else 1e-3,
                               atol=1e-12)


def _nan_row_on_cpu(exe, model, dtype, nx):
    p, y0, dts, dx = _kernel_inputs(3, nx, 4, dtype, "cpu", model=model)
    y0 = y0.clone()
    y0[1, 0, nx // 2] = float("nan")
    got = _run_kernel_on_cpu(exe, model, p, y0, dts, dx)
    want = sk.integrate_observables_plain(p, y0, dts, dx, model=model)
    flags = ~(got[2].max(axis=0) < 0.5)
    np.testing.assert_array_equal(flags, [False, True, False])
    np.testing.assert_array_equal(flags,
                                  ~(want[2].numpy().max(axis=0) < 0.5))
    assert np.isnan(got[2][1:, 1]).all()


@pytest.mark.parametrize("model", ["std", "traps"])
def test_kernel_source_on_cpu_flags_nan_row(kernel_on_cpu, model):
    """A NaN in one row's initial state reaches that row's residual in the
    kernel's source run on the CPU, as in the plain version, and no other
    row's (double: the thread-per-row design)."""
    _nan_row_on_cpu(kernel_on_cpu, model, torch.float64, 24)


@pytest.mark.parametrize("nx", [24, 100])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_kernel_source_on_cpu_flags_nan_row_in_float(kernel_on_cpu, model,
                                                     nx):
    """The NaN row in float, through the thread-per-cell design in one
    warp (nx=24) and in four (nx=100, where the damping max crosses the
    warps' slots): that row's residual only, as in the plain version."""
    _nan_row_on_cpu(kernel_on_cpu, model, torch.float32, nx)


@pytest.mark.parametrize("nx", [17, 33, 100, 128])
@pytest.mark.parametrize("model", ["std", "traps"])
def test_kernel_source_on_cpu_cell_design_equals_row_design(kernel_on_cpu,
                                                           model, nx):
    """In float the thread-per-cell design computes every output entry by
    the operations of the thread-per-row design (the same per-row header
    functions on the same operands, the knot sums in the same order, the
    damping max by the same bits), so their outputs agree bit for bit:
    one warp (17), two (33: the neighbours and shift 1 through shared
    memory) and four (100, 128), chord phases on."""
    kw = dict(refactor_every=2, n_ramp=4)
    p, y0, dts, dx = _kernel_inputs(2, nx, 6, torch.float32, "cpu",
                                    n_ramp=4, model=model)
    cell = _run_kernel_on_cpu(kernel_on_cpu, model, p, y0, dts, dx, **kw)
    rows = _run_kernel_on_cpu(kernel_on_cpu, model, p, y0, dts, dx,
                              rows=True, **kw)
    for a, b in zip(cell, rows):
        np.testing.assert_array_equal(a, b)
