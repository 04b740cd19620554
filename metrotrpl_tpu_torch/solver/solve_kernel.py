"""Wrapper of the CUDA SDIRK solve kernel (``csrc/sdirk_solve.cu``).

Counterpart of ``metrotrpl_tpu/solver/pallas_step.py``:
:func:`integrate_observables_cuda` takes the arguments of
``integrate_observables_pallas`` and returns the same
``(pl_t, trts_t, resid_t)``, each (n_steps + 1, B).

For CPU tensors it runs the plain PyTorch version
(``solver/sdirk.py:integrate_observables``); for CUDA tensors it launches
the kernel's instantiation for the model (std, C=3, or traps, C=4) and
dtype on the current stream, or raises. The launch picks the kernel's
design from the dtype and the grid (``shape_of`` in the source): float
up to 128 cells a thread per cell (32, 64 or 128 threads), otherwise a
thread per block row of a cell; both give the same bits. ``LAUNCHES``
counts kernel launches per (model, dtype), so a run can show which
instantiations its solves went through, and ``ROWS`` the rows those
launches solved.
:func:`solve_flops` counts the operations a call needs, for the kernel's
bound.
"""

import ctypes

import numpy as np
import torch

from metrotrpl_tpu_torch.ops.blocktridiag import n_pcr_levels
from metrotrpl_tpu_torch.physics.models import (
    JAC_PLANES,
    N_COMP,
    RHS_PLANES,
    ScaledParams,
    observables_planes,
)
from metrotrpl_tpu_torch.solver.sdirk import SDIRK_SCHEMES, integrate_observables

N_PARAM_FIELDS = len(ScaledParams._fields)

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
#: kernel launches per (model, dtype), incremented only where the kernel
#: launches
LAUNCHES = {(m, d): 0 for m in N_COMP for d in _DTYPE_TAG}
#: rows (simulations) solved by those launches
ROWS = dict(LAUNCHES)

_LIB = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        ROWS[k] = 0


def kernel_library():
    """Build (first call) and return the loaded kernel library."""
    global _LIB
    if _LIB is None:
        from metrotrpl_tpu_torch.solver._build import build_library
        _LIB = build_library()
    return _LIB


def _normalize_chord(n_steps, refactor_every, n_ramp, ramp_block,
                     newton_iters, newton_plateau):
    """The plan's chord contract, checked like integrate_observables_pallas
    and as the plain version checks it: returns (n_ramp or None,
    ramp_block, refactor_every, plateau iters)."""
    ni_p = newton_iters if newton_plateau is None else int(newton_plateau)
    if refactor_every <= 1 and ramp_block <= 1 and ni_p == newton_iters:
        n_ramp = None
    if n_ramp is None:
        if ni_p != newton_iters:
            raise ValueError("newton_plateau requires a chord-mode plan "
                             "(n_ramp phase boundary)")
        return None, 1, 1, newton_iters
    if ramp_block > 1 and n_ramp % ramp_block != 0:
        raise ValueError(
            f"ramp_block ({ramp_block}) must divide n_ramp ({n_ramp})")
    if (n_steps - n_ramp) % refactor_every != 0:
        raise ValueError(
            f"refactor_every ({refactor_every}) must divide the "
            f"plateau length ({n_steps - n_ramp})")
    return int(n_ramp), max(int(ramp_block), 1), max(int(refactor_every), 1), \
        ni_p


def integrate_observables_plain(params, y0, dts, dx, model="std",
                                scheme_name="sdirk3", newton_iters=2,
                                refactor_every=1, n_ramp=None, ramp_block=1,
                                newton_plateau=None):
    """The kernel's plain PyTorch version, on any device, with the
    arguments and return layout of :func:`integrate_observables_cuda`."""
    rhs_fn, jac_fn = RHS_PLANES[model], JAC_PLANES[model]
    (pl_t, tr_t), rs_t = integrate_observables(
        lambda y: rhs_fn(y, params), lambda y: jac_fn(y, params),
        lambda y: observables_planes(y, params, dx, model),
        tuple(torch.unbind(y0, dim=-2)), dts, scheme_name=scheme_name,
        newton_iters=newton_iters, refactor_every=refactor_every,
        n_ramp=n_ramp, ramp_block=ramp_block, newton_plateau=newton_plateau)
    return pl_t, tr_t, rs_t


def integrate_observables_cuda(params, y0, dts, dx, model="std",
                               scheme_name="sdirk3", newton_iters=2,
                               refactor_every=1, n_ramp=None, ramp_block=1,
                               newton_plateau=None):
    """Integrate a batch through every step and stream observables.

    params : ScaledParams with (B, 1) fields
    y0     : (B, C, nx) scaled initial state, C = N_COMP[model]
    dts    : (n_steps, B) step sizes
    dx     : (B,) cell sizes
    Returns (pl_t, trts_t, resid_t), each (n_steps + 1, B): the scaled
    TRPL/TRTS observables and the Newton residual at every knot.
    """
    if model not in N_COMP:
        raise ValueError(f"Invalid model {model!r}")
    if y0.device.type == "cpu":
        return integrate_observables_plain(
            params, y0, dts, dx, model=model, scheme_name=scheme_name,
            newton_iters=newton_iters, refactor_every=refactor_every,
            n_ramp=n_ramp, ramp_block=ramp_block,
            newton_plateau=newton_plateau)
    if y0.device.type != "cuda":
        raise ValueError(f"unsupported device {y0.device}")
    return _launch(params, y0, dts, dx, model, scheme_name, newton_iters,
                   refactor_every, n_ramp, ramp_block, newton_plateau)


def _launch(params, y0, dts, dx, model, scheme_name, newton_iters,
            refactor_every, n_ramp, ramp_block, newton_plateau):
    dtype = y0.dtype
    if dtype not in _DTYPE_TAG:
        raise TypeError(f"the solve kernel takes float32 or float64, "
                        f"not {dtype}")
    nc = N_COMP[model]
    if y0.dim() != 3 or y0.shape[1] != nc:
        raise ValueError(f"the {model} model's y0 must be (B, {nc}, nx), "
                         f"got {tuple(y0.shape)}")
    B, C, nx = y0.shape
    if len(params) != N_PARAM_FIELDS:
        raise ValueError(f"params must have the {N_PARAM_FIELDS} "
                         "ScaledParams fields")
    if nx > 1024:
        raise ValueError(f"nx={nx} > 1024 (the kernel's largest grid)")
    n_steps = dts.shape[0]
    if dts.shape != (n_steps, B) or dx.shape != (B,):
        raise ValueError("dts must be (n_steps, B) and dx (B,)")
    ramp, R, Fr, ni_p = _normalize_chord(n_steps, refactor_every, n_ramp,
                                         ramp_block, newton_iters,
                                         newton_plateau)
    n_phase1 = n_steps if ramp is None else ramp
    scheme = SDIRK_SCHEMES[scheme_name]

    par = torch.cat([torch.reshape(f, (B, 1)) for f in params], dim=1)
    ins = [dts.T, y0, par, dx]
    dev = y0.device
    for a in ins:
        if a.device != dev or a.dtype != dtype:
            raise ValueError("every kernel input must share y0's device and "
                             "dtype")
    dt_b, y0_c, par_c, dx_c = (a.contiguous() for a in ins)
    for a in (dt_b, y0_c, par_c, dx_c):
        if not a.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    out = [torch.empty((B, n_steps + 1), dtype=dtype, device=dev)
           for _ in range(3)]

    lib = kernel_library().lib
    fn = getattr(lib, f"metrotrpl_sdirk_solve_{model}_{_DTYPE_TAG[dtype]}")
    A = (ctypes.c_double * scheme.A.size)(*scheme.A.ravel().tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(dt_b.data_ptr(), y0_c.data_ptr(), par_c.data_ptr(),
                dx_c.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), B, nx, n_steps, scheme.A.shape[0],
                ctypes.addressof(A), float(scheme.gamma), int(newton_iters),
                int(n_phase1), int(R), int(Fr), int(ni_p), stream)
    if rc != 0:
        raise RuntimeError(f"sdirk_solve kernel launch failed: cudaError {rc}")
    LAUNCHES[(model, dtype)] += 1
    ROWS[(model, dtype)] += B
    return out[0].T, out[1].T, out[2].T


def occupancy(model, dtype, nx):
    """The occupancy of the kernel design a call on an nx-cell grid
    launches, from the CUDA occupancy API: dict of blocks_per_sm (blocks,
    each one simulation, that one SM holds at once), threads and
    smem_bytes per block. At nx=128: std float 3 blocks of 128 threads,
    traps float 2; the double instantiations 1 block of NC x 128. Needs
    the card (builds the library)."""
    lib = kernel_library().lib
    fn = getattr(lib, f"metrotrpl_sdirk_occupancy_{model}_{_DTYPE_TAG[dtype]}")
    blocks, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn(int(nx), ctypes.byref(blocks), ctypes.byref(threads),
            ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"sdirk_solve occupancy query failed: cudaError "
                           f"{rc}")
    return {"blocks_per_sm": blocks.value, "threads": threads.value,
            "smem_bytes": smem.value}


# ---- the work of one call, for the kernel's bound ----
#
# FLOPs (+, -, *, /; negations and comparisons not counted) that one
# simulation needs. The block algebra (I - hg*J, the PCR factor and apply
# levels) is counted on the non-zero entries of each block: the pattern
# comes from the model's own Jacobian (JAC_PLANES) and is carried through
# the PCR levels, and a cell whose partner at the level's shift lies
# outside the grid does no work there. The per-cell arithmetic below was
# counted from csrc/sdirk_solve.cuh and .cu, each cell's derived
# densities once per pass; an edit of that arithmetic must update it.
_CELL_FLOPS = {
    # rhs: make_cell 8, edge currents 21, rhs_cell 16 (+ trap exchange 9);
    # jac: make_cell 8, edge Jacobian 36, jac_cell 62 (+ trap entries 6);
    # emit: make_cell 8, the TRTS term 3, the two block sums 2
    "std": dict(rhs=45, jac=106, emit=13),
    "traps": dict(rhs=54, jac=112, emit=13),
}
#: FLOPs of the kernel's closed-form block inverses: inv3 by cofactors;
#: inv4 by the Schur complement (two inv2 of 8, six 2x2 products of 12,
#: eight adds)
_INV_FLOPS = {3: 42, 4: 96}


def _mm_flops(a, b):
    """FLOPs of the product of two blocks with non-zero patterns a and b:
    a multiply per pair of non-zeros, one add fewer per output entry."""
    k = a.astype(int) @ b.astype(int)
    return int((2 * k - 1)[k > 0].sum())


def _mm_pattern(a, b):
    return (a.astype(int) @ b.astype(int)) > 0


def jacobian_pattern(model):
    """Non-zero patterns (L, D, U), boolean C x C, of one cell's Jacobian
    blocks: the entries of JAC_PLANES[model] that are not zero at a
    random state."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return 0.5 + torch.rand(*shape, generator=g, dtype=torch.float64)

    p = ScaledParams(*(rnd(1, 1) for _ in ScaledParams._fields))
    y = tuple(rnd(1, 8) for _ in range(N_COMP[model]))
    return tuple(np.array([[bool((e != 0).any()) for e in row]
                           for row in blk])
                 for blk in JAC_PLANES[model](y, p))


def pcr_patterns(model, nx):
    """Per PCR level of an nx-cell grid: (shift, alpha, beta, L, U), the
    non-zero patterns of the level's update operators and of the L and U
    blocks it reads (``ops.blocktridiag.pcr_factor``'s recursion on
    patterns; the inverse of a block is taken as full)."""
    L, _, U = jacobian_pattern(model)
    full = np.ones_like(L)
    levels, s = [], 1
    for _ in range(n_pcr_levels(nx)):
        alpha, beta = _mm_pattern(L, full), _mm_pattern(U, full)
        levels.append((s, alpha, beta, L, U))
        L, U = _mm_pattern(alpha, L), _mm_pattern(beta, U)
        s *= 2
    return levels


def factor_flops(model, nx):
    """FLOPs of one PCR factorization of I - hg*J(y) over nx cells: the
    Jacobian, the Newton matrix, and per level the block inverses,
    alpha = -L Dinv(i-s) and beta = -U Dinv(i+s) on the cells with that
    partner, their products with the partners' L and U, and the sums into
    D; then the final inverse."""
    C = N_COMP[model]
    inv = _INV_FLOPS[C]
    jl, jd, ju = jacobian_pattern(model)
    full = np.ones_like(jd)
    fl = nx * (_CELL_FLOPS[model]["jac"] + int(jl.sum() + jd.sum()
                                               + ju.sum()) + C)
    for s, alpha, beta, L, U in pcr_patterns(model, nx):
        m = nx - s              # cells with a partner at -s (as many at +s)
        m2 = max(nx - 2 * s, 0)  # cells whose next L (or U) is non-zero
        fl += nx * inv
        fl += m * (_mm_flops(L, full) + _mm_flops(U, full))
        fl += m * (_mm_flops(alpha, U) + int(_mm_pattern(alpha, U).sum())
                   + _mm_flops(beta, L) + int(_mm_pattern(beta, L).sum()))
        fl += m2 * (_mm_flops(alpha, L) + _mm_flops(beta, U))
    return fl + nx * inv


def apply_flops(model, nx):
    """FLOPs of one PCR apply over nx cells: per level the two mat-vecs
    with alpha and beta on the cells with a partner and their sums into
    b; then the final mat-vec with the full D^-1."""
    C = N_COMP[model]
    fl = 0
    for s, alpha, beta, _, _ in pcr_patterns(model, nx):
        for a in (alpha, beta):
            r = a.sum(axis=1)
            fl += (nx - s) * int((2 * r - 1)[r > 0].sum() + (r > 0).sum())
    return fl + nx * C * (2 * C - 1)


def solve_flops(model, nx, n_steps, scheme_name="sdirk3", newton_iters=2,
                refactor_every=1, n_ramp=None, ramp_block=1,
                newton_plateau=None):
    """FLOPs of one simulation through :func:`integrate_observables_cuda`
    with these arguments: every factorization of the plan's chord phases,
    every Newton iteration (RHS, residual, apply, damped update), the
    stage bookkeeping and the observables at every knot."""
    C = N_COMP[model]
    cell = _CELL_FLOPS[model]
    A = SDIRK_SCHEMES[scheme_name].A
    ramp, R, Fr, ni_p = _normalize_chord(n_steps, refactor_every, n_ramp,
                                         ramp_block, newton_iters,
                                         newton_plateau)
    n_phase1 = n_steps if ramp is None else ramp
    fac, app = factor_flops(model, nx), apply_flops(model, nx)
    n_st = A.shape[0]
    read_later = [bool((A[st + 1:, st] != 0).any()) for st in range(n_st)]
    fl = nx * cell["emit"]
    for steps, block, ni in ((n_phase1, R, newton_iters),
                             (n_steps - n_phase1, Fr, ni_p)):
        step = nx * cell["emit"]
        for st in range(n_st):
            step += nx * 2 * C * int((A[st, :st] != 0).sum())   # stage sum
            if A[st, st] == 0:                # explicit first stage
                step += nx * cell["rhs"]
                continue
            # RHS, G = Y - hg*f - acc, apply, d = scale*d, Y -= d
            step += ni * (nx * (cell["rhs"] + 5 * C) + app)
            step += nx * 2 * C * read_later[st]    # f = (Y - acc) / hg
        fl += steps * step + -(-steps // block) * fac
    return fl
