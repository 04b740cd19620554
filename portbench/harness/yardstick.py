"""The yardstick, frozen: the operations and bytes one simulation of the
std model needs on a solve plan, and the H100's peaks.

Operations (+, -, *, /) are counted on the Jacobian's non-zero pattern,
carried through the PCR levels: per step the stage sums, per Newton
iteration the right-hand side, the residual, the PCR apply and the damped
update, per chord block one factorization (the Jacobian, I - h gamma J,
per level the block inverses and the alpha / beta products), and the
observables at every knot. Bytes: each input read once and each output
written once (step sizes, the initial state, 17 parameters, dx, and the
PL, TRTS and residual at every knot). These are copies of the counts the
port kept beside its kernel when this benchmark was written; the
per-cell table was counted from that kernel's source.
"""

import math

import numpy as np
import torch

from portbench.reference import models
from portbench.reference.solver import SDIRK3_A

#: NVIDIA H100 SXM, data sheet, at its 700 W limit: non-tensor-core
#: FLOP/s per scalar size in bytes (float32, float64), and HBM bytes/s
PEAK_FLOPS = {4: 67e12, 8: 34e12}
PEAK_BYTES = 3.35e12

#: FLOPs per cell and pass: the RHS, the Jacobian, the observables
CELL_FLOPS = dict(rhs=45, jac=106, emit=13)
#: FLOPs of the closed-form 3x3 inverse
INV_FLOPS = 42
C = 3


def _mm_flops(a, b):
    k = a.astype(int) @ b.astype(int)
    return int((2 * k - 1)[k > 0].sum())


def _mm_pattern(a, b):
    return (a.astype(int) @ b.astype(int)) > 0


def jacobian_pattern():
    """Non-zero patterns (L, D, U) of one cell's 3x3 Jacobian blocks."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return 0.5 + torch.rand(*shape, generator=g, dtype=torch.float64)

    p = models.ScaledParams(*(rnd(1, 1) for _ in models.ScaledParams._fields))
    y = tuple(rnd(1, 8) for _ in range(C))
    return tuple(np.array([[bool((e != 0).any()) for e in row]
                           for row in blk])
                 for blk in models.jacobian(y, p))


def pcr_patterns(nx):
    L, _, U = jacobian_pattern()
    full = np.ones_like(L)
    levels, s = [], 1
    for _ in range(int(math.ceil(math.log2(nx))) if nx > 1 else 0):
        alpha, beta = _mm_pattern(L, full), _mm_pattern(U, full)
        levels.append((s, alpha, beta, L, U))
        L, U = _mm_pattern(alpha, L), _mm_pattern(beta, U)
        s *= 2
    return levels


def factor_flops(nx):
    jl, jd, ju = jacobian_pattern()
    full = np.ones_like(jd)
    fl = nx * (CELL_FLOPS["jac"] + int(jl.sum() + jd.sum() + ju.sum()) + C)
    for s, alpha, beta, L, U in pcr_patterns(nx):
        m = nx - s
        m2 = max(nx - 2 * s, 0)
        fl += nx * INV_FLOPS
        fl += m * (_mm_flops(L, full) + _mm_flops(U, full))
        fl += m * (_mm_flops(alpha, U) + int(_mm_pattern(alpha, U).sum())
                   + _mm_flops(beta, L) + int(_mm_pattern(beta, L).sum()))
        fl += m2 * (_mm_flops(alpha, L) + _mm_flops(beta, U))
    return fl + nx * INV_FLOPS


def apply_flops(nx):
    fl = 0
    for s, alpha, beta, _, _ in pcr_patterns(nx):
        for a in (alpha, beta):
            r = a.sum(axis=1)
            fl += (nx - s) * int((2 * r - 1)[r > 0].sum() + (r > 0).sum())
    return fl + nx * C * (2 * C - 1)


def solve_flops(plan):
    """FLOPs of one simulation on a reference solver.Plan (sdirk3)."""
    nx, n_steps = plan.nx, plan.n_steps
    A = SDIRK3_A
    ni = plan.newton_iters
    if plan.n_ramp is None:
        phases = ((n_steps, 1),)
    else:
        phases = ((plan.n_ramp, plan.ramp_block),
                  (n_steps - plan.n_ramp, plan.refactor_every))
    fac, app = factor_flops(nx), apply_flops(nx)
    read_later = [bool((A[st + 1:, st] != 0).any()) for st in range(3)]
    fl = nx * CELL_FLOPS["emit"]
    for steps, block in phases:
        step = nx * CELL_FLOPS["emit"]
        for st in range(3):
            step += nx * 2 * C * int((A[st, :st] != 0).sum())
            step += ni * (nx * (CELL_FLOPS["rhs"] + 5 * C) + app)
            step += nx * 2 * C * read_later[st]
        fl += steps * step + -(-steps // block) * fac
    return fl


def solve_bytes(plan, size):
    """Bytes one simulation reads and writes at ``size`` bytes a scalar."""
    n = plan.n_steps
    return size * (n + C * plan.nx + 17 + 1 + 3 * (n + 1))


def least_seconds(plan, size, rows):
    """The least time ``rows`` simulations on ``plan`` could take: the
    larger of their operations over the peak rate and their bytes over
    the memory rate."""
    return rows * max(solve_flops(plan) / PEAK_FLOPS[size],
                      solve_bytes(plan, size) / PEAK_BYTES)
