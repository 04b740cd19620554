"""Block-tridiagonal algebra on the plane representation.

PyTorch counterpart of the plane path of ``metrotrpl_tpu/ops/blocktridiag.py``:
a block vector is a tuple of C (..., n) planes and a block matrix a C x C
nested tuple of planes, with the cell axis last. Parallel cyclic reduction
(:func:`pcr_factor` / :func:`pcr_apply`) decouples the system in
ceil(log2 n) sweeps; :func:`thomas_solve` is the sequential block LU kept
as a test oracle.
"""

import math

import torch

from metrotrpl_tpu_torch.physics.models import _shift


def p_mm(A, B):
    """Plane block matmul: C x C nested tuples of (..., n) planes."""
    C = len(A)
    out = []
    for i in range(C):
        row = []
        for k in range(C):
            acc = A[i][0] * B[0][k]
            for j in range(1, C):
                acc = acc + A[i][j] * B[j][k]
            row.append(acc)
        out.append(tuple(row))
    return tuple(out)


def p_mv(A, x):
    """Plane block matvec: nested-tuple matrix times tuple vector."""
    C = len(A)
    out = []
    for i in range(C):
        acc = A[i][0] * x[0]
        for j in range(1, C):
            acc = acc + A[i][j] * x[j]
        out.append(acc)
    return tuple(out)


def p_shift_m(A, s):
    return tuple(tuple(_shift(a, s) for a in row) for row in A)


def p_shift_v(x, s):
    return tuple(_shift(xi, s) for xi in x)


def p_neg(A):
    return tuple(tuple(-a for a in row) for row in A)


def _p_add(A, B):
    return tuple(tuple(a + b for a, b in zip(ra, rb))
                 for ra, rb in zip(A, B))


def p_inv_small(A):
    """Closed-form (unpivoted) inverse of 2x2, 3x3 (std model) and 4x4
    (traps model, by the Schur complement on the 2x2 partition) plane
    blocks, in the JAX twin's operand order — meant for the diagonally
    dominant blocks of I - h*gamma*J."""
    C = len(A)
    if C == 2:
        a, b = A[0]
        c, d = A[1]
        idet = 1.0 / (a * d - b * c)
        return ((d * idet, -b * idet), (-c * idet, a * idet))
    if C == 3:
        c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1]
        c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2]
        c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0]
        c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2]
        c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0]
        c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1]
        c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1]
        c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2]
        c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0]
        idet = 1.0 / (A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02)
        return ((c00 * idet, c10 * idet, c20 * idet),
                (c01 * idet, c11 * idet, c21 * idet),
                (c02 * idet, c12 * idet, c22 * idet))
    if C == 4:
        def sub(r0, c0):
            return tuple(tuple(A[r0 + i][c0 + j] for j in range(2))
                         for i in range(2))
        P, Q, R, S = sub(0, 0), sub(0, 2), sub(2, 0), sub(2, 2)
        Pinv = p_inv_small(P)
        RPinv = p_mm(R, Pinv)
        schur = tuple(tuple(S[i][j] - x for j, x in enumerate(row))
                      for i, row in enumerate(p_mm(RPinv, Q)))
        Sinv = p_inv_small(schur)
        PinvQ = p_mm(Pinv, Q)
        corr = p_mm(p_mm(PinvQ, Sinv), RPinv)
        top_left = tuple(tuple(Pinv[i][j] + corr[i][j] for j in range(2))
                         for i in range(2))
        top_right = p_neg(p_mm(PinvQ, Sinv))
        bot_left = p_neg(p_mm(Sinv, RPinv))
        return tuple(
            [top_left[i] + top_right[i] for i in range(2)]
            + [bot_left[i] + Sinv[i] for i in range(2)])
    raise NotImplementedError(f"p_inv_small: unsupported block size {C}")


def n_pcr_levels(n):
    """Number of PCR sweeps that decouple an n-cell system."""
    return int(math.ceil(math.log2(n))) if n > 1 else 0


def pcr_factor(L, D, U):
    """Run the PCR matrix path once and record each level's (alpha, beta)
    update operators plus the final decoupled D^-1; :func:`pcr_apply`
    reuses them for any number of right-hand sides. L at cell 0 and U at
    cell n-1 must be zero."""
    n = L[0][0].shape[-1]
    alphas, betas = [], []
    s = 1
    for _ in range(n_pcr_levels(n)):
        Dinv = p_inv_small(D)
        alpha = p_neg(p_mm(L, p_shift_m(Dinv, s)))
        beta = p_neg(p_mm(U, p_shift_m(Dinv, -s)))
        alphas.append(alpha)
        betas.append(beta)
        L, D, U = (
            p_mm(alpha, p_shift_m(L, s)),
            _p_add(D, _p_add(p_mm(alpha, p_shift_m(U, s)),
                             p_mm(beta, p_shift_m(L, -s)))),
            p_mm(beta, p_shift_m(U, -s)),
        )
        s *= 2
    return tuple(alphas), tuple(betas), p_inv_small(D)


def pcr_apply(factors, b):
    """Solve M x = b with factors from :func:`pcr_factor`; b is a tuple of
    C (..., n) planes."""
    alphas, betas, Dinv_final = factors
    s = 1
    for alpha, beta in zip(alphas, betas):
        lo = p_mv(alpha, p_shift_v(b, s))
        hi = p_mv(beta, p_shift_v(b, -s))
        b = tuple(bi + li + hj for bi, li, hj in zip(b, lo, hi))
        s *= 2
    return p_mv(Dinv_final, b)


def pcr_solve(L, D, U, b):
    """One-shot PCR solve (the same sweep the integrator runs)."""
    return pcr_apply(pcr_factor(L, D, U), b)


def thomas_solve(L, D, U, b):
    """Sequential block LU solve over the cells (test oracle).

    Plane layout like :func:`pcr_solve`; loops over cells in Python."""
    C = len(D)
    n = D[0][0].shape[-1]

    def cell(A, i):
        return tuple(tuple(a[..., i] for a in row) for row in A)

    Cs, ds = [], []
    C_prev = tuple(tuple(torch.zeros_like(D[0][0][..., 0]) for _ in range(C))
                   for _ in range(C))
    d_prev = tuple(torch.zeros_like(b[0][..., 0]) for _ in range(C))
    for i in range(n):
        Li, Di, Ui = cell(L, i), cell(D, i), cell(U, i)
        bi = tuple(x[..., i] for x in b)
        LC = p_mm(Li, C_prev)
        denom = p_inv_small(tuple(tuple(Di[r][c] - LC[r][c] for c in range(C))
                                  for r in range(C)))
        C_prev = p_mm(denom, Ui)
        Ld = p_mv(Li, d_prev)
        d_prev = p_mv(denom, tuple(x - y for x, y in zip(bi, Ld)))
        Cs.append(C_prev)
        ds.append(d_prev)
    xs = [None] * n
    x_next = tuple(torch.zeros_like(d) for d in ds[-1])
    for i in reversed(range(n)):
        Cx = p_mv(Cs[i], x_next)
        x_next = tuple(d - c for d, c in zip(ds[i], Cx))
        xs[i] = x_next
    return tuple(torch.stack([x[c] for x in xs], dim=-1) for c in range(C))
