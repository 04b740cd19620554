"""Fixed-step SDIRK3 integration of the std model in plain PyTorch, with
the Newton matrix factored by parallel cyclic reduction (PCR) and shared
by the stages and, in chord mode, by a block of steps.

A frozen copy of the plain version the port keeps beside its solve
kernel, in the sdirk fast mode both configurations run: the step plan (a
geometric ramp from h0, then steps capped at hmax, outputs interpolated
between knots), the trust-region-damped modified Newton iteration, and
the chord phases.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import models

_G3 = 0.435866521508458999416019
#: sdirk3's Butcher matrix and diagonal coefficient
SDIRK3_A = np.array([
    [_G3, 0.0, 0.0],
    [(1 - _G3) / 2, _G3, 0.0],
    [-1.5 * _G3 ** 2 + 4 * _G3 - 0.25, 1.5 * _G3 ** 2 - 5 * _G3 + 1.25, _G3],
])
GAMMA = _G3
#: the cap on every row's max |Newton update| (the state is O(1))
NEWTON_DAMP = 2.0


# ---- the step plan (host numpy) ----

def time_grid(t_out, hmax, h0=1e-3, growth=1.25, ramp_block=1):
    """(dt (n,), out_idx (nt,), out_w (nt,)): solver steps over [0,
    t_out[-1]] (a geometric ramp from h0, then steps of at most hmax) and,
    per output time, its left knot and the right knot's weight."""
    t_out = np.asarray(t_out, dtype=np.float64)
    t_final = float(t_out[-1])
    ramp = [0.0]
    h = h0
    lvl_growth = growth ** int(ramp_block)
    while h < hmax and ramp[-1] + h < t_final:
        for _ in range(int(ramp_block)):
            if ramp[-1] + h >= t_final:
                break
            ramp.append(ramp[-1] + h)
        h = h * lvl_growth
    base = np.unique(np.concatenate([[0.0, t_final], ramp[1:]]))
    knots = [base[0]]
    for a, b in zip(base[:-1], base[1:]):
        n_sub = max(int(np.ceil((b - a) / hmax)), 1)
        step = (b - a) / n_sub
        for s in range(1, n_sub + 1):
            knots.append(a + step * s)
    t_solver = np.array(knots)
    out_idx = np.clip(np.searchsorted(t_solver, t_out, side="right") - 1,
                      0, len(t_solver) - 2)
    span = t_solver[out_idx + 1] - t_solver[out_idx]
    out_w = np.clip((t_out - t_solver[out_idx]) / span, 0.0, 1.0)
    return np.diff(t_solver), out_idx, out_w


class Plan(NamedTuple):
    """The solve plan of a group of measurements sharing nx."""
    nx: int
    n_steps: int
    dx: np.ndarray          # (M,)
    x_centers: np.ndarray   # (M, nx)
    dt: np.ndarray          # (M, n_steps)
    out_idx: np.ndarray     # (M, nt)
    out_w: np.ndarray       # (M, nt)
    n_ramp: object          # chord phase boundary, or None
    refactor_every: int
    ramp_block: int
    newton_iters: int = 2


def make_plan(lengths, nx, times_list, hmax, refactor_every=1,
              ramp_block=1):
    """The plan of measurements of thicknesses ``lengths`` [nm] and output
    times ``times_list``, padded to one step count and output count."""
    grids = [time_grid(t, hmax, ramp_block=ramp_block) for t in times_list]
    n_steps = max(len(g[0]) for g in grids)
    nt = max(len(g[1]) for g in grids)
    n_ramp = None
    if refactor_every > 1 or ramp_block > 1:
        dtm = np.stack([np.concatenate(
            [g[0], np.full(n_steps - len(g[0]), g[0][-1])]) for g in grids])
        changed = np.abs(np.diff(dtm, axis=1)) > 1e-12 * dtm[:, 1:]
        any_changed = np.any(changed, axis=0)
        n_ramp = (int(np.max(np.nonzero(any_changed)[0])) + 2
                  if any_changed.any() else 0)
        if n_ramp >= n_steps:
            n_ramp, ramp_block = None, 1
        else:
            if ramp_block > 1:
                R = int(ramp_block)
                starts = np.nonzero(any_changed)[0] + 1
                n_ramp_b = n_ramp + (-n_ramp) % R
                if np.all(starts % R == 0) and n_ramp_b <= n_steps:
                    n_ramp = n_ramp_b
                else:
                    ramp_block = 1
            n_steps += (-(n_steps - n_ramp)) % int(refactor_every)
    dts, idxs, ws = [], [], []
    for dt, oi, w in grids:
        dts.append(np.concatenate([dt, np.full(n_steps - len(dt), dt[-1])]))
        idxs.append(np.concatenate([oi, np.zeros(nt - len(oi), np.int64)]))
        ws.append(np.concatenate([w, np.zeros(nt - len(w))]))
    dx = np.array([th / nx for th in lengths])
    xc = np.stack([np.linspace(d / 2, th - d / 2, nx)
                   for d, th in zip(dx, lengths)])
    chord = n_ramp is not None
    return Plan(nx=int(nx), n_steps=int(n_steps), dx=dx, x_centers=xc,
                dt=np.stack(dts), out_idx=np.stack(idxs), out_w=np.stack(ws),
                n_ramp=n_ramp,
                refactor_every=int(refactor_every) if chord else 1,
                ramp_block=int(ramp_block) if chord else 1)


# ---- block-tridiagonal algebra on 3x3 blocks of (B, nx) planes ----

def _mm(A, B):
    return tuple(tuple(A[i][0] * B[0][k] + A[i][1] * B[1][k]
                       + A[i][2] * B[2][k] for k in range(3))
                 for i in range(3))


def _mv(A, x):
    return tuple(A[i][0] * x[0] + A[i][1] * x[1] + A[i][2] * x[2]
                 for i in range(3))


def _shift_m(A, s):
    return tuple(tuple(models.shift(a, s) for a in row) for row in A)


def _shift_v(x, s):
    return tuple(models.shift(a, s) for a in x)


def _neg(A):
    return tuple(tuple(-a for a in row) for row in A)


def _add(A, B):
    return tuple(tuple(a + b for a, b in zip(ra, rb)) for ra, rb in zip(A, B))


def _inv3(A):
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


def pcr_factor(L, D, U):
    """Each PCR level's (alpha, beta) operators and the final D^-1."""
    n = L[0][0].shape[-1]
    alphas, betas = [], []
    s = 1
    for _ in range(int(math.ceil(math.log2(n))) if n > 1 else 0):
        Dinv = _inv3(D)
        alpha = _neg(_mm(L, _shift_m(Dinv, s)))
        beta = _neg(_mm(U, _shift_m(Dinv, -s)))
        alphas.append(alpha)
        betas.append(beta)
        L, D, U = (_mm(alpha, _shift_m(L, s)),
                   _add(D, _add(_mm(alpha, _shift_m(U, s)),
                                _mm(beta, _shift_m(L, -s)))),
                   _mm(beta, _shift_m(U, -s)))
        s *= 2
    return alphas, betas, _inv3(D)


def pcr_apply(factors, b):
    alphas, betas, Dinv = factors
    s = 1
    for alpha, beta in zip(alphas, betas):
        lo = _mv(alpha, _shift_v(b, s))
        hi = _mv(beta, _shift_v(b, -s))
        b = tuple(bi + li + hj for bi, li, hj in zip(b, lo, hi))
        s *= 2
    return _mv(Dinv, b)


# ---- the integrator ----

def _maxabs(d):
    out = torch.amax(torch.abs(d[0]), dim=-1)
    for p in d[1:]:
        out = torch.maximum(out, torch.amax(torch.abs(p), dim=-1))
    return out


def _factors(y, h, p):
    hg = h[..., None] * GAMMA
    L, D, U = models.jacobian(y, p)
    MD = tuple(tuple((1.0 - hg * D[i][j]) if i == j else -hg * D[i][j]
                     for j in range(3)) for i in range(3))
    ML = tuple(tuple(-hg * L[i][j] for j in range(3)) for i in range(3))
    MU = tuple(tuple(-hg * U[i][j] for j in range(3)) for i in range(3))
    return pcr_factor(ML, MD, MU)


def _step(y, h, p, factors, newton_iters):
    """One sdirk3 step: (y_next, max |last Newton update| of the row)."""
    hb = h[..., None]
    fs, resid = [], None
    for i in range(3):
        acc = y
        for j in range(i):
            c = float(SDIRK3_A[i, j])
            acc = tuple(a + (hb * c) * f for a, f in zip(acc, fs[j]))
        Y = acc
        for _ in range(newton_iters):
            G = tuple(Yi - hb * GAMMA * ri - ai
                      for Yi, ri, ai in zip(Y, models.rhs(Y, p), acc))
            d = pcr_apply(factors, G)
            dmax = _maxabs(d)
            s = torch.minimum(dmax.new_tensor(1.0),
                              NEWTON_DAMP / torch.maximum(
                                  dmax, dmax.new_tensor(NEWTON_DAMP)))
            d = tuple(s[..., None] * di for di in d)
            Y = tuple(Yi - di for Yi, di in zip(Y, d))
        r = _maxabs(d)
        resid = r if resid is None else torch.maximum(resid, r)
        fs.append(tuple((Yi - ai) / (hb * GAMMA) for Yi, ai in zip(Y, acc)))
    return Y, resid


def integrate(p, y0, dts, dx, plan):
    """Step y0 (3 planes of (B, nx)) over dts (n_steps, B): the scaled
    PL and the Newton residual at every knot, each (n_steps + 1, B)."""
    pl = [models.pl_scaled(y0, p, dx)]
    res = [torch.zeros_like(pl[0])]
    n_steps = dts.shape[0]

    def phase(y, lo, hi, block):
        for k0 in range(lo, hi, block):
            fac = _factors(y, dts[k0], p)
            for k in range(k0, k0 + block):
                y, r = _step(y, dts[k], p, fac, plan.newton_iters)
                pl.append(models.pl_scaled(y, p, dx))
                res.append(r)
        return y

    if plan.n_ramp is None:
        phase(y0, 0, n_steps, 1)
    else:
        y = phase(y0, 0, plan.n_ramp, plan.ramp_block)
        phase(y, plan.n_ramp, n_steps, plan.refactor_every)
    return torch.stack(pl), torch.stack(res)


def _interp_knots(obs, out_idx, w):
    lo = torch.gather(obs, 1, out_idx)
    hi = torch.gather(obs, 1, out_idx + 1)
    lin = lo + w * (hi - lo)
    both_pos = (lo > 0) & (hi > 0)
    safe_lo = torch.where(both_pos, lo, 1.0)
    safe_hi = torch.where(both_pos, hi, 1.0)
    geo = safe_lo * torch.exp(w * torch.log(safe_hi / safe_lo))
    return torch.where(both_pos, geo, lin)


def solve_trpl(init_dN, raw, meas, plan, dtype):
    """TRPL curves [cm^-2 s^-1] of B simulations in ``dtype``: initial
    profiles init_dN (B, nx) [nm^-3], model-unit parameters raw (name ->
    (B,)), each row's measurement index meas (B,) into the plan. Returns
    (sol (B, nt), resid (B,)): the curve, held at the dtype's tiny from
    its first point below it, and the max Newton residual over the knots
    an output reads."""
    dev = init_dN.device
    init_dN = init_dN.to(dtype)
    raw = {k: v.to(dtype) for k, v in raw.items()}

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    dx = t(plan.dx)[meas]
    dts = t(plan.dt)[meas].T.contiguous()
    out_idx = t(plan.out_idx, torch.int64)[meas]
    ns = torch.amax(init_dN, dim=-1) + raw["p0"] + raw["n0"]
    p = models.scaled_params(raw, dx, ns)
    dN0 = init_dN / ns[:, None]
    y0 = (dN0, torch.zeros_like(dN0), torch.zeros_like(dN0))
    pl_t, rs_t = integrate(p, y0, dts, dx, plan)
    pl = _interp_knots(pl_t.T, out_idx, t(plan.out_w)[meas])
    sol = pl * (raw["ks"] * ns * ns * 1e23)[:, None]
    tiny = float(torch.finfo(dtype).tiny)
    below = sol < tiny
    first = torch.argmax(below.to(torch.int32), dim=1)
    clamp = torch.gather(below, 1, first[:, None])
    tail = torch.arange(sol.shape[1], device=dev)[None, :] >= first[:, None]
    sol = torch.where(tail & clamp, tiny, sol)
    kmax = torch.amax(out_idx, dim=1) + 1
    knots = torch.arange(rs_t.shape[0], device=dev)[None, :]
    r = torch.where(knots <= kmax[:, None], rs_t.T, 0.0)
    return sol, torch.amax(r, dim=1)
