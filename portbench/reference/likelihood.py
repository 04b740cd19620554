"""The tempered Gaussian log-likelihood of parameter states, in plain
PyTorch, worked out from the configuration file and the raw data files
alone.

Per state and measurement: the TRPL curve on the fast plan, the
escalation ladder (rows whose fast solve failed, whose Newton update is
pinned at the damping cap or over the divergence threshold, or whose
mobility is over 40 cm^2/(V s) and whose fast curve lies within the gate
of the data, are solved again on the chord-free rung plan), the optional
IRF convolution (resample at half the IRF step, the moment convolution,
the shift to the convolved peak, re-interpolation), the negative-value
tolerance, and

    ll(T) = -sum_t (log10 PL + shift - log10 y)^2 / (sigma^2 T + 2 u^2).

The precisions of the fast solve, of the rung and of the comparison are
arguments, so that the same code gives the reference and its
lower-precision control.
"""

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import models, solver

#: mobility trigger of the rung, model units (40 cm^2/(V s))
MU_TRIGGER = 40.0 * 1e5
#: the rung repairs a gated flag only when the fast curve's mean squared
#: log10 distance to the data is below this [decades^2]
GATE_SCORE = 0.25
#: a solve whose curve is negative at this share of its valid points fails
NEGATIVE_FRAC_TOL = 0.2

_RAW = ("n0", "p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Sf", "Sb", "tauN",
        "tauP", "eps", "Tm")


def load_curves(path, time_cutoff, log_y=True):
    """(times, vals, uncs): per measurement, rows of a (t, y, u) CSV
    split at every t = 0, cut to the time window, and with log_y the
    log10 of |y| and u / (|y| ln 10)."""
    data = np.atleast_2d(np.loadtxt(path, delimiter=",", comments="#"))
    t, y, u = data[:, 0], data[:, 1], data[:, 2]
    starts = list(np.nonzero(t == 0)[0]) + [len(t)]
    out = ([], [], [])
    for lo, hi in zip(starts[:-1], starts[1:]):
        tt, yy, uu = t[lo:hi], y[lo:hi], u[lo:hi]
        keep = slice(np.searchsorted(tt, time_cutoff[0], side="left"),
                     np.searchsorted(tt, time_cutoff[1], side="right"))
        tt, yy, uu = tt[keep], yy[keep], uu[keep]
        if log_y:
            ya = np.maximum(np.abs(yy), np.finfo(np.float64).tiny)
            uu = uu / ya / np.log(10)
            yy = np.log10(ya)
        out[0].append(tt)
        out[1].append(yy)
        out[2].append(uu)
    return out


class Setup(NamedTuple):
    """Everything the reference needs of one configuration."""
    names: tuple
    units: np.ndarray         # (P,) entry -> model units
    temps: np.ndarray         # (K,) the chain ladder
    sigma: np.ndarray         # (M,)
    times: np.ndarray         # (M, nt) padded
    vals: np.ndarray
    uncs: np.ndarray
    mask: np.ndarray
    init_dN: np.ndarray       # (M, nx) [nm^-3]
    fast: solver.Plan
    rung: solver.Plan
    irf: object               # None, or (table (nk, 3), dt_irf)
    cfg: dict


def irf_table(path):
    """The moment table (nk, 3) of an IRF CSV (t, f) and its step."""
    a = np.loadtxt(path, delimiter=",", comments="#")
    t, f = a[:, 0], a[:, 1]
    dt = float(np.mean(np.diff(t)))
    table = np.zeros((len(f), 3))
    table[:-1, 0] = dt * (f[1:] + f[:-1]) / 2
    table[:-1, 1] = dt * (f[:-1] - f[1:]) / 12
    table[:-1, 2] = dt * (f[1:] + f[:-1]) / 24
    return table, dt


def load_setup(cfg, data_path=None, root=None):
    """The Setup of a configuration: its file, or its parsed dict with the
    directory its paths are relative to (``root``, by default the
    file's ``portbench/``); ``data_path`` replaces the measurement file
    it names (the synthesised curves)."""
    if not isinstance(cfg, dict):
        root = root or Path(cfg).resolve().parents[1]
        cfg = json.loads(Path(cfg).read_text())
    root = Path(root)
    sim, pinfo, meas, mc = (cfg["simPar"], cfg["param_info"],
                            cfg["meas_fields"], cfg["MCMC_fields"])
    cut = [float(x) for x in meas["time_cutoff"]]
    times, vals, uncs = load_curves(
        data_path or root / mc["measurement_path"], cut, bool(mc["log_y"]))
    M = sim["num_meas"]
    nt = max(len(t) for t in times)
    T = np.zeros((M, nt))
    V = np.zeros((M, nt))
    U = np.ones((M, nt))
    K = np.zeros((M, nt), dtype=bool)
    for m in range(M):
        k = len(times[m])
        T[m, :k], V[m, :k], U[m, :k], K[m, :k] = (times[m], vals[m],
                                                  uncs[m], True)
        T[m, k:] = times[m][-1] + 1.0 + np.arange(nt - k)
    nx = int(sim["nx"][0])
    hmax = float(mc["hmax"])
    fast = solver.make_plan(sim["lengths"], nx, times, hmax,
                            refactor_every=int(mc.get("refactor_every", 1)),
                            ramp_block=int(mc.get("ramp_block", 1)))
    rung = solver.make_plan(sim["lengths"], nx, times, min(hmax, 16.0))
    ic = np.atleast_2d(np.loadtxt(root / mc["init_cond_path"],
                                  delimiter=","))
    if mc["ini_mode"] == "fluence":
        x = torch.as_tensor(fast.x_centers)
        init = models.beer_lambert(
            torch.as_tensor(ic[:, :1] * 1e-14), torch.as_tensor(
                ic[:, 1:2] * 1e-7), x, torch.as_tensor(ic[:, 2:3])).numpy()
    else:
        init = ic * 1e-21
    irf = None
    if mc.get("irf_convolution"):
        w = {int(v) for v in mc["irf_convolution"]}
        if len(w) != 1:
            raise ValueError("one IRF table for every measurement")
        irf = irf_table(root / cfg["irf_files"][str(w.pop())])
    names = tuple(pinfo["names"])
    return Setup(
        names=names,
        units=np.array([pinfo["unit_conversions"].get(n, 1) for n in names],
                       dtype=float),
        temps=np.asarray(mc["parallel_tempering"], dtype=float),
        sigma=np.full(M, float(mc["model_uncertainty"])),
        times=T, vals=V, uncs=U, mask=K, init_dN=init, fast=fast, rung=rung,
        irf=irf, cfg=cfg)


def _interp1d(xq, x, y):
    """Row-wise linear interpolation, NaN outside [x[0], x[-1]]."""
    n = x.shape[-1]
    idx = torch.clamp(torch.searchsorted(x.contiguous(), xq.contiguous(),
                                         right=True) - 1, 0, n - 2)
    x0, x1 = torch.gather(x, -1, idx), torch.gather(x, -1, idx + 1)
    y0, y1 = torch.gather(y, -1, idx), torch.gather(y, -1, idx + 1)
    out = y0 + (xq - x0) / (x1 - x0) * (y1 - y0)
    oob = (xq < x[..., :1]) | (xq > x[..., -1:])
    return torch.where(oob, math.nan, out)


def _fir(sig, taps):
    """out[b, k] = sum_j taps[j] sig[b, k - j] (one filter for all rows),
    a few rows at a time: a CPU's conv1d unrolls every row's windows
    (rows x points x taps), which at the walk's 170 k points a row takes
    hundreds of GB for a block of states."""
    B, n = sig.shape
    x = F.pad(sig, (taps.shape[0] - 1, 0))[:, None]
    w = torch.flip(taps, dims=(0,))[None, None]
    rows = max(1, 2 ** 27 // (n * taps.shape[0]))
    return torch.cat([F.conv1d(x[i:i + rows], w)[:, 0]
                      for i in range(0, B, rows)])


def irf_stage(setup, sol):
    """(curve on the data grid, valid points, failed rows) of the IRF
    convolution of sol (K * M, nt), rows state-major."""
    table, dt_irf = setup.irf
    M = setup.times.shape[0]
    K = sol.shape[0] // M
    dev, dt = sol.device, sol.dtype
    res = []
    for m in range(M):
        tm = setup.times[m][setup.mask[m]]
        r = np.arange(0, tm[-1] + dt_irf / 4, dt_irf / 2)
        if r[-1] > tm[-1]:
            r[-1] = tm[-1]
        if len(r) % 2 == 0:
            r = r[:-1]
        res.append(r)
    # one grid length for all: shorter grids run on past their end, and
    # only their first (len - 1) / 2 + 1 convolved points count
    R = max(len(r) for r in res)
    R += 1 - R % 2
    n_conv = np.array([(len(r) - 1) // 2 + 1 for r in res])
    res = [np.concatenate([r, r[-1] + (r[-1] - r[-2])
                           * np.arange(1, R - len(r) + 1)]) for r in res]
    res_t = torch.as_tensor(np.stack(res), dtype=dt, device=dev).repeat(K, 1)
    exp_t = torch.as_tensor(setup.times, dtype=dt, device=dev).repeat(K, 1)
    y = torch.nan_to_num(_interp1d(res_t, exp_t, sol), nan=0.0)
    tab = torch.as_tensor(table, dtype=dt, device=dev)
    i0 = y[:, 1::2]
    i1 = y[:, 2::2] - y[:, :-1:2]
    i2 = 2 * (y[:, 2::2] - 2 * y[:, 1::2] + y[:, :-1:2])
    h = _fir(i0, tab[:, 0]) + _fir(i1, tab[:, 1]) + _fir(i2, tab[:, 2])
    conv = torch.cat([torch.zeros_like(h[:, :1]), h], dim=1)
    conv_t = res_t[:, ::2]
    nc = torch.as_tensor(n_conv, device=dev).repeat(K)
    inside = torch.arange(conv.shape[1], device=dev)[None] < nc[:, None]
    shift_i = torch.argmax(torch.where(inside, conv, -math.inf), dim=1)
    t_shift = torch.gather(conv_t, 1, shift_i[:, None])
    t_last = torch.gather(conv_t, 1, (nc - 1)[:, None])
    fail = (t_last - t_shift)[:, 0] <= 0.0
    out = _interp1d(exp_t, conv_t - t_shift, conv)
    valid = exp_t < (t_last - t_shift)
    return out, valid, fail


def _expand(setup, states, dev, dtype):
    """(init_dN (K*M, nx), raw name -> (K*M,)) of K entry-unit states."""
    K = states.shape[0]
    M = setup.init_dN.shape[0]
    st = torch.as_tensor(states, dtype=torch.float64, device=dev)
    ms = st * torch.as_tensor(setup.units, device=dev)[None]
    raw = {n: torch.repeat_interleave(ms[:, i], M).to(dtype)
           for i, n in enumerate(setup.names) if n in _RAW}
    init = torch.as_tensor(setup.init_dN, dtype=dtype, device=dev).repeat(
        K, 1)
    return init, raw


def _solve(setup, init, raw, meas, plan, dtype, cmp_dtype):
    sol, resid = solver.solve_trpl(init, raw, meas, plan, dtype)
    return sol.to(cmp_dtype), resid.to(cmp_dtype)


def _flags(setup, sol, resid, raw, K, tiny4):
    """Per row: (static failure, residual pinned at the damping cap,
    residual over the divergence threshold, mobility trigger, gate)."""
    dev, dt = sol.device, sol.dtype
    vals = torch.as_tensor(setup.vals, dtype=dt, device=dev).repeat(K, 1)
    mask = torch.as_tensor(setup.mask, device=dev).repeat(K, 1)
    ok = mask & torch.isfinite(sol) & (sol > 10 * tiny4)
    ls = torch.log10(torch.clamp(torch.abs(sol), min=tiny4))
    err2 = torch.where(ok, (ls - vals) ** 2, 0.0)
    score = torch.sum(err2, dim=-1) / torch.clamp(torch.sum(ok, dim=-1),
                                                  min=1)
    gate = (score < GATE_SCORE) | (setup.irf is not None)
    static = (~torch.all(torch.isfinite(sol), dim=-1)
              | torch.any(sol <= tiny4, dim=-1))
    tol = 0.5 if setup.fast.nx >= 96 else (0.1 if setup.fast.nx <= 64
                                           else 0.3)
    pinned = ~(resid < 0.97 * solver.NEWTON_DAMP)
    over = ~(resid < tol)
    mu = torch.maximum(raw["mu_n"], raw["mu_p"])
    return static, pinned, over, mu > MU_TRIGGER, gate


def _conceded(sol, flags, gate):
    """The curve with the rows the ladder gives up on set to NaN: by the
    flags of this curve's solve and the gate of the fast solve."""
    static, pinned, over, _, _ = flags
    bad = static | pinned | (over & gate)
    return torch.where(bad[:, None], math.nan, sol)


def _compare(setup, sol, K, temps):
    """Per-row ll (K * M, len(temps)) of the curves sol (K * M, nt)."""
    dev, dt = sol.device, sol.dtype
    M = setup.times.shape[0]

    def t(a, d=dt):
        return torch.as_tensor(np.asarray(a), dtype=d, device=dev)

    vals = t(setup.vals).repeat(K, 1)
    mask = t(setup.mask, torch.bool).repeat(K, 1)
    if setup.irf is not None:
        sol, irf_valid, fail = irf_stage(setup, sol)
        valid = irf_valid & mask
    else:
        valid = mask
        fail = torch.zeros(K * M, dtype=torch.bool, device=dev)
    n_valid = torch.sum(valid, dim=1)
    n_neg = torch.sum((sol < 0) & valid, dim=1)
    fail = fail | (n_neg >= NEGATIVE_FRAC_TOL * n_valid) | (n_valid == 0)
    err2 = torch.where(valid, (torch.log10(torch.abs(sol)) - vals) ** 2, 0.0)
    sig2 = t(setup.sigma).repeat(K) ** 2
    uncs2 = 2.0 * t(setup.uncs).repeat(K, 1) ** 2
    tt = t(temps)
    ll = -torch.sum(err2[:, :, None] / (sig2[:, None, None] * tt[None, None]
                                        + uncs2[:, :, None]), dim=1)
    return torch.where(torch.isnan(ll) | fail[:, None], -math.inf, ll)


def _blocks(fn, states, block):
    out = [fn(states[lo:lo + block]) for lo in range(0, len(states), block)]
    return [np.concatenate(parts) for parts in zip(*out)]


def loglik(setup, states, temps, fast_dtype=torch.float64,
           rung_dtype=torch.float64, cmp_dtype=torch.float64, device="cpu",
           block=64):
    """ll (K, len(temps)) of entry-unit states (K, P) through the whole
    ladder, worked out ``block`` states at a time; and the count of rows
    the ladder sent to the rung."""
    temps = np.asarray(temps, dtype=np.float64)

    def one(st):
        K = st.shape[0]
        M = setup.init_dN.shape[0]
        meas = torch.arange(K * M, device=device) % M
        init, raw = _expand(setup, st, device, torch.float64)
        sol, resid = _solve(setup, init, raw, meas, setup.fast, fast_dtype,
                            cmp_dtype)
        tiny4 = 4 * float(torch.finfo(fast_dtype).tiny)
        static, pinned, over, mu, gate = _flags(setup, sol, resid, raw, K,
                                                tiny4)
        repair = static | pinned | ((over | mu) & gate)
        rows = torch.nonzero(repair).flatten()
        if rows.numel():
            s_hi, r_hi = _solve(setup, init[rows],
                                {k: v[rows] for k, v in raw.items()},
                                meas[rows], setup.rung, rung_dtype, cmp_dtype)
            sol = sol.index_copy(0, rows, s_hi)
            resid = resid.index_copy(0, rows, r_hi)
        flags = _flags(setup, sol, resid, raw, K, tiny4)
        ll = _compare(setup, _conceded(sol, flags, gate), K, temps)
        ll = ll.reshape(K, M, -1).sum(dim=1)
        return (ll.to(torch.float64).cpu().numpy(),
                np.array([rows.numel()]))

    ll, n = _blocks(one, np.asarray(states, dtype=np.float64), block)
    return ll, int(n.sum())
