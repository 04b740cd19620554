"""Synthesised TRPL curves: the std model at a configuration's truth,
solved by scipy's LSODA in float64 (rtol 1e-7, atol 1e-10, steps of at
most 4 ns), as ``write-example`` makes the unshipped staub dataset.

Plain numpy and scipy; the equations are the reference forward solver's
(N, P and the edge field E, surface recombination at both faces).
"""

import numpy as np
from scipy.integrate import solve_ivp

from portbench.reference.models import EPS0, KB, Q_C


def _rhs(t, y, nx, dx, n0, p0, mu_n, mu_p, ks, Cn, Cp, Sf, Sb, tauN, tauP,
         lam, Tm):
    N, P, E = y[:nx], y[nx:2 * nx], y[2 * nx:]
    NP = N * P - n0 * p0
    Jn = np.zeros(nx + 1)
    Jp = np.zeros(nx + 1)
    s_front = Sf * NP[0] / (N[0] + P[0])
    s_back = Sb * NP[-1] / (N[-1] + P[-1])
    Jn[0], Jn[nx] = s_front, -s_back
    Jp[0], Jp[nx] = -s_front, s_back
    Ne = 0.5 * (N[:-1] + N[1:])
    Pe = 0.5 * (P[:-1] + P[1:])
    Jn[1:-1] = mu_n * Ne * E[1:-1] + mu_n * KB * Tm * np.diff(N) / dx
    Jp[1:-1] = mu_p * Pe * E[1:-1] - mu_p * KB * Tm * np.diff(P) / dx
    R = ((Cn * N + Cp * P) + ks + 1.0 / (tauN * P + tauP * N)) * NP
    dy = np.empty_like(y)
    dy[:nx] = np.diff(Jn) / dx - R
    dy[nx:2 * nx] = -np.diff(Jp) / dx - R
    dy[2 * nx:] = -(Jn + Jp) * lam
    return dy


def trpl_curve(init_dN, thickness, nx, t_out, prm):
    """TRPL [cm^-2 s^-1] at times t_out of one simulation; prm in model
    units (nm, V, ns)."""
    dx = thickness / nx
    n0, p0 = prm["n0"], prm["p0"]
    lam = Q_C / (prm["eps"] * EPS0)
    N = init_dN + n0
    P = init_dN + p0
    E = np.concatenate([[0.0], lam * dx * np.cumsum((P - p0) - (N - n0))])
    args = (nx, dx, n0, p0, prm["mu_n"], prm["mu_p"], prm["ks"], prm["Cn"],
            prm["Cp"], prm["Sf"], prm["Sb"], prm["tauN"], prm["tauP"], lam,
            prm["Tm"])
    sol = solve_ivp(lambda t, y: _rhs(t, y, *args), [t_out[0], t_out[-1]],
                    np.concatenate([N, P, E]), method="LSODA",
                    dense_output=True, max_step=4.0, rtol=1e-7, atol=1e-10)
    data = sol.sol(t_out).T
    data[t_out > sol.t[-1]] = 0.0
    N, P = data[:, :nx], data[:, nx:2 * nx]
    out = dx * (prm["ks"] * (N * P - n0 * p0)).sum(axis=-1) * 1e23
    tiny = np.finfo(np.float64).tiny
    i = np.argmax(out < tiny)
    if out[i] < tiny:
        out[i:] = tiny
    return out


def synthesize(cfg, fluences, path):
    """Write the (t, PL, unc_frac * PL) rows of every measurement of
    configuration ``cfg`` (fluence-mode rows ``fluences``) to ``path``."""
    spec = cfg["synthesize"]
    sim = cfg["simPar"]
    uc = cfg["param_info"]["unit_conversions"]
    prm = {k: float(v) * float(uc.get(k, 1)) for k, v in spec["truth"].items()}
    t = np.linspace(0.0, float(spec["t_end"]), int(spec["nt"]))
    rows = []
    for m, th in enumerate(sim["lengths"]):
        nx = int(sim["nx"][m])
        dx = th / nx
        x = np.linspace(dx / 2, th - dx / 2, nx)
        fl, al, dr = fluences[m]
        prof = fl * 1e-14 * al * 1e-7 * np.exp(-al * 1e-7 * x)
        if dr < 0:
            prof = prof[::-1]
        pl = trpl_curve(prof, th, nx, t, prm)
        rows.append(np.stack([t, pl, float(spec["unc_frac"]) * pl], axis=1))
    np.savetxt(path, np.concatenate(rows), delimiter=",")
