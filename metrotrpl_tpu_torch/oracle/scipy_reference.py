"""Reference-math CPU oracle: stiff LSODA solve of the carrier models.

Implements the same physics equations as the reference forward solver
(reference forward_solver.py:26-38 E-field init, :277-329 std RHS,
:374-418 traps RHS, :41-225 solve routine) in vectorized float64 numpy with
scipy ``solve_ivp``. Used as ground truth for the TPU stepper's accuracy
tests and as the measured CPU baseline for the benchmark. Copy of
``metrotrpl_tpu/oracle/scipy_reference.py``; its ``rhs="native"`` std RHS
is the port's ``runtime/refrhs.cpp``.

Internal units: nm, V, ns (same convention as the reference).
"""

import numpy as np
from scipy.integrate import solve_ivp

from metrotrpl_tpu_torch.constants import DEFAULT_ATOL, DEFAULT_RTOL, eps0, kB, q_C


def efield_init(N, P, n0, p0, eps, dx, corner_E=0.0):
    """Initial electric field from the charge-separation integral
    (Gauss's law with E(0) = corner_E)."""
    rho = (P - p0) - (N - n0)
    E = corner_E + q_C / (eps * eps0) * dx * np.cumsum(rho, axis=-1)
    pad = np.full(E.shape[:-1] + (1,), corner_E)
    return np.concatenate([pad, E], axis=-1)


def _currents(N, P, E, mu_n, mu_p, Sf, Sb, Tm, dx, n0, p0):
    """Electron/hole current densities at the nx+1 cell edges, including
    surface-recombination boundary fluxes."""
    nx = N.shape[-1]
    Jn = np.zeros(nx + 1)
    Jp = np.zeros(nx + 1)

    NP = N * P - n0 * p0
    s_front = Sf * NP[0] / (N[0] + P[0])
    s_back = Sb * NP[-1] / (N[-1] + P[-1])
    Jn[0], Jn[nx] = s_front, -s_back
    Jp[0], Jp[nx] = -s_front, s_back

    N_edge = 0.5 * (N[:-1] + N[1:])
    P_edge = 0.5 * (P[:-1] + P[1:])
    Dn = mu_n * kB * Tm
    Dp = mu_p * kB * Tm
    Jn[1:-1] = mu_n * N_edge * E[1:-1] + Dn * np.diff(N) / dx
    Jp[1:-1] = mu_p * P_edge * E[1:-1] - Dp * np.diff(P) / dx
    return Jn, Jp


def _recombination(N, P, n0, p0, ks, Cn, Cp, tauN, tauP):
    """Auger + radiative + bulk SRH recombination rate."""
    NP = N * P - n0 * p0
    return ((Cn * N + Cp * P) + ks + 1.0 / (tauN * P + tauP * N)) * NP


def dydt_std(t, y, nx, dx, n0, p0, mu_n, mu_p, ks, Cn, Cp, Sf, Sb,
             tauN, tauP, lam, Tm):
    """RHS of the standard model. y = [N (nx), P (nx), E (nx+1)];
    lam = q_C / (eps * eps0)."""
    N = y[:nx]
    P = y[nx:2 * nx]
    E = y[2 * nx:]

    Jn, Jp = _currents(N, P, E, mu_n, mu_p, Sf, Sb, Tm, dx, n0, p0)
    R = _recombination(N, P, n0, p0, ks, Cn, Cp, tauN, tauP)

    dy = np.empty_like(y)
    dy[:nx] = np.diff(Jn) / dx - R
    dy[nx:2 * nx] = -np.diff(Jp) / dx - R
    dy[2 * nx:] = -(Jn + Jp) * lam
    return dy


def dydt_traps(t, y, nx, dx, n0, p0, mu_n, mu_p, ks, Cn, Cp, Sf, Sb,
               tauN, tauP, lam, Tm, kC, Nt, tauE):
    """RHS of the shallow-trap model. y = [N, N_trap, P, E]."""
    N = y[:nx]
    N_trap = y[nx:2 * nx]
    P = y[2 * nx:3 * nx]
    E = y[3 * nx:]

    Jn, Jp = _currents(N, P, E, mu_n, mu_p, Sf, Sb, Tm, dx, n0, p0)
    R = _recombination(N, P, n0, p0, ks, Cn, Cp, tauN, tauP)
    trap = kC * N * (Nt - N_trap)
    detrap = N_trap / tauE

    dy = np.empty_like(y)
    dy[:nx] = np.diff(Jn) / dx - R + detrap - trap
    dy[nx:2 * nx] = trap - detrap
    dy[2 * nx:3 * nx] = -np.diff(Jp) / dx - R
    dy[3 * nx:] = -(Jn + Jp) * lam
    return dy


def calculate_pl(dx, N, P, ks, n0, p0):
    """TRPL observable: spatial integral of radiative recombination.
    The reference's trapezoid-with-half-edge-cells integral over
    cell-centered values reduces exactly to dx * sum
    (reference forward_solver.py:258-264)."""
    rr = ks * (N * P - n0 * p0)
    return dx * rr.sum(axis=-1)


def calculate_trts(dx, N, P, mu_n, mu_p, n0, p0):
    """TRTS observable: spatial integral of photoconductivity."""
    photoc = q_C * (mu_n * (N - n0) + mu_p * (P - p0))
    return dx * photoc.sum(axis=-1)


def beer_lambert(fluence, alpha, x_centers, direction=1):
    """Beer-Lambert initial excess-carrier profile [nm^-3]."""
    prof = fluence * alpha * np.exp(-alpha * x_centers)
    if direction < 0:
        prof = prof[::-1]
    return prof


def solve_reference(init_dN, thickness, nx, t_out, params, meas="TRPL",
                    model="std", hmax=4.0, rtol=DEFAULT_RTOL,
                    atol=DEFAULT_ATOL, min_y=None, stats=None,
                    rhs="numpy"):
    """Solve one simulation with scipy LSODA and return the observable
    in measurement units ([cm^-2 s^-1] for TRPL).

    Parameters
    ----------
    init_dN : (nx,) excess carrier density profile [nm^-3]
    params : dict with keys n0, p0, mu_n, mu_p, ks, Cn, Cp, Sf, Sb,
        tauN, tauP, eps, Tm (model units: nm, V, ns), plus kC, Nt, tauE
        for the traps model.
    t_out : output times [ns], starting at 0.
    """
    dx = thickness / nx
    n0, p0 = params["n0"], params["p0"]
    lam = q_C / (params["eps"] * eps0)
    N = init_dN + n0
    P = init_dN + p0
    E = efield_init(N, P, n0, p0, params["eps"], dx)

    common = (nx, dx, n0, p0, params["mu_n"], params["mu_p"], params["ks"],
              params["Cn"], params["Cp"], params["Sf"], params["Sb"],
              params["tauN"], params["tauP"], lam, params["Tm"])

    if rhs not in ("numpy", "native"):
        raise ValueError(f"rhs must be 'numpy' or 'native', got {rhs!r}")
    if model == "std":
        y0 = np.concatenate([N, P, E])
        fun = lambda t, y: dydt_std(t, y, *common)
        if rhs == "native":
            # same equations compiled (runtime/refrhs.cpp) — ~10x less
            # Python-callback overhead per LSODA RHS call; falls back to
            # the numpy RHS when the native toolchain is unavailable
            from metrotrpl_tpu_torch.runtime import make_native_rhs_std
            nf = make_native_rhs_std(nx, dx, params)
            if nf is not None:
                fun = nf
    elif model == "traps":
        y0 = np.concatenate([N, np.zeros_like(N), P, E])
        fun = lambda t, y: dydt_traps(
            t, y, *common, params["kC"], params["Nt"], params["tauE"])
    else:
        raise ValueError(f"Invalid model {model}")

    sol = solve_ivp(fun, [t_out[0], t_out[-1]], y0, method="LSODA",
                    dense_output=True, max_step=hmax, rtol=rtol, atol=atol)
    if stats is not None:
        # expose solver-effort counters (nfev drives the numba-adjusted
        # benchmark denominator, BASELINE.md)
        stats["nfev"] = stats.get("nfev", 0) + int(sol.nfev)
        stats["njev"] = stats.get("njev", 0) + int(getattr(sol, "njev", 0))
    data = sol.sol(t_out).T
    data[t_out > sol.t[-1]] = 0.0

    if model == "std":
        N, P, _ = np.split(data, [nx, 2 * nx], axis=1)
    else:
        N, _, P, _ = np.split(data, [nx, 2 * nx, 3 * nx], axis=1)

    if meas == "TRPL":
        out = calculate_pl(dx, N, P, params["ks"], n0, p0) * 1e23
    elif meas == "TRTS":
        out = calculate_trts(
            dx, N, P, params["mu_n"], params["mu_p"], n0, p0) * 1e9
    else:
        raise NotImplementedError("TRPL or TRTS only")

    if min_y is None:
        min_y = np.finfo(np.float64).tiny
    # Clamp everything after the first dip below min_y
    # (reference forward_solver.py:190-201 semantics).
    i_final = np.argmax(out < min_y)
    if out[i_final] < min_y:
        out[i_final:] = min_y
    return out
