"""Scaled excess-density drift-diffusion-recombination models.

PyTorch counterpart of ``metrotrpl_tpu/physics/models.py``; the module
docstring there derives the state scaling and the antisymmetric split
used here unchanged:

    state planes, each (..., nx): (dN, dD, E_shifted) for the std model
    (C=3), (dN, Ntrap, dD, E_shifted) for the shallow-trap model (C=4);
    dN = (N - n0) / ns,  Ntrap = N_trap / ns,
    dD = (P - p0 - (N - n0)) / ns,
    E_shifted[i] = E_{i+1} / (lam * dx * ns),  lam = q_C / (eps * eps0)

Every state component stays O(1), so float32 holds up, and the charge
separation dD is carried directly instead of as a difference of two
nearly equal densities.

Each function mirrors its JAX namesake line for line, so the two agree to
rounding; the CUDA kernel's per-cell arithmetic
(``solver/csrc/sdirk_solve.cuh``) is the same algebra written per cell.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from metrotrpl_tpu_torch.constants import eps0, kB, q_C

N_COMP = {"std": 3, "traps": 4}


class ScaledParams(NamedTuple):
    """Per-simulation scaled coefficients (tensors broadcastable against
    the (..., nx) state planes, e.g. (B, 1))."""
    n0t: torch.Tensor       # n0 / ns
    p0t: torch.Tensor       # p0 / ns
    drift_n: torch.Tensor   # mu_n * lam * dx * ns
    drift_p: torch.Tensor   # mu_p * lam * dx * ns
    diff_n: torch.Tensor    # mu_n * kB * Tm
    diff_p: torch.Tensor    # mu_p * kB * Tm
    ks_s: torch.Tensor      # ks * ns
    cn_s: torch.Tensor      # Cn * ns^2
    cp_s: torch.Tensor      # Cp * ns^2
    sf: torch.Tensor        # Sf
    sb: torch.Tensor        # Sb
    tauN: torch.Tensor
    tauP: torch.Tensor
    inv_dx: torch.Tensor    # 1 / dx
    # traps-model fields, kept so the 17-field layout matches the kernel's
    kc_s: torch.Tensor      # kC * ns
    nt_s: torch.Tensor      # Nt / ns
    inv_tauE: torch.Tensor  # 1 / tauE


def make_scaled_params(raw, dx, ns):
    """:class:`ScaledParams` from raw model-unit parameters ``raw`` (name
    -> tensor: n0, p0, mu_n, mu_p, ks, Cn, Cp, Sf, Sb, tauN, tauP, eps, Tm,
    optionally kC, Nt, tauE), cell size ``dx`` and density scale ``ns``."""
    lam = q_C / (raw["eps"] * eps0)
    one = torch.ones_like(raw["p0"])
    return ScaledParams(
        n0t=raw["n0"] / ns,
        p0t=raw["p0"] / ns,
        drift_n=raw["mu_n"] * lam * dx * ns,
        drift_p=raw["mu_p"] * lam * dx * ns,
        diff_n=raw["mu_n"] * kB * raw["Tm"],
        diff_p=raw["mu_p"] * kB * raw["Tm"],
        ks_s=raw["ks"] * ns,
        cn_s=raw["Cn"] * ns * ns,
        cp_s=raw["Cp"] * ns * ns,
        sf=raw["Sf"] * one,
        sb=raw["Sb"] * one,
        tauN=raw["tauN"] * one,
        tauP=raw["tauP"] * one,
        inv_dx=one / dx,
        kc_s=raw.get("kC", 0.0) * ns,
        nt_s=raw.get("Nt", 0.0) / ns,
        inv_tauE=one / raw.get("tauE", 1.0),
    )


def _shift(a, s):
    """out[..., i] = a[..., i - s] along the trailing cell axis, zero
    padded (``metrotrpl_tpu.ops.blocktridiag._shift``)."""
    if s == 0:
        return a
    n = a.shape[-1]
    if s > 0:
        return F.pad(a, (s, 0))[..., :n]
    return F.pad(a, (0, -s))[..., -s:]


def _excess_product(dN, dP, p):
    """(N*P - n0*p0) / ns^2, computed without cancellation."""
    return p.n0t * dP + p.p0t * dN + dN * dP


def _signfloor(x, eps=1e-9):
    """Floor |x| away from 0, keeping its sign (see the JAX twin). NaN
    stays NaN: ``torch.maximum``/``minimum`` propagate it."""
    return torch.where(x >= 0, torch.maximum(x, x.new_tensor(eps)),
                       torch.minimum(x, x.new_tensor(-eps)))


def _fluxes(dN, dD, E, p):
    """Scaled electron edge current jn and sum current F = (Jn+Jp)/ns on
    the full nx+1 edge grid (antisymmetric-split form)."""
    dP = dN + dD
    M = _excess_product(dN, dP, p)
    Ntot = p.n0t + dN
    Ptot = p.p0t + dP

    s_front = p.sf * M[..., :1] / _signfloor(Ntot[..., :1] + Ptot[..., :1])
    s_back = p.sb * M[..., -1:] / _signfloor(Ntot[..., -1:]
                                             + Ptot[..., -1:])

    E_int = E[..., :-1]
    Ne = 0.5 * (Ntot[..., :-1] + Ntot[..., 1:])
    Pe = 0.5 * (Ptot[..., :-1] + Ptot[..., 1:])
    ddN_e = dN[..., 1:] - dN[..., :-1]
    ddD_e = dD[..., 1:] - dD[..., :-1]
    jn_int = p.drift_n * Ne * E_int + p.diff_n * ddN_e * p.inv_dx
    F_int = ((p.drift_n * Ne + p.drift_p * Pe) * E_int
             + ((p.diff_n - p.diff_p) * ddN_e - p.diff_p * ddD_e)
             * p.inv_dx)

    # the surface terms cancel in F: its boundary entries are exact zeros
    jn = torch.cat([s_front, jn_int, -s_back], dim=-1)
    Fs = F.pad(F_int, (1, 1))
    return jn, Fs, M, Ntot, Ptot


def _bulk_recombination(M, Ntot, Ptot, p):
    """Scaled Auger + radiative + SRH recombination rate R/ns."""
    rate = (p.cn_s * Ntot + p.cp_s * Ptot + p.ks_s
            + 1.0 / _signfloor(p.tauN * Ptot + p.tauP * Ntot))
    return rate * M


def rhs_std_planes(y, p):
    """dy/dt for the std model; y is the plane tuple (dN, dD, E_shifted)."""
    dN, dD, E = y
    jn, Fs, M, Ntot, Ptot = _fluxes(dN, dD, E, p)
    R = _bulk_recombination(M, Ntot, Ptot, p)

    ddN = (jn[..., 1:] - jn[..., :-1]) * p.inv_dx - R
    ddD = -(Fs[..., 1:] - Fs[..., :-1]) * p.inv_dx
    n = dN.shape[-1]
    interior = torch.arange(n, device=dN.device) < n - 1
    dE = torch.where(interior, -Fs[..., 1:] * p.inv_dx, 0.0)
    return (ddN, ddD, dE)


def jac_std_planes(y, p):
    """Symbolic block-tridiagonal Jacobian of :func:`rhs_std_planes`.

    Returns (L, D, U), 3x3 nested tuples of (..., nx) planes: ``D[a][b]``
    at cell i is d f_a,i / d y_b,i; ``L`` couples to cell i-1 and ``U`` to
    cell i+1. The derivation is in the JAX twin's docstring.
    """
    dN, dD, E = y
    n = dN.shape[-1]
    dtype = dN.dtype
    idx = torch.arange(n, device=dN.device)
    first = idx == 0
    last = idx == n - 1
    edge = (idx < n - 1).to(dtype)          # valid edge positions 0..n-2

    dP = dN + dD
    Ntot = p.n0t + dN
    Ptot = p.p0t + dP
    M = _excess_product(dN, dP, p)
    q = _signfloor(p.tauN * Ptot + p.tauP * Ntot)
    inv_q2 = 1.0 / (q * q)
    rate = p.cn_s * Ntot + p.cp_s * Ptot + p.ks_s + 1.0 / q
    dR_dN = rate * (Ntot + Ptot) + M * (p.cn_s + p.cp_s
                                        - (p.tauN + p.tauP) * inv_q2)
    dR_dD = rate * Ntot + M * (p.cp_s - p.tauN * inv_q2)

    # surface-recombination derivatives (used at cells 0 / n-1 only)
    S = _signfloor(Ntot + Ptot)
    inv_S = 1.0 / S
    s_dN = 1.0 - 2.0 * M * inv_S * inv_S
    s_dD = (Ntot - M * inv_S) * inv_S
    sf_dN = p.sf * s_dN
    sf_dD = p.sf * s_dD
    sb_dN = p.sb * s_dN
    sb_dD = p.sb * s_dD

    # edge-aligned planes (position k = edge between cells k and k+1)
    Ne = 0.5 * (Ntot + _shift(Ntot, -1))
    Pe = 0.5 * (Ptot + _shift(Ptot, -1))
    ix = p.inv_dx
    dnp_ = p.drift_n + p.drift_p
    dmd = p.diff_n - p.diff_p
    an = 0.5 * p.drift_n * E
    jn_dNk = (an - p.diff_n * ix) * edge
    jn_dNk1 = (an + p.diff_n * ix) * edge
    jn_dE = (p.drift_n * Ne) * edge
    as_ = 0.5 * dnp_ * E
    F_dNk = (as_ - dmd * ix) * edge
    F_dNk1 = (as_ + dmd * ix) * edge
    bs = 0.5 * p.drift_p * E
    F_dDk = (bs + p.diff_p * ix) * edge
    F_dDk1 = (bs - p.diff_p * ix) * edge
    F_dE = (p.drift_n * Ne + p.drift_p * Pe) * edge

    def prev(a):                      # out[i] = a[i-1], zero-padded
        return _shift(a, 1)

    # row 0: ddN_i = (jn_{i+1} - jn_i)/dx - R_i
    D00 = ix * (torch.where(last, -sb_dN, jn_dNk)
                - torch.where(first, sf_dN, prev(jn_dNk1))) - dR_dN
    D01 = ix * (torch.where(last, -sb_dD, 0.0)
                - torch.where(first, sf_dD, 0.0)) - dR_dD
    D02 = ix * jn_dE
    L00 = -ix * prev(jn_dNk)
    L02 = -ix * prev(jn_dE)
    U00 = ix * jn_dNk1

    # row 1: ddD_i = -(F_{i+1} - F_i)/dx, F_0 = F_n = 0
    D10 = -ix * (F_dNk - prev(F_dNk1))
    D11 = -ix * (F_dDk - prev(F_dDk1))
    D12 = -ix * F_dE
    L10 = ix * prev(F_dNk)
    L11 = ix * prev(F_dDk)
    L12 = ix * prev(F_dE)
    U10 = -ix * F_dNk1
    U11 = -ix * F_dDk1

    # row 2: dE_i = -F_i(edge i)/dx for i < n-1, else 0
    D20 = -ix * F_dNk
    D21 = -ix * F_dDk
    D22 = -ix * F_dE
    U20 = -ix * F_dNk1
    U21 = -ix * F_dDk1

    shape = torch.broadcast_shapes(dN.shape, jn_dNk.shape)
    zero = torch.zeros(shape, dtype=dtype, device=dN.device)

    def bz(a):
        return a.expand(shape)

    L = ((bz(L00), zero, bz(L02)),
         (bz(L10), bz(L11), bz(L12)),
         (zero, zero, zero))
    D = ((bz(D00), bz(D01), bz(D02)),
         (bz(D10), bz(D11), bz(D12)),
         (bz(D20), bz(D21), bz(D22)))
    U = ((bz(U00), zero, zero),
         (bz(U10), bz(U11), zero),
         (bz(U20), bz(U21), zero))
    return L, D, U


def rhs_traps_planes(y, p):
    """dy/dt for the shallow-trap model; y is the plane tuple (dN, Ntrap,
    dD, E_shifted). Trap capture moves electrons only, so it enters dD'
    with the opposite sign to dN'."""
    dN, Ntr, dD, E = y
    jn, Fs, M, Ntot, Ptot = _fluxes(dN, dD, E, p)
    R = _bulk_recombination(M, Ntot, Ptot, p)
    trap = p.kc_s * Ntot * (p.nt_s - Ntr)
    detrap = Ntr * p.inv_tauE

    ddN = (jn[..., 1:] - jn[..., :-1]) * p.inv_dx - R + detrap - trap
    dNtr = trap - detrap
    ddD = -(Fs[..., 1:] - Fs[..., :-1]) * p.inv_dx + trap - detrap
    n = dN.shape[-1]
    interior = torch.arange(n, device=dN.device) < n - 1
    dE = torch.where(interior, -Fs[..., 1:] * p.inv_dx, 0.0)
    return (ddN, dNtr, ddD, dE)


def jac_traps_planes(y, p):
    """Symbolic block-tridiagonal Jacobian of :func:`rhs_traps_planes`:
    the std 3x3 blocks spliced into slots (dN, Ntrap, dD, E) = (0, 1, 2,
    3), plus the cell-local trap derivatives on the diagonal block
    (d trap/d dN = kc_s*(nt_s - Ntr), d (trap - detrap)/d Ntr =
    -(kc_s*Ntot + inv_tauE)). 4x4 nested tuples of (..., nx) planes."""
    dN, Ntr, dD, E = y
    L3, D3, U3 = jac_std_planes((dN, dD, E), p)
    zero = torch.zeros_like(D3[0][0])

    def bz(a):
        return a.expand(zero.shape)

    Ntot = p.n0t + dN
    tcap = bz(p.kc_s * (p.nt_s - Ntr))       # d(trap)/ddN
    trel = bz(p.kc_s * Ntot + p.inv_tauE)    # -d(trap - detrap)/dNtr

    # std (dN, dD, E) rows/cols -> traps slots (0, 2, 3); Ntr slot = 1
    def splice(B3, extra_col1=(None, None, None)):
        rows = []
        for a3 in range(3):
            c1 = extra_col1[a3] if extra_col1[a3] is not None else zero
            rows.append((B3[a3][0], c1, B3[a3][1], B3[a3][2]))
        return rows

    L = (splice(L3)[0], (zero,) * 4, *splice(L3)[1:])
    U = (splice(U3)[0], (zero,) * 4, *splice(U3)[1:])

    Drows = splice(D3, extra_col1=(trel, -trel, None))
    D00, _, D02, D03 = Drows[0]
    D20, _, D22, D23 = Drows[1]
    D = ((D00 - tcap, trel, D02, D03),
         (tcap, -trel, zero, zero),
         (D20 + tcap, -trel, D22, D23),
         Drows[2])
    return L, D, U


RHS_PLANES = {"std": rhs_std_planes, "traps": rhs_traps_planes}
JAC_PLANES = {"std": jac_std_planes, "traps": jac_traps_planes}


def beer_lambert(fluence, alpha, x_centers, direction=1.0):
    """Beer-Lambert initial excess-carrier profile [nm^-3]; ``direction``
    < 0 excites from the back surface."""
    prof = fluence * alpha * torch.exp(-alpha * x_centers)
    flipped = torch.flip(prof, dims=(-1,))
    if not torch.is_tensor(direction):
        return flipped if direction < 0 else prof
    return torch.where(direction < 0, flipped, prof)


def initial_state(init_dN, ns, model="std", dtype=None):
    """Scaled initial state (..., C, nx) from an excess-density profile:
    dN = dP initially, so dD and E (and the trapped density) start at
    exactly 0."""
    if model not in N_COMP:
        raise ValueError(f"Invalid model {model}")
    y0 = init_dN / ns
    if dtype is not None:
        y0 = y0.to(dtype)
    zeros = torch.zeros_like(y0)
    return torch.stack([y0] + [zeros] * (N_COMP[model] - 1), dim=-2)


def observables_planes(y, p, dx, model="std"):
    """Scaled (pl_t, trts_t) of a plane-tuple state: dx times the cell sum
    of the excess product, and of diff_n*dN + diff_p*dP."""
    dN = y[0]
    dD = y[2] if model == "traps" else y[1]
    dP = dN + dD
    M = _excess_product(dN, dP, p)
    pl_t = dx * torch.sum(M, dim=-1)
    trts_t = dx * torch.sum(p.diff_n * dN + p.diff_p * dP, dim=-1)
    return pl_t, trts_t


def observable_multipliers(raw, ns):
    """Linear factors mapping scaled observables to measurement units:
    TRPL [cm^-2 s^-1] and TRTS."""
    pl_mult = raw["ks"] * ns * ns * 1e23
    trts_mult = q_C * ns * 1e9 / (kB * raw["Tm"])
    return pl_mult, trts_mult
