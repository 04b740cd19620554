"""The std carrier model in plain PyTorch: scaled drift-diffusion-
recombination of (dN, dD, E_shifted) planes, its block-tridiagonal
Jacobian, the Beer-Lambert initial profile and the TRPL observable.

A frozen copy of the plain version the port keeps beside its solve kernel
(the std model only). The state scaling:

    dN = (N - n0) / ns,  dD = (P - p0 - (N - n0)) / ns,
    E_shifted[i] = E_{i+1} / (lam * dx * ns),  lam = q_C / (eps * eps0)
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

#: vacuum permittivity [C / (V nm)], elementary charge [C], Boltzmann
#: constant [eV / K] (reference forward_solver.py:18-24)
EPS0 = 8.854e-12 * 1e-9
Q_C = 1.602e-19
KB = 8.61773e-5


class ScaledParams(NamedTuple):
    """Per-simulation scaled coefficients, each (B, 1)."""
    n0t: torch.Tensor
    p0t: torch.Tensor
    drift_n: torch.Tensor
    drift_p: torch.Tensor
    diff_n: torch.Tensor
    diff_p: torch.Tensor
    ks_s: torch.Tensor
    cn_s: torch.Tensor
    cp_s: torch.Tensor
    sf: torch.Tensor
    sb: torch.Tensor
    tauN: torch.Tensor
    tauP: torch.Tensor
    inv_dx: torch.Tensor


def scaled_params(raw, dx, ns):
    """ScaledParams from model-unit parameters ``raw`` (name -> (B,)),
    cell sizes ``dx`` (B,) and density scales ``ns`` (B,)."""
    lam = Q_C / (raw["eps"] * EPS0)
    one = torch.ones_like(raw["p0"])
    p = ScaledParams(
        n0t=raw["n0"] / ns, p0t=raw["p0"] / ns,
        drift_n=raw["mu_n"] * lam * dx * ns,
        drift_p=raw["mu_p"] * lam * dx * ns,
        diff_n=raw["mu_n"] * KB * raw["Tm"],
        diff_p=raw["mu_p"] * KB * raw["Tm"],
        ks_s=raw["ks"] * ns, cn_s=raw["Cn"] * ns * ns,
        cp_s=raw["Cp"] * ns * ns, sf=raw["Sf"] * one, sb=raw["Sb"] * one,
        tauN=raw["tauN"] * one, tauP=raw["tauP"] * one, inv_dx=one / dx)
    return ScaledParams(*(a[..., None] for a in p))


def shift(a, s):
    """out[..., i] = a[..., i - s] along the cell axis, zero padded."""
    if s == 0:
        return a
    n = a.shape[-1]
    if s > 0:
        return F.pad(a, (s, 0))[..., :n]
    return F.pad(a, (0, -s))[..., -s:]


def _excess_product(dN, dP, p):
    return p.n0t * dP + p.p0t * dN + dN * dP


def _signfloor(x, eps=1e-9):
    return torch.where(x >= 0, torch.maximum(x, x.new_tensor(eps)),
                       torch.minimum(x, x.new_tensor(-eps)))


def rhs(y, p):
    """dy/dt of the plane state y = (dN, dD, E_shifted)."""
    dN, dD, E = y
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
    jn = torch.cat([s_front, jn_int, -s_back], dim=-1)
    Fs = F.pad(F_int, (1, 1))
    rate = (p.cn_s * Ntot + p.cp_s * Ptot + p.ks_s
            + 1.0 / _signfloor(p.tauN * Ptot + p.tauP * Ntot))
    R = rate * M
    ddN = (jn[..., 1:] - jn[..., :-1]) * p.inv_dx - R
    ddD = -(Fs[..., 1:] - Fs[..., :-1]) * p.inv_dx
    n = dN.shape[-1]
    interior = torch.arange(n, device=dN.device) < n - 1
    dE = torch.where(interior, -Fs[..., 1:] * p.inv_dx, 0.0)
    return (ddN, ddD, dE)


def jacobian(y, p):
    """Block-tridiagonal Jacobian of :func:`rhs`: (L, D, U), 3x3 nested
    tuples of (B, nx) planes; L couples cell i to i-1, U to i+1."""
    dN, dD, E = y
    n = dN.shape[-1]
    dtype = dN.dtype
    idx = torch.arange(n, device=dN.device)
    first = idx == 0
    last = idx == n - 1
    edge = (idx < n - 1).to(dtype)
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
    S = _signfloor(Ntot + Ptot)
    inv_S = 1.0 / S
    s_dN = 1.0 - 2.0 * M * inv_S * inv_S
    s_dD = (Ntot - M * inv_S) * inv_S
    sf_dN, sf_dD = p.sf * s_dN, p.sf * s_dD
    sb_dN, sb_dD = p.sb * s_dN, p.sb * s_dD
    Ne = 0.5 * (Ntot + shift(Ntot, -1))
    Pe = 0.5 * (Ptot + shift(Ptot, -1))
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

    def prev(a):
        return shift(a, 1)

    D00 = ix * (torch.where(last, -sb_dN, jn_dNk)
                - torch.where(first, sf_dN, prev(jn_dNk1))) - dR_dN
    D01 = ix * (torch.where(last, -sb_dD, 0.0)
                - torch.where(first, sf_dD, 0.0)) - dR_dD
    D02 = ix * jn_dE
    L00 = -ix * prev(jn_dNk)
    L02 = -ix * prev(jn_dE)
    U00 = ix * jn_dNk1
    D10 = -ix * (F_dNk - prev(F_dNk1))
    D11 = -ix * (F_dDk - prev(F_dDk1))
    D12 = -ix * F_dE
    L10 = ix * prev(F_dNk)
    L11 = ix * prev(F_dDk)
    L12 = ix * prev(F_dE)
    U10 = -ix * F_dNk1
    U11 = -ix * F_dDk1
    D20 = -ix * F_dNk
    D21 = -ix * F_dDk
    D22 = -ix * F_dE
    U20 = -ix * F_dNk1
    U21 = -ix * F_dDk1
    shape = torch.broadcast_shapes(dN.shape, jn_dNk.shape)
    zero = torch.zeros(shape, dtype=dtype, device=dN.device)

    def bz(a):
        return a.expand(shape)

    L = ((bz(L00), zero, bz(L02)), (bz(L10), bz(L11), bz(L12)),
         (zero, zero, zero))
    D = ((bz(D00), bz(D01), bz(D02)), (bz(D10), bz(D11), bz(D12)),
         (bz(D20), bz(D21), bz(D22)))
    U = ((bz(U00), zero, zero), (bz(U10), bz(U11), zero),
         (bz(U20), bz(U21), zero))
    return L, D, U


def beer_lambert(fluence, alpha, x_centers, direction=1.0):
    """Beer-Lambert initial excess-carrier profile [nm^-3]."""
    prof = fluence * alpha * torch.exp(-alpha * x_centers)
    return torch.where(direction < 0, torch.flip(prof, dims=(-1,)), prof)


def pl_scaled(y, p, dx):
    """dx times the cell sum of the scaled excess product."""
    dN, dD = y[0], y[1]
    return dx * torch.sum(_excess_product(dN, dN + dD, p), dim=-1)
