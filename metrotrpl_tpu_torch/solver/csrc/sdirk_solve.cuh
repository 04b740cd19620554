// Per-cell arithmetic of the drift-diffusion models (std, C=3, and the
// shallow-trap model, C=4) and of the small block algebra used by
// sdirk_solve.cu.
//
// Every function here is one cell's share of a plane operation in
// metrotrpl_tpu_torch/physics/models.py or ops/blocktridiag.py, written
// with the same operand order so the kernel and the plain PyTorch version
// agree to rounding. State slots per cell: (dN, dD, E_shifted) for std,
// (dN, Ntrap, dD, E_shifted) for traps (Model<NC> below), with
// E_shifted[i] = E_{i+1} (the edge between cells i and i+1).
//
// NaN handling: jnp/torch maximum and minimum propagate NaN, and the
// failure predicates downstream rely on it; fmax/fmin drop NaN, so they
// are never used here. nan_max below lets NaN win.
#pragma once

#if defined(__CUDACC__)
#define SDIRK_HD __host__ __device__ __forceinline__
#else
#define SDIRK_HD inline
#endif

namespace sdirk {

constexpr int N_PARAM = 17;    // ScaledParams fields, in their order
constexpr int MAX_LEVELS = 10; // PCR levels for nx <= 1024

// State slots of the NC-component model: the std model (3) carries
// (dN, dD, E); the traps model (4) carries (dN, Ntrap, dD, E).
template <int NC>
struct Model;

template <>
struct Model<3> {
  static constexpr int N = 0, D = 1, E = 2;
};

template <>
struct Model<4> {
  static constexpr int N = 0, T = 1, D = 2, E = 3;
};

template <typename S>
SDIRK_HD bool is_nan(S x) { return x != x; }

// max that propagates NaN from either side (jnp.maximum semantics)
template <typename S>
SDIRK_HD S nan_max(S a, S b) { return (is_nan(a) || a > b) ? a : b; }

// min that propagates NaN from either side (jnp.minimum semantics)
template <typename S>
SDIRK_HD S nan_min(S a, S b) { return (is_nan(a) || a < b) ? a : b; }

template <typename S>
SDIRK_HD S abs_(S x) { return x < S(0) ? -x : x; }

// models._signfloor: floor |x| at 1e-9 keeping the sign; NaN stays NaN
template <typename S>
SDIRK_HD S signfloor(S x) {
  const S eps = S(1e-9);
  return x >= S(0) ? nan_max(x, eps) : nan_min(x, -eps);
}

// Scaled parameters of one simulation (the 17 ScaledParams fields; the
// last 3 are read by the traps model only).
template <typename S>
struct Params {
  S n0t, p0t, drift_n, drift_p, diff_n, diff_p, ks_s, cn_s, cp_s, sf, sb,
      tauN, tauP, inv_dx, kc_s, nt_s, inv_tauE;
};

template <typename S>
SDIRK_HD Params<S> load_params(const S* par) {
  Params<S> p;
  p.n0t = par[0];
  p.p0t = par[1];
  p.drift_n = par[2];
  p.drift_p = par[3];
  p.diff_n = par[4];
  p.diff_p = par[5];
  p.ks_s = par[6];
  p.cn_s = par[7];
  p.cp_s = par[8];
  p.sf = par[9];
  p.sb = par[10];
  p.tauN = par[11];
  p.tauP = par[12];
  p.inv_dx = par[13];
  p.kc_s = par[14];
  p.nt_s = par[15];
  p.inv_tauE = par[16];
  return p;
}

// Derived densities of one cell.
template <typename S>
struct Cell {
  S dN, dD, E, dP, Ntot, Ptot, M;
};

template <typename S>
SDIRK_HD Cell<S> make_cell(S dN, S dD, S E, const Params<S>& p) {
  Cell<S> c;
  c.dN = dN;
  c.dD = dD;
  c.E = E;
  c.dP = dN + dD;
  c.M = p.n0t * c.dP + p.p0t * dN + dN * c.dP;  // _excess_product
  c.Ntot = p.n0t + dN;
  c.Ptot = p.p0t + c.dP;
  return c;
}

// Interior edge currents between cells a (left) and b (right), using the
// left cell's E slot: jn_int and F_int of models._fluxes.
template <typename S>
SDIRK_HD void edge_flux(const Cell<S>& a, const Cell<S>& b,
                        const Params<S>& p, S* jn, S* F) {
  const S Ne = S(0.5) * (a.Ntot + b.Ntot);
  const S Pe = S(0.5) * (a.Ptot + b.Ptot);
  const S ddN = b.dN - a.dN;
  const S ddD = b.dD - a.dD;
  *jn = p.drift_n * Ne * a.E + p.diff_n * ddN * p.inv_dx;
  *F = (p.drift_n * Ne + p.drift_p * Pe) * a.E
       + ((p.diff_n - p.diff_p) * ddN - p.diff_p * ddD) * p.inv_dx;
}

// Surface recombination flux S_rec * M / (Ntot + Ptot) of a boundary cell.
template <typename S>
SDIRK_HD S surface_flux(const Cell<S>& c, S s_rec) {
  return s_rec * c.M / signfloor(c.Ntot + c.Ptot);
}

// models._bulk_recombination
template <typename S>
SDIRK_HD S bulk_recombination(const Cell<S>& c, const Params<S>& p) {
  const S rate = p.cn_s * c.Ntot + p.cp_s * c.Ptot + p.ks_s
                 + S(1) / signfloor(p.tauN * c.Ptot + p.tauP * c.Ntot);
  return rate * c.M;
}

// Own right edge of cell i of n: the interior currents to cell i+1
// (edge_flux), or the back-surface flux at the last cell. Computed once
// per edge and shared with the neighbour, as the plane code computes each
// edge once: the divergences then telescope exactly.
template <typename S>
SDIRK_HD void right_edge_flux(int i, int n, const Cell<S>& me,
                              const Cell<S>& hi, const Params<S>& p, S* jn,
                              S* F) {
  if (i < n - 1) {
    edge_flux(me, hi, p, jn, F);
  } else {  // the surface terms cancel in F
    *jn = -surface_flux(me, p.sb);
    *F = S(0);
  }
}

// dy/dt at cell i of n (rhs_std_planes) from its left and right edge
// currents (the left edge of cell 0 is the front surface).
template <typename S>
SDIRK_HD void rhs_cell(int i, int n, const Cell<S>& me, S jn_l, S F_l,
                       S jn_r, S F_r, const Params<S>& p, S* out) {
  const S R = bulk_recombination(me, p);
  out[0] = (jn_r - jn_l) * p.inv_dx - R;
  out[1] = -(F_r - F_l) * p.inv_dx;
  out[2] = (i < n - 1) ? -F_r * p.inv_dx : S(0);
}

// dy/dt at cell i of n (rhs_traps_planes): the std rows in slots
// (0, 2, 3) plus the cell-local trap exchange, added in the plane code's
// order; Ntr is the cell's trapped density.
template <typename S>
SDIRK_HD void rhs_cell_traps(int i, int n, const Cell<S>& me, S Ntr, S jn_l,
                             S F_l, S jn_r, S F_r, const Params<S>& p,
                             S* out) {
  S o[3];
  rhs_cell(i, n, me, jn_l, F_l, jn_r, F_r, p, o);
  const S trap = p.kc_s * me.Ntot * (p.nt_s - Ntr);
  const S detrap = Ntr * p.inv_tauE;
  out[0] = o[0] + detrap - trap;
  out[1] = trap - detrap;
  out[2] = o[1] + trap - detrap;
  out[3] = o[2];
}

// Jacobian entries of one edge k (jac_std_planes edge planes), for the
// edge between cells a = k and b = k+1 (b zero-padded past the last
// cell); `edge` is 1 for a valid edge k < n-1, else 0.
template <typename S>
struct EdgeJac {
  S jn_dNk, jn_dNk1, jn_dE, F_dNk, F_dNk1, F_dDk, F_dDk1, F_dE;
};

template <typename S>
SDIRK_HD EdgeJac<S> edge_jac(S Ntot_a, S Ptot_a, S Ntot_b, S Ptot_b, S E_a,
                             S edge, const Params<S>& p) {
  EdgeJac<S> e;
  const S Ne = S(0.5) * (Ntot_a + Ntot_b);
  const S Pe = S(0.5) * (Ptot_a + Ptot_b);
  const S ix = p.inv_dx;
  const S dnp = p.drift_n + p.drift_p;
  const S dmd = p.diff_n - p.diff_p;
  const S an = S(0.5) * p.drift_n * E_a;
  e.jn_dNk = (an - p.diff_n * ix) * edge;
  e.jn_dNk1 = (an + p.diff_n * ix) * edge;
  e.jn_dE = (p.drift_n * Ne) * edge;
  const S as_ = S(0.5) * dnp * E_a;
  e.F_dNk = (as_ - dmd * ix) * edge;
  e.F_dNk1 = (as_ + dmd * ix) * edge;
  const S bs = S(0.5) * p.drift_p * E_a;
  e.F_dDk = (bs + p.diff_p * ix) * edge;
  e.F_dDk1 = (bs - p.diff_p * ix) * edge;
  e.F_dE = (p.drift_n * Ne + p.drift_p * Pe) * edge;
  return e;
}

// Jacobian planes of cell i's own edge k = i (zero-padded past the last
// cell, where the edge mask is 0).
template <typename S>
SDIRK_HD EdgeJac<S> own_edge_jac(int i, int n, const Cell<S>& me,
                                 const Cell<S>& hi, const Params<S>& p) {
  const bool last = i == n - 1;
  return edge_jac(me.Ntot, me.Ptot, last ? S(0) : hi.Ntot,
                  last ? S(0) : hi.Ptot, me.E, last ? S(0) : S(1), p);
}

// Blocks (L, D, U) of the Jacobian at cell i of n (jac_std_planes), from
// the cell, its own edge ek and the previous cell's edge ep (zeros at the
// first cell: prev() zero-pads).
template <typename S>
SDIRK_HD void jac_cell(int i, int n, const Cell<S>& me, const EdgeJac<S>& ek,
                       const EdgeJac<S>& ep, const Params<S>& p, S* L, S* D,
                       S* U) {
  const bool first = i == 0;
  const bool last = i == n - 1;
  const S Ntot = me.Ntot, Ptot = me.Ptot, M = me.M;

  const S q = signfloor(p.tauN * Ptot + p.tauP * Ntot);
  const S inv_q2 = S(1) / (q * q);
  const S rate = p.cn_s * Ntot + p.cp_s * Ptot + p.ks_s + S(1) / q;
  const S dR_dN = rate * (Ntot + Ptot)
                  + M * (p.cn_s + p.cp_s - (p.tauN + p.tauP) * inv_q2);
  const S dR_dD = rate * Ntot + M * (p.cp_s - p.tauN * inv_q2);

  const S Ssum = signfloor(Ntot + Ptot);
  const S inv_S = S(1) / Ssum;
  const S s_dN = S(1) - S(2) * M * inv_S * inv_S;
  const S s_dD = (Ntot - M * inv_S) * inv_S;
  const S sf_dN = p.sf * s_dN, sf_dD = p.sf * s_dD;
  const S sb_dN = p.sb * s_dN, sb_dD = p.sb * s_dD;

  const S ix = p.inv_dx;
  // row 0: ddN_i = (jn_{i+1} - jn_i)/dx - R_i
  D[0] = ix * ((last ? -sb_dN : ek.jn_dNk) - (first ? sf_dN : ep.jn_dNk1))
         - dR_dN;
  D[1] = ix * ((last ? -sb_dD : S(0)) - (first ? sf_dD : S(0))) - dR_dD;
  D[2] = ix * ek.jn_dE;
  L[0] = -ix * ep.jn_dNk;
  L[1] = S(0);
  L[2] = -ix * ep.jn_dE;
  U[0] = ix * ek.jn_dNk1;
  U[1] = S(0);
  U[2] = S(0);
  // row 1: ddD_i = -(F_{i+1} - F_i)/dx
  D[3] = -ix * (ek.F_dNk - ep.F_dNk1);
  D[4] = -ix * (ek.F_dDk - ep.F_dDk1);
  D[5] = -ix * ek.F_dE;
  L[3] = ix * ep.F_dNk;
  L[4] = ix * ep.F_dDk;
  L[5] = ix * ep.F_dE;
  U[3] = -ix * ek.F_dNk1;
  U[4] = -ix * ek.F_dDk1;
  U[5] = S(0);
  // row 2: dE_i = -F_i(edge i)/dx
  D[6] = -ix * ek.F_dNk;
  D[7] = -ix * ek.F_dDk;
  D[8] = -ix * ek.F_dE;
  L[6] = S(0);
  L[7] = S(0);
  L[8] = S(0);
  U[6] = -ix * ek.F_dNk1;
  U[7] = -ix * ek.F_dDk1;
  U[8] = S(0);
}

// Blocks (L, D, U) of the traps Jacobian at cell i of n
// (jac_traps_planes): the std 3x3 blocks spliced into slots (0, 2, 3),
// plus the cell-local trap derivatives on the diagonal block. 4x4
// row-major.
template <typename S>
SDIRK_HD void jac_cell_traps(int i, int n, const Cell<S>& me, S Ntr,
                             const EdgeJac<S>& ek, const EdgeJac<S>& ep,
                             const Params<S>& p, S* L, S* D, S* U) {
  S L3[9], D3[9], U3[9];
  jac_cell(i, n, me, ek, ep, p, L3, D3, U3);
  const int slot[3] = {0, 2, 3};
  for (int e = 0; e < 16; ++e) {
    L[e] = S(0);
    D[e] = S(0);
    U[e] = S(0);
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      const int e4 = slot[a] * 4 + slot[b];
      L[e4] = L3[a * 3 + b];
      D[e4] = D3[a * 3 + b];
      U[e4] = U3[a * 3 + b];
    }
  const S tcap = p.kc_s * (p.nt_s - Ntr);      // d(trap)/ddN
  const S trel = p.kc_s * me.Ntot + p.inv_tauE; // -d(trap - detrap)/dNtr
  D[0] = D3[0] - tcap;
  D[1] = trel;
  D[4] = tcap;
  D[5] = -trel;
  D[8] = D3[3] + tcap;
  D[9] = -trel;
}

// out = A @ B for NC x NC row-major blocks (p_mm operand order)
template <int NC, typename S>
SDIRK_HD void mm(const S* A, const S* B, S* out) {
  for (int i = 0; i < NC; ++i)
    for (int k = 0; k < NC; ++k) {
      S acc = A[i * NC + 0] * B[0 * NC + k];
      for (int j = 1; j < NC; ++j) acc = acc + A[i * NC + j] * B[j * NC + k];
      out[i * NC + k] = acc;
    }
}

// out = A @ x (p_mv operand order)
template <int NC, typename S>
SDIRK_HD void mv(const S* A, const S* x, S* out) {
  for (int i = 0; i < NC; ++i) {
    S acc = A[i * NC + 0] * x[0];
    for (int j = 1; j < NC; ++j) acc = acc + A[i * NC + j] * x[j];
    out[i] = acc;
  }
}

// Closed-form unpivoted 2x2 inverse (p_inv_small, C=2)
template <typename S>
SDIRK_HD void inv2(const S* A, S* out) {
  const S idet = S(1) / (A[0] * A[3] - A[1] * A[2]);
  out[0] = A[3] * idet;
  out[1] = -A[1] * idet;
  out[2] = -A[2] * idet;
  out[3] = A[0] * idet;
}

// Closed-form unpivoted 3x3 inverse (p_inv_small, C=3)
template <typename S>
SDIRK_HD void inv3(const S* A, S* out) {
  const S c00 = A[4] * A[8] - A[5] * A[7];
  const S c01 = A[5] * A[6] - A[3] * A[8];
  const S c02 = A[3] * A[7] - A[4] * A[6];
  const S c10 = A[2] * A[7] - A[1] * A[8];
  const S c11 = A[0] * A[8] - A[2] * A[6];
  const S c12 = A[1] * A[6] - A[0] * A[7];
  const S c20 = A[1] * A[5] - A[2] * A[4];
  const S c21 = A[2] * A[3] - A[0] * A[5];
  const S c22 = A[0] * A[4] - A[1] * A[3];
  const S idet = S(1) / (A[0] * c00 + A[1] * c01 + A[2] * c02);
  out[0] = c00 * idet;
  out[1] = c10 * idet;
  out[2] = c20 * idet;
  out[3] = c01 * idet;
  out[4] = c11 * idet;
  out[5] = c21 * idet;
  out[6] = c02 * idet;
  out[7] = c12 * idet;
  out[8] = c22 * idet;
}

// Unpivoted 4x4 inverse by the Schur complement on the 2x2 partition
// [[P, Q], [R, S]], in p_inv_small's (C=4) order.
template <typename S>
SDIRK_HD void inv4(const S* A, S* out) {
  const S P[4] = {A[0], A[1], A[4], A[5]};
  const S Q[4] = {A[2], A[3], A[6], A[7]};
  const S R[4] = {A[8], A[9], A[12], A[13]};
  const S Sb[4] = {A[10], A[11], A[14], A[15]};
  S Pinv[4], RPinv[4], RPQ[4], schur[4], Sinv[4], PinvQ[4], PQS[4], corr[4],
      SRP[4];
  inv2(P, Pinv);
  mm<2>(R, Pinv, RPinv);
  mm<2>(RPinv, Q, RPQ);
  for (int e = 0; e < 4; ++e) schur[e] = Sb[e] - RPQ[e];
  inv2(schur, Sinv);
  mm<2>(Pinv, Q, PinvQ);
  mm<2>(PinvQ, Sinv, PQS);
  mm<2>(PQS, RPinv, corr);
  mm<2>(Sinv, RPinv, SRP);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      out[i * 4 + j] = Pinv[i * 2 + j] + corr[i * 2 + j];    // top left
      out[i * 4 + 2 + j] = -PQS[i * 2 + j];                   // top right
      out[(2 + i) * 4 + j] = -SRP[i * 2 + j];                 // bottom left
      out[(2 + i) * 4 + 2 + j] = Sinv[i * 2 + j];             // bottom right
    }
}

// Inverse of one NC x NC block
template <int NC, typename S>
SDIRK_HD void inv(const S* A, S* out) {
  static_assert(NC == 3 || NC == 4, "std (3) or traps (4) blocks");
  if (NC == 3)
    inv3(A, out);
  else
    inv4(A, out);
}

}  // namespace sdirk
