// Per-cell arithmetic of the drift-diffusion models (std, C=3, and the
// shallow-trap model, C=4) and of the small block algebra used by
// sdirk_solve.cu.
//
// Every function here is one cell's, or one block row's, share of a
// plane operation in metrotrpl_tpu_torch/physics/models.py or
// ops/blocktridiag.py, written with the same operand order so the kernel
// and the plain PyTorch version agree to rounding (double fuses the block
// algebra's multiply-adds: madd). State slots per cell: (dN, dD,
// E_shifted) for std, (dN, Ntrap, dD, E_shifted) for traps (Model<NC>
// below), with
// E_shifted[i] = E_{i+1} (the edge between cells i and i+1).
//
// NaN handling: jnp/torch maximum and minimum propagate NaN, and the
// failure predicates downstream rely on it; fmax/fmin drop NaN, so they
// are never used here. nan_max below lets NaN win.
#pragma once

#if defined(__CUDACC__)
#define SDIRK_HD __host__ __device__ __forceinline__
#else
#include <cmath>
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
  static constexpr int N = 0, D = 1, E = 2, T = -1;  // no trap slot
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

// a * b + c for the block algebra: one fused multiply-add in double; in
// float the product and the sum rounded on their own, as the plain
// version rounds them (the float32 chord solve amplifies any difference).
SDIRK_HD float madd(float a, float b, float c) { return a * b + c; }
SDIRK_HD double madd(double a, double b, double c) { return fma(a, b, c); }

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

// Row r of dy/dt at cell i of n (rhs_std_planes) from its left and right
// edge currents (the left edge of cell 0 is the front surface).
template <typename S>
SDIRK_HD S rhs_row(int r, int i, int n, const Cell<S>& me, S jn_l, S F_l,
                   S jn_r, S F_r, const Params<S>& p) {
  if (r == 0) return (jn_r - jn_l) * p.inv_dx - bulk_recombination(me, p);
  if (r == 1) return -(F_r - F_l) * p.inv_dx;
  return (i < n - 1) ? -F_r * p.inv_dx : S(0);
}

// Row r of dy/dt at cell i of n (rhs_traps_planes): the std rows in slots
// (0, 2, 3) plus the cell-local trap exchange, added in the plane code's
// order; Ntr is the cell's trapped density.
template <typename S>
SDIRK_HD S rhs_row_traps(int r, int i, int n, const Cell<S>& me, S Ntr,
                         S jn_l, S F_l, S jn_r, S F_r, const Params<S>& p) {
  const S trap = p.kc_s * me.Ntot * (p.nt_s - Ntr);
  const S detrap = Ntr * p.inv_tauE;
  if (r == 1) return trap - detrap;
  const S o = rhs_row(r == 0 ? 0 : r - 1, i, n, me, jn_l, F_l, jn_r, F_r, p);
  if (r == 0) return o + detrap - trap;
  if (r == 2) return o + trap - detrap;
  return o;
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

// Row r of the blocks (L, D, U) of the Jacobian at cell i of n
// (jac_std_planes), from the cell, its own edge ek and the previous cell's
// edge ep (zeros at the first cell: prev() zero-pads).
template <typename S>
SDIRK_HD void jac_row(int r, int i, int n, const Cell<S>& me,
                      const EdgeJac<S>& ek, const EdgeJac<S>& ep,
                      const Params<S>& p, S* L, S* D, S* U) {
  const S ix = p.inv_dx;
  if (r == 0) {  // ddN_i = (jn_{i+1} - jn_i)/dx - R_i
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
  } else if (r == 1) {  // ddD_i = -(F_{i+1} - F_i)/dx
    D[0] = -ix * (ek.F_dNk - ep.F_dNk1);
    D[1] = -ix * (ek.F_dDk - ep.F_dDk1);
    D[2] = -ix * ek.F_dE;
    L[0] = ix * ep.F_dNk;
    L[1] = ix * ep.F_dDk;
    L[2] = ix * ep.F_dE;
    U[0] = -ix * ek.F_dNk1;
    U[1] = -ix * ek.F_dDk1;
    U[2] = S(0);
  } else {  // dE_i = -F_i(edge i)/dx
    D[0] = -ix * ek.F_dNk;
    D[1] = -ix * ek.F_dDk;
    D[2] = -ix * ek.F_dE;
    L[0] = S(0);
    L[1] = S(0);
    L[2] = S(0);
    U[0] = -ix * ek.F_dNk1;
    U[1] = -ix * ek.F_dDk1;
    U[2] = S(0);
  }
}

// Row r of the blocks (L, D, U) of the traps Jacobian at cell i of n
// (jac_traps_planes): the std rows spliced into slots (0, 2, 3), plus the
// cell-local trap derivatives on the diagonal block.
template <typename S>
SDIRK_HD void jac_row_traps(int r, int i, int n, const Cell<S>& me, S Ntr,
                            const EdgeJac<S>& ek, const EdgeJac<S>& ep,
                            const Params<S>& p, S* L, S* D, S* U) {
  const S tcap = p.kc_s * (p.nt_s - Ntr);      // d(trap)/ddN
  const S trel = p.kc_s * me.Ntot + p.inv_tauE; // -d(trap - detrap)/dNtr
  if (r == 1) {
    for (int c = 0; c < 4; ++c) {
      L[c] = S(0);
      U[c] = S(0);
    }
    D[0] = tcap;
    D[1] = -trel;
    D[2] = S(0);
    D[3] = S(0);
    return;
  }
  S L3[3], D3[3], U3[3];
  jac_row(r == 0 ? 0 : r - 1, i, n, me, ek, ep, p, L3, D3, U3);
  const int slot[3] = {0, 2, 3};
  L[1] = S(0);
  D[1] = S(0);
  U[1] = S(0);
  for (int b = 0; b < 3; ++b) {
    L[slot[b]] = L3[b];
    D[slot[b]] = D3[b];
    U[slot[b]] = U3[b];
  }
  if (r == 0) {
    D[0] = D3[0] - tcap;
    D[1] = trel;
  } else if (r == 2) {
    D[0] = D3[0] + tcap;
    D[1] = -trel;
  }
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

// Closed-form unpivoted 2x2 inverse (p_inv_small, C=2)
template <typename S>
SDIRK_HD void inv2(const S* A, S* out) {
  const S idet = S(1) / (A[0] * A[3] - A[1] * A[2]);
  out[0] = A[3] * idet;
  out[1] = -A[1] * idet;
  out[2] = -A[2] * idet;
  out[3] = A[0] * idet;
}

// Row r of the unpivoted 4x4 inverse by the Schur complement on the 2x2
// partition [[P, Q], [R, S]], in p_inv_small's (C=4) order: out[c] =
// A^-1[r][c]; A(k, c) reads entry (k, c). Every row computes the shared
// part (P^-1, R P^-1 and the Schur complement's inverse), then only its
// own row of the products that follow; the 2x2 rows are picked by
// selects, so that nothing is indexed at run time.
template <typename S, typename Blk>
SDIRK_HD void inv4_row(int r, const Blk& A, S* out) {
  const S P[4] = {A(0, 0), A(0, 1), A(1, 0), A(1, 1)};
  const S Q[4] = {A(0, 2), A(0, 3), A(1, 2), A(1, 3)};
  const S R[4] = {A(2, 0), A(2, 1), A(3, 0), A(3, 1)};
  const S Sb[4] = {A(2, 2), A(2, 3), A(3, 2), A(3, 3)};
  S Pinv[4], RPinv[4], RPQ[4], schur[4], Sinv[4];
  inv2(P, Pinv);
  mm<2>(R, Pinv, RPinv);
  mm<2>(RPinv, Q, RPQ);
  for (int e = 0; e < 4; ++e) schur[e] = Sb[e] - RPQ[e];
  inv2(schur, Sinv);
  // row (r mod 2) of a 2x2 block, and a row times a 2x2 block in mm<2>'s
  // operand order
  const bool lo = (r & 1) == 0;
  auto row = [lo](const S* M, S* v) {
    v[0] = lo ? M[0] : M[2];
    v[1] = lo ? M[1] : M[3];
  };
  auto vm = [](const S* v, const S* B, S* o) {
    o[0] = v[0] * B[0] + v[1] * B[2];
    o[1] = v[0] * B[1] + v[1] * B[3];
  };
  if (r < 2) {  // [P^-1 + P^-1 Q S^-1 R P^-1, -P^-1 Q S^-1]
    S p[2], pq[2], pqs[2], corr[2];
    row(Pinv, p);
    vm(p, Q, pq);
    vm(pq, Sinv, pqs);
    vm(pqs, RPinv, corr);
    out[0] = p[0] + corr[0];
    out[1] = p[1] + corr[1];
    out[2] = -pqs[0];
    out[3] = -pqs[1];
  } else {  // [-S^-1 R P^-1, S^-1]
    S si[2], srp[2];
    row(Sinv, si);
    vm(si, RPinv, srp);
    out[0] = -srp[0];
    out[1] = -srp[1];
    out[2] = si[0];
    out[3] = si[1];
  }
}

// Row r of the closed-form unpivoted 3x3 inverse by cofactors (p_inv_small,
// C=3, in its operand order): out[c] = A^-1[r][c]. A(k, c) reads entry
// (k, c).
template <typename S, typename Blk>
SDIRK_HD void inv3_row(int r, const Blk& A, S* out) {
  const S a0 = A(0, 0), a1 = A(0, 1), a2 = A(0, 2);
  const S a3 = A(1, 0), a4 = A(1, 1), a5 = A(1, 2);
  const S a6 = A(2, 0), a7 = A(2, 1), a8 = A(2, 2);
  const S c00 = a4 * a8 - a5 * a7;
  const S c01 = a5 * a6 - a3 * a8;
  const S c02 = a3 * a7 - a4 * a6;
  const S idet = S(1) / (a0 * c00 + a1 * c01 + a2 * c02);
  S k0, k1, k2;  // column r of the cofactor matrix
  if (r == 0) {
    k0 = c00;
    k1 = a2 * a7 - a1 * a8;
    k2 = a1 * a5 - a2 * a4;
  } else if (r == 1) {
    k0 = c01;
    k1 = a0 * a8 - a2 * a6;
    k2 = a2 * a3 - a0 * a5;
  } else {
    k0 = c02;
    k1 = a1 * a6 - a0 * a7;
    k2 = a0 * a4 - a1 * a3;
  }
  out[0] = k0 * idet;
  out[1] = k1 * idet;
  out[2] = k2 * idet;
}

// Row r of the inverse of one NC x NC block
template <int NC, typename S, typename Blk>
SDIRK_HD void inv_row(int r, const Blk& A, S* out) {
  static_assert(NC == 3 || NC == 4, "std (3) or traps (4) blocks");
  if constexpr (NC == 3)
    inv3_row(r, A, out);
  else
    inv4_row(r, A, out);
}

// ---- non-zero patterns of the PCR operands ----
//
// Row r of a C x C pattern is the 4-bit field (pack >> 4r) & 0xF, bit c set
// where column c is non-zero. They are solve_kernel.pcr_patterns(model,
// nx) (tested): L0 / U0, the Jacobian's L and U that level 0 reads; LS /
// US, the L and U of every later level (alpha L and beta U reach a fixed
// point after one level); ALPHA / BETA, bit r set where row r of every
// level's alpha / beta is non-zero (such a row is full); LX / UX, the union
// of the L (U) patterns: the entries the factor levels exchange.
SDIRK_HD constexpr bool pbit(unsigned pack, int r, int c) {
  return (pack >> (4 * r + c)) & 1u;
}
SDIRK_HD constexpr int popc(unsigned v) {
  v = v - ((v >> 1) & 0x55555555u);
  v = (v & 0x33333333u) + ((v >> 2) & 0x33333333u);
  return int((((v + (v >> 4)) & 0x0F0F0F0Fu) * 0x01010101u) >> 24);
}
// position of entry (r, c) among the set bits of pack
SDIRK_HD constexpr int pidx(unsigned pack, int r, int c) {
  return popc(pack & ((1u << (4 * r + c)) - 1u));
}
// whether any row of pack has column c
SDIRK_HD constexpr bool pcol(unsigned pack, int c) {
  return (pack & (0x1111u << c)) != 0u;
}
// the columns of pack's rows in `rows` (bit r): with pack a level's L (U)
// and rows alpha's (beta's), the rows of the partner's Dinv they read
SDIRK_HD constexpr unsigned rows_read(unsigned pack, unsigned rows) {
  unsigned m = 0u;
  for (int r = 0; r < 4; ++r)
    if ((rows >> r) & 1u) m |= (pack >> (4 * r)) & 0xFu;
  return m;
}

template <int NC>
struct Pattern;

template <>
struct Pattern<3> {
  static constexpr unsigned L0 = 0x075, U0 = 0x331, LS = 0x077, US = 0x333;
  static constexpr unsigned ALPHA = 0x3, BETA = 0x7;
  static constexpr unsigned LX = L0 | LS, UX = U0 | US;
};

template <>
struct Pattern<4> {
  static constexpr unsigned L0 = 0x0D09, U0 = 0x5501, LS = 0x0D0D,
                            US = 0x5505;
  static constexpr unsigned ALPHA = 0x5, BETA = 0xD;
  static constexpr unsigned LX = L0 | LS, UX = U0 | US;
};

// One PCR factor level (pcr_factor's recursion) for row r of a cell, on
// the non-zero patterns of the level (FIRST: level 0). In: the row's L,
// D, U (C entries each, updated in place to the next level's) and the
// partners' blocks at -s (dm = Dinv, lm = L, um = U) and +s (dp, lp, up),
// read through accessors f(k, c); has_m / has_p: the partner exists. Out:
// the row's alpha = -L Dinv(i-s) and beta = -U Dinv(i+s) (zero where the
// row or the partner is). Only pattern entries are multiplied, in the
// dense operand order, so a skipped term is an exact zero.
template <int NC, bool FIRST, typename S, typename DM, typename LM,
          typename UM, typename DP, typename LPA, typename UPA>
SDIRK_HD void pcr_level_row(int r, S* L, S* D, S* U, bool has_m, bool has_p,
                            const DM& dm, const LM& lm, const UM& um,
                            const DP& dp, const LPA& lp, const UPA& up,
                            S* alpha, S* beta) {
  using Pa = Pattern<NC>;
  constexpr unsigned LP = FIRST ? Pa::L0 : Pa::LS;
  constexpr unsigned UP = FIRST ? Pa::U0 : Pa::US;
  const bool arow = has_m && pbit(Pa::ALPHA, 0, r);
  const bool brow = has_p && pbit(Pa::BETA, 0, r);
  S t[NC], u[NC];
  for (int c = 0; c < NC; ++c) {
    alpha[c] = beta[c] = t[c] = u[c] = S(0);
  }
  if (arow) {
    for (int c = 0; c < NC; ++c) {
      S acc = S(0);
      for (int k = 0; k < NC; ++k)
        if (pbit(LP, r, k)) acc = madd(L[k], dm(k, c), acc);
      alpha[c] = -acc;
    }
    for (int c = 0; c < NC; ++c) {
      S acc = S(0);
      for (int k = 0; k < NC; ++k)
        if (pbit(LP, k, c)) acc = madd(alpha[k], lm(k, c), acc);
      L[c] = acc;
      acc = S(0);
      for (int k = 0; k < NC; ++k)
        if (pbit(UP, k, c)) acc = madd(alpha[k], um(k, c), acc);
      t[c] = acc;
    }
  } else {
    for (int c = 0; c < NC; ++c) L[c] = S(0);
  }
  if (brow) {
    for (int c = 0; c < NC; ++c) {
      S acc = S(0);
      for (int k = 0; k < NC; ++k)
        if (pbit(UP, r, k)) acc = madd(U[k], dp(k, c), acc);
      beta[c] = -acc;
    }
    for (int c = 0; c < NC; ++c) {
      S acc = S(0);
      for (int k = 0; k < NC; ++k)
        if (pbit(LP, k, c)) acc = madd(beta[k], lp(k, c), acc);
      u[c] = acc;
      acc = S(0);
      for (int k = 0; k < NC; ++k)
        if (pbit(UP, k, c)) acc = madd(beta[k], up(k, c), acc);
      U[c] = acc;
    }
  } else {
    for (int c = 0; c < NC; ++c) U[c] = S(0);
  }
  // D + (alpha U(i-s) + beta L(i+s)) on the columns either product reaches
  for (int c = 0; c < NC; ++c)
    if ((arow && pcol(UP, c)) || (brow && pcol(LP, c)))
      D[c] = D[c] + (t[c] + u[c]);
}

// One PCR apply level (pcr_apply) for row r of a cell: b + alpha b(i-s) +
// beta b(i+s), with the row's alpha and beta read through al(c) / be(c)
// and the partners' right-hand sides through bm(k) / bp(k).
template <int NC, typename S, typename AA, typename BA, typename VM,
          typename VP>
SDIRK_HD S pcr_apply_row(int r, S b, bool has_m, bool has_p, const AA& al,
                         const BA& be, const VM& bm, const VP& bp) {
  using Pa = Pattern<NC>;
  if (has_m && pbit(Pa::ALPHA, 0, r)) {
    S acc = S(0);
    for (int k = 0; k < NC; ++k) acc = madd(al(k), bm(k), acc);
    b = b + acc;
  }
  if (has_p && pbit(Pa::BETA, 0, r)) {
    S acc = S(0);
    for (int k = 0; k < NC; ++k) acc = madd(be(k), bp(k), acc);
    b = b + acc;
  }
  return b;
}

}  // namespace sdirk
