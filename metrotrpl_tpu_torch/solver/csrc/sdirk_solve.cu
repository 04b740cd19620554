// Fixed-step SDIRK integration of the scaled drift-diffusion PDE (the std
// model or the shallow-trap model) for a batch of simulations, one CUDA
// thread block per simulation.
//
// Replaces metrotrpl_tpu/solver/pallas_step.py:_solve_kernel (the package's
// only Pallas kernel), both of its model instantiations (std, C=3, and
// traps, C=4). Plain PyTorch version of the same function:
// metrotrpl_tpu_torch/solver/sdirk.py:integrate_observables; wrapper and
// launch counts: metrotrpl_tpu_torch/solver/solve_kernel.py.
//
// What it computes, per simulation: every step of the time grid, each of
// the scheme's implicit stages solved by damped modified Newton through a
// parallel-cyclic-reduction (PCR) factorization of I - h*gamma*J; the
// factorization is reused over ramp_block steps in [0, n_ramp) and over
// refactor_every steps on the plateau (chord mode). It streams, at every
// knot, dx * sum of the scaled TRPL and TRTS observables and the max
// |last Newton update| residual.
//
// Templated on the scalar type (float for the walk, double for the
// escalation rung) and on the model's component count NC (3: std, 4:
// traps); four C entry points instantiate the four combinations. Two
// designs, picked per launch by shape_of below: a thread per block row
// (Sim) for double at every width and for float past 128 cells, and a
// thread per cell (CellSim) for float up to 128 cells.
//
// A thread per block row (Sim; replaces the Pallas kernel's plane code
// for the double instantiations, redesigned for this card first): one
// thread block per simulation and one thread per block row of a cell:
// thread t owns row r = t / W (so r is uniform across a warp) of cell t %
// W, NC * W threads with W = nx rounded up to a warp (384 for std, 512 for
// traps at nx = 128). Each thread computes its own row of everything: the
// RHS, the Jacobian and Newton-matrix rows, its row of each block inverse
// (cofactors for std, the Schur form for traps), its rows of every PCR
// factor and apply level, and its update. The block algebra runs on
// compile-time non-zero patterns (Pattern<NC> in the header, which the
// tests hold equal to solve_kernel.pcr_patterns), and double uses fused
// multiply-adds (madd). Rows cross shared memory only where another
// thread reads them, one barrier per exchange: a Newton iteration
// publishes the state once (each thread recomputes both edge currents of
// its cell, bit for bit as the neighbour does), exchanges the right-hand
// side once per apply level in two alternating plane sets, once more for
// the row of the final Dinv, and takes its damping max through per-warp
// slots: 10 barriers at nx = 128. A factor level exchanges D (for the
// inverse) and then Dinv, L and U (for the partners at +-s): two
// barriers, ~16 a factorization. Up to 128 cells the per-level alpha and
// beta rows that are not zero live in shared memory (7 levels at nx =
// 128: 105 of 126 values per cell for std, 140 of 224 for traps; 205 KiB
// for traps in double, under the 227 KiB opt-in). Past 128 cells a thread
// owns two cells (up to 256) or up to eight, and keeps their factors in
// local memory: 8 levels of factors for 256 cells no longer fit in shared
// memory in double.
//
// A thread per cell (CellSim; the float instantiations up to 128 cells,
// which the walk runs every iteration): one block of 32, 64 or 128
// threads per simulation (nx rounded up to a power of two of warps), and
// thread t of warp w, lane l owns every row of cell i = l * NW + w. It
// calls the same per-row header functions for r = 0 .. NC-1 on the same
// operands, so each output entry takes the same operations and the
// outputs are Sim's bit for bit. With cells dealt round the warps, two
// cells s apart with NW | s sit in one warp s / NW lanes apart: the PCR
// levels from s = NW on exchange by warp shuffles, without barrier or
// shared memory, and only the neighbours and the levels below NW cross
// shared memory, one barrier each (two buffers used in turn). The cell's
// D never leaves its thread, so the inverse needs no exchange. Barriers at
// nx = 128 (NW = 4): a Newton iteration 4 (the state, apply levels 1 and
// 2, the damping max), a factorization 3 (the state, levels 1 and 2), an
// emit 1 (warp 0 sums the cells 32w .. 32w+31 of every warp w and the
// warps' sums in order, as Sim does); at nx <= 32 none (one warp). The
// blocks are small, so several simulations share an SM: at nx = 128 3 std
// blocks (75.6 KB of shared memory each, 128 registers a thread) or 2
// traps blocks (96.6 KB, 143 registers) per SM, so the fused E=8 walk's
// 384 std rows run in one wave.
//
// What bounds it on an H100: latency, not bandwidth or FLOPs. By the
// operations the function needs (solve_kernel.solve_flops: 1.3 GFLOP for
// std float on the fast plan, 4.1 GFLOP for traps double on the rung
// plan, at B=48, nx=128) it could finish in 0.02-0.12 ms at the card's
// non-tensor-core peak. Each simulation is one block on one SM, and each
// Newton iteration is a chain of dependent exchanges, so a call costs
// about the same for 1 row as for 48 (the float64 rung runs ~9) and its
// time is the chain's length: barriers per step, and the serial work
// between them. Sim shortens the chain by spreading a cell's rows over
// threads, CellSim by keeping a cell's rows in one thread (their work is
// independent, so it overlaps) and most exchanges inside a warp.
// Thread-block clusters and tensor-core block products are later work
// (PERF.md); tensor cores do not suit the float solve (TF32 keeps 10
// mantissa bits, and the chord solve amplifies rounding).
//
// Numerics: no fast math. The failure predicates downstream compare
// against 4*FLT_MIN and the tail clamp against FLT_MIN, so denormals must
// not flush; build without --use_fast_math, -ftz=true or -prec-div=false.

#include <cuda_runtime.h>

#include "sdirk_solve.cuh"

namespace sdirk {

constexpr double NEWTON_DAMP = 2.0;

template <typename S>
struct Scheme {
  int n_stages;
  S A[3][3];
  S gamma;
};

struct Plan {
  int n_steps;
  int newton_iters;
  int n_phase1;   // steps of phase 1 (n_ramp, or n_steps without chord)
  int ramp_block; // factorization period in phase 1
  int refactor;   // factorization period in phase 2 (from n_phase1 on)
  int ni_plateau; // Newton iterations per stage in phase 2
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide reductions read the bit patterns of |v|: for non-negative
// IEEE values the unsigned order is the numeric order, and a NaN (its sign
// cleared) lies above +inf, so the max lets NaN win, as jnp.max /
// torch.amax do. One redux instruction per 32 bits.
__device__ __forceinline__ float warp_absmax(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu,
                                           __float_as_uint(fabsf(v))));
}

__device__ __forceinline__ double warp_absmax(double v) {
  const unsigned long long u = __double_as_longlong(fabs(v));
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(u >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, (unsigned)(u >> 32) == hi ? (unsigned)u : 0u);
  return __longlong_as_double((long long)(((unsigned long long)hi << 32) |
                                          lo));
}

// max of a (>= 0, or NaN with its sign cleared) and |b| by their bits:
// NaN above +inf, as warp_absmax orders them
__device__ __forceinline__ float max_abs_bits(float a, float b) {
  const unsigned ua = __float_as_uint(a), ub = __float_as_uint(fabsf(b));
  return __uint_as_float(ua > ub ? ua : ub);
}

// Per-thread context of one simulation of an NC-component model: thread t
// owns row r = t / W of the cells i = q * W + t % W, q < cpt (CPT = 1: one
// cell per thread, at nx <= 128; CPT = 2: two, at nx <= 256; CPT = 8: up
// to eight, at larger nx).
// Shared planes hold one value per cell at stride ld() (128 with one cell
// per thread, a compile-time constant, so plane offsets are immediates).
template <typename S, int NC, int CPT>
struct Sim {
  using Mo = Model<NC>;
  using Pa = Pattern<NC>;
  static constexpr int NBK = NC * NC;
  // factors in shared memory (one cell per thread), or thread-local
  static constexpr bool FAC_SMEM = CPT == 1;
  static constexpr int LD1 = 128;  // plane stride with one cell per thread
  static constexpr int NA = popc(Pa::ALPHA), NB = popc(Pa::BETA);
  static constexpr int FAC_PLANES = (NA + NB) * NC;  // per level
  // planes of the Newton exchanges: the state and two apply buffers
  static constexpr int NEWTON_PLANES = 3 * NC;
  static constexpr int REGION = cmax(2 * NBK, NEWTON_PLANES);
  static constexpr int RED = 128;  // two slot sets x two sums x 32 warps
  static constexpr int LFAC = FAC_SMEM ? 1 : CPT == 2 ? 8 : MAX_LEVELS;

  // Shared memory, in scalars: xi (NBK planes: Dinv at each level, then
  // the final Dinv), the region (L and U of a level, a plane per block
  // entry of which only the level's non-zero pattern is written and read;
  // or the state and the two apply buffers), xd (NBK planes: D of a level;
  // it aliases xi in the thread-local variant, which then takes two more
  // barriers per level), the reduction slots, the parameters, and the
  // factors (FAC_SMEM: FAC_PLANES per level, the rows of alpha and beta
  // that are non-zero). Every offset but the last is a compile-time
  // constant with one cell per thread, and a row's planes lie at r * NC
  // plus a constant, so that the addresses need few registers.
  static constexpr int XD_PLANE = NBK + REGION;
  static constexpr int PLANES = NBK + REGION + (FAC_SMEM ? NBK : 0);
  static constexpr int SCRATCH = RED + N_PARAM + (N_PARAM & 1);
  static size_t smem_scalars(int n, int n_levels) {
    const size_t L = FAC_SMEM ? LD1 : n;
    return PLANES * L + SCRATCH +
           (FAC_SMEM ? (size_t)n_levels * FAC_PLANES * L : 0);
  }

  int r, j, W, n, cpt, n_levels;
  S* base;
  int red_par;
  S fa[CPT][LFAC][NC];       // thread-local alpha / beta rows
  S fb[CPT][LFAC][NC];

  __device__ int ld() const { return FAC_SMEM ? LD1 : n; }
  // cells of this thread: a compile-time count (1 or 2) keeps the
  // per-cell arrays in registers
  __device__ int nq() const { return CPT == 8 ? cpt : CPT; }
  __device__ int cell(int q) const { return q * W + j; }
  __device__ bool act(int q) const { return q < nq() && cell(q) < n; }

  __device__ void init(S* smem, int nx, int levels, int w, int cells) {
    r = threadIdx.x / w;
    j = threadIdx.x % w;
    W = w;
    n = nx;
    cpt = cells;
    n_levels = levels;
    base = smem;
    red_par = 0;
  }

  __device__ S* xi() const { return base; }
  __device__ S* region() const { return base + NBK * ld(); }
  __device__ S* xl() const { return region(); }
  __device__ S* xu() const { return region() + NBK * ld(); }
  __device__ S* xy() const { return region(); }
  __device__ S* xb(int k) const { return region() + (NC + k * NC) * ld(); }
  __device__ S* xd() const { return FAC_SMEM ? base + XD_PLANE * ld() : base; }
  __device__ S* red() const { return base + PLANES * ld(); }
  __device__ Params<S>* p() const {
    return reinterpret_cast<Params<S>*>(red() + RED);
  }
  __device__ S* fst() const { return red() + SCRATCH; }
  // Offset of this row's alpha (beta) planes in a level of the factor
  // storage. In traps double, at the 128-register cap of 512 threads, it
  // is computed at each use from an opaque copy of r: hoisted and held
  // across the whole solve, such offsets spill (12 B; the copy costs ~1 %
  // of the time, so the other instantiations go without).
  __device__ int fac_row(bool beta) const {
    int rr = r;
    if constexpr (NC == 4 && sizeof(S) == 8) asm volatile("" : "+r"(rr));
    return (beta ? NA + pidx(Pa::BETA, 0, rr) : pidx(Pa::ALPHA, 0, rr)) *
           NC * ld();
  }

  // Block-wide NaN-winning max of |v|; every thread gets the result. Each
  // warp writes its slot, and after one barrier every warp reduces the
  // slots itself; the slot sets alternate between calls.
  __device__ S block_max(S v) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    S* slot = red() + 64 * red_par;
    red_par ^= 1;
    v = warp_absmax(v);
    if (lane == 0) slot[warp] = v;
    __syncthreads();
    return warp_absmax(lane < (int)(blockDim.x >> 5) ? slot[lane] : S(0));
  }

  // Block-wide sums of two values; every thread gets both.
  __device__ void block_sum2(S a, S b, S* sa, S* sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    S* slot = red() + 64 * red_par;
    red_par ^= 1;
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      slot[warp] = a;
      slot[32 + warp] = b;
    }
    __syncthreads();
    *sa = warp_sum(lane < n_warps ? slot[lane] : S(0));
    *sb = warp_sum(lane < n_warps ? slot[32 + lane] : S(0));
  }

  __device__ Cell<S> state_cell(int i) const {
    return make_cell(xy()[Mo::N * ld() + i], xy()[Mo::D * ld() + i],
                     xy()[Mo::E * ld() + i], *p());
  }

  // Publish the thread's state rows into xy (one barrier follows).
  __device__ void publish(const S* yq) {
    for (int q = 0; q < nq(); ++q)
      if (act(q)) xy()[r * ld() + cell(q)] = yq[q];
    __syncthreads();
  }

  // Row r of dy/dt of the thread's cells at the state rows yq
  // (rhs_std_planes / rhs_traps_planes). Each thread computes the currents
  // of both edges of its cell with right_edge_flux, as the cell on the
  // edge's left does: the same operands in the same order, so the two
  // cells' values of an edge agree to the bit and the divergences
  // telescope exactly, as in the plane code. One barrier.
  __device__ void rhs(const S* yq, S* out) {
    publish(yq);
    for (int q = 0; q < nq(); ++q) {
      if (!act(q)) continue;
      const int i = cell(q);
      const Cell<S> me = state_cell(i);
      S jn_l = S(0), F_l = S(0), jn_r = S(0), F_r = S(0);
      if (r != Mo::T) {  // the traps Ntrap row has no currents
        right_edge_flux(i, n, me, state_cell(i < n - 1 ? i + 1 : i), *p(),
                        &jn_r, &F_r);
        if (i > 0) {
          right_edge_flux(i - 1, n, state_cell(i - 1), me, *p(), &jn_l,
                          &F_l);
        } else {  // front surface; the surface terms cancel in F
          jn_l = surface_flux(me, p()->sf);
        }
      }
      if constexpr (NC == 3)
        out[q] = rhs_row(r, i, n, me, jn_l, F_l, jn_r, F_r, *p());
      else
        out[q] = rhs_row_traps(r, i, n, me, xy()[Mo::T * ld() + i], jn_l,
                               F_l, jn_r, F_r, *p());
    }
  }

  // The cell's full D, published in xd(), to Dinv: each row its own row
  // (inv_row: cofactors for std, the Schur form for traps), written into
  // xi, where the final level's Dinv stays for the Newton iterations (its
  // first reader, apply, passes a barrier before it reads).
  __device__ void invert() {
    S row[CPT][NC];
    for (int q = 0; q < nq(); ++q) {
      if (!act(q)) continue;
      const int i = cell(q);
      inv_row<NC>(
          r, [&](int k, int c) { return xd()[(k * NC + c) * ld() + i]; },
          row[q]);
    }
    if (!FAC_SMEM) __syncthreads();  // xd aliases xi
    for (int q = 0; q < nq(); ++q)
      if (act(q))
        for (int c = 0; c < NC; ++c)
          xi()[(r * NC + c) * ld() + cell(q)] = row[q][c];
  }

  // Publish the rows of D into xd (one barrier follows; in the
  // thread-local variant xd aliases xi(), which the last level read).
  __device__ void publish_d(const S (*D)[NC]) {
    if (!FAC_SMEM) __syncthreads();
    for (int q = 0; q < nq(); ++q)
      if (act(q))
        for (int c = 0; c < NC; ++c)
          xd()[(r * NC + c) * ld() + cell(q)] = D[q][c];
    __syncthreads();
  }

  // One PCR factor level at shift s: the rows of L and U published (they
  // are read back from shared memory, so that they are not live across
  // the inverse), Dinv of every cell, then each row's alpha and beta,
  // stored, and its next L, D, U.
  template <bool FIRST>
  __device__ void level(int lev, int s, S (*L)[NC], S (*D)[NC],
                        S (*U)[NC]) {
    publish_d(D);
    const int LDv = ld();
    // this row's entries of the L / U planes (recomputed, not held)
    auto lrow = [&](int c) { return xl() + (r * NC + c) * LDv; };
    auto urow = [&](int c) { return xu() + (r * NC + c) * LDv; };
    for (int q = 0; q < nq(); ++q) {
      if (!act(q)) continue;
      const int i = cell(q);
      for (int c = 0; c < NC; ++c) {
        if (pbit(Pa::LX, r, c)) lrow(c)[i] = L[q][c];
        if (pbit(Pa::UX, r, c)) urow(c)[i] = U[q][c];
      }
    }
    invert();
    __syncthreads();
    for (int q = 0; q < nq(); ++q) {
      if (!act(q)) continue;
      const int i = cell(q);
      const int im = i - s, ip = i + s;
      const bool has_m = im >= 0, has_p = ip < n;
      for (int c = 0; c < NC; ++c) {
        L[q][c] = pbit(Pa::LX, r, c) ? lrow(c)[i] : S(0);
        U[q][c] = pbit(Pa::UX, r, c) ? urow(c)[i] : S(0);
        // D too, where xd outlives the inverse
        if (FAC_SMEM) D[q][c] = xd()[(r * NC + c) * LDv + i];
      }
      // entry (k, c) of a partner's block in planes pl
      auto blk = [LDv](const S* pl, int j) {
        return [=](int k, int c) { return pl[(k * NC + c) * LDv + j]; };
      };
      S alpha[NC], beta[NC];
      pcr_level_row<NC, FIRST>(r, L[q], D[q], U[q], has_m, has_p,
                               blk(xi(), im), blk(xl(), im), blk(xu(), im),
                               blk(xi(), ip), blk(xl(), ip), blk(xu(), ip),
                               alpha, beta);
      if constexpr (FAC_SMEM) {
        S* f = fst() + lev * FAC_PLANES * LDv + i;
        const int oa = fac_row(false), ob = fac_row(true);
        for (int c = 0; c < NC; ++c) {
          if (pbit(Pa::ALPHA, 0, r)) f[oa + c * LDv] = alpha[c];
          if (pbit(Pa::BETA, 0, r)) f[ob + c * LDv] = beta[c];
        }
      } else {
        for (int c = 0; c < NC; ++c) {
          fa[q][lev][c] = alpha[c];
          fb[q][lev][c] = beta[c];
        }
      }
    }
  }

  // PCR factorization of M = I - hg*J(y) (sdirk_factors + pcr_factor).
  // Each thread computes the Jacobians of both edges of its cell with
  // own_edge_jac, as the cell on the edge's left does (same operands, same
  // bits), so the state is the only exchange before level 0.
  __device__ void factor(const S* yq, S hg) {
    publish(yq);
    S L[CPT][NC], D[CPT][NC], U[CPT][NC];
    for (int q = 0; q < nq(); ++q) {
      if (!act(q)) continue;
      const int i = cell(q);
      const Cell<S> me = state_cell(i);
      const EdgeJac<S> ek =
          own_edge_jac(i, n, me, state_cell(i < n - 1 ? i + 1 : i), *p());
      EdgeJac<S> ep = {S(0), S(0), S(0), S(0), S(0), S(0), S(0), S(0)};
      if (i > 0) ep = own_edge_jac(i - 1, n, state_cell(i - 1), me, *p());
      S JL[NC], JD[NC], JU[NC];
      if constexpr (NC == 3)
        jac_row(r, i, n, me, ek, ep, *p(), JL, JD, JU);
      else
        jac_row_traps(r, i, n, me, xy()[Mo::T * ld() + i], ek, ep, *p(), JL,
                      JD, JU);
      for (int c = 0; c < NC; ++c) {
        D[q][c] = c == r ? S(1) - hg * JD[c] : -hg * JD[c];
        L[q][c] = -hg * JL[c];
        U[q][c] = -hg * JU[c];
      }
    }
    int s = 1;
    for (int lev = 0; lev < n_levels; ++lev, s *= 2) {
      if (lev == 0)
        level<true>(lev, s, L, D, U);
      else
        level<false>(lev, s, L, D, U);
    }
    publish_d(D);
    invert();
  }

  // x = M^-1 b with the stored factors (pcr_apply): one barrier per
  // level, the right-hand sides alternating between two plane sets, then
  // one more exchange for the row of the final Dinv (in xi).
  __device__ void apply(const S* g, S* x) {
    S b[CPT];
    for (int q = 0; q < nq(); ++q) b[q] = act(q) ? g[q] : S(0);
    const int LDv = ld();
    const int oa = FAC_SMEM ? fac_row(false) : 0;
    const int ob = FAC_SMEM ? fac_row(true) : 0;
    int s = 1;
    for (int lev = 0; lev < n_levels; ++lev, s *= 2) {
      S* bb = xb(lev & 1);
      for (int q = 0; q < nq(); ++q)
        if (act(q)) bb[r * LDv + cell(q)] = b[q];
      __syncthreads();
      for (int q = 0; q < nq(); ++q) {
        if (!act(q)) continue;
        const int i = cell(q);
        const int im = i - s, ip = i + s;
        auto bm = [&](int k) { return bb[k * LDv + im]; };
        auto bp = [&](int k) { return bb[k * LDv + ip]; };
        if constexpr (FAC_SMEM) {
          const S* f = fst() + lev * FAC_PLANES * LDv + i;
          b[q] = pcr_apply_row<NC>(
              r, b[q], im >= 0, ip < n, [&](int c) { return f[oa + c * LDv]; },
              [&](int c) { return f[ob + c * LDv]; }, bm, bp);
        } else {
          b[q] = pcr_apply_row<NC>(
              r, b[q], im >= 0, ip < n, [&](int c) { return fa[q][lev][c]; },
              [&](int c) { return fb[q][lev][c]; }, bm, bp);
        }
      }
    }
    S* bb = xb(n_levels & 1);
    for (int q = 0; q < nq(); ++q)
      if (act(q)) bb[r * LDv + cell(q)] = b[q];
    __syncthreads();
    for (int q = 0; q < nq(); ++q) {
      if (!act(q)) continue;
      const int i = cell(q);
      S acc = S(0);
      for (int k = 0; k < NC; ++k)
        acc = madd(xi()[(r * NC + k) * LDv + i], bb[k * LDv + i], acc);
      x[q] = acc;
    }
  }

  // One step's stage sweep with the current factors (sdirk_stages).
  // Advances the state rows y in place; returns the step's residual. The
  // stage derivatives are read through selects on constant indices, so
  // that they stay in registers; the Butcher table is a grid constant
  // (sc lies in the kernel's parameter space, which takes a run-time
  // index without a local copy).
  __device__ S stages(S* y, S h, const Scheme<S>& sc, int ni) {
    S fs[3][CPT];
    S Y[CPT], acc[CPT];
    S resid = S(0);
    bool have_resid = false;
    auto coef = [&](int a, int b) { return sc.A[a][b]; };
    auto set_fs = [&](int st, int q, S v) {
      if (st == 0)
        fs[0][q] = v;
      else if (st == 1)
        fs[1][q] = v;
      else
        fs[2][q] = v;
    };
    for (int q = 0; q < CPT; ++q) Y[q] = y[q];
    for (int st = 0; st < sc.n_stages; ++st) {
      for (int q = 0; q < CPT; ++q) acc[q] = y[q];
      for (int jj = 0; jj < st; ++jj) {
        const S a = coef(st, jj);
        if (a != S(0))
          for (int q = 0; q < CPT; ++q)
            acc[q] = acc[q] + (h * a) * (jj == 0 ? fs[0][q] : fs[1][q]);
      }
      if (coef(st, st) == S(0)) {  // explicit first stage (ESDIRK)
        S f[CPT];
        rhs(y, f);
        for (int q = 0; q < CPT; ++q) set_fs(st, q, f[q]);
        continue;
      }
      for (int q = 0; q < CPT; ++q) Y[q] = acc[q];
      S rs = S(0);
      for (int it = 0; it < ni; ++it) {
        S f[CPT], G[CPT], d[CPT];
        rhs(Y, f);
        for (int q = 0; q < CPT; ++q)
          G[q] = act(q) ? Y[q] - h * sc.gamma * f[q] - acc[q] : S(0);
        apply(G, d);
        // max |d| over every plane (_maxabs_update), NaN winning
        S m = S(0);
        for (int q = 0; q < nq(); ++q)
          if (act(q)) m = q == 0 ? abs_(d[q]) : nan_max(m, abs_(d[q]));
        const S dmax = block_max(m);
        // trust-region damping: scale the update so max|d| <= cap
        // (1 without the division where max|d| <= cap: cap / cap == 1)
        const S cap = S(NEWTON_DAMP);
        const S sc_ = dmax <= cap ? S(1)
                                  : nan_min(S(1), cap / nan_max(dmax, cap));
        for (int q = 0; q < nq(); ++q) {
          if (!act(q)) continue;
          d[q] = sc_ * d[q];
          Y[q] = Y[q] - d[q];
        }
        // max|s*d| == s*max|d| exactly (rounding is monotone, s >= 0)
        rs = sc_ * dmax;
      }
      resid = have_resid ? nan_max(resid, rs) : rs;
      have_resid = true;
      for (int q = 0; q < CPT; ++q)
        set_fs(st, q, (Y[q] - acc[q]) / (h * sc.gamma));
    }
    for (int q = 0; q < CPT; ++q) y[q] = Y[q];
    return resid;
  }
};

template <typename S, int NC, int CPT>
__global__ void __launch_bounds__(NC * 128)
sdirk_solve_kernel(const S* __restrict__ dt, const S* __restrict__ y0,
                   const S* __restrict__ par, const S* __restrict__ dx,
                   S* __restrict__ pl_out, S* __restrict__ tr_out,
                   S* __restrict__ rs_out, int nx, int n_levels, int W,
                   int cpt, const __grid_constant__ Scheme<S> sc,
                   const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int b = blockIdx.x;
  Sim<S, NC, CPT> sim;
  sim.init(reinterpret_cast<S*>(smem_raw), nx, n_levels, W, cpt);
  if (threadIdx.x < N_PARAM)
    reinterpret_cast<S*>(sim.p())[threadIdx.x] =
        par[(size_t)b * N_PARAM + threadIdx.x];
  __syncthreads();

  const int n_out = plan.n_steps + 1;
  const S* dt_b = dt + (size_t)b * plan.n_steps;
  const S dxb = dx[b];
  S y[CPT];
  for (int q = 0; q < CPT; ++q)
    y[q] = sim.act(q) ? y0[((size_t)b * NC + sim.r) * nx + sim.cell(q)]
                      : S(0);

  // Observables of the state at knot k, summed by row 0 over its cells:
  // each knot written on its own, so a NaN step stays in its own knot.
  auto emit = [&](int k, S resid) {
    sim.publish(y);
    S m = S(0), t = S(0);
    if (sim.r == 0)
      for (int q = 0; q < sim.nq(); ++q) {
        if (!sim.act(q)) continue;
        const Cell<S> c = sim.state_cell(sim.cell(q));
        m = q == 0 ? c.M : m + c.M;
        const S tq = sim.p()->diff_n * c.dN + sim.p()->diff_p * c.dP;
        t = q == 0 ? tq : t + tq;
      }
    S sm, st;
    sim.block_sum2(m, t, &sm, &st);
    if (threadIdx.x == 0) {
      pl_out[(size_t)b * n_out + k] = dxb * sm;
      tr_out[(size_t)b * n_out + k] = dxb * st;
      rs_out[(size_t)b * n_out + k] = resid;
    }
  };

  emit(0, S(0));
  // phase 1: [0, n_phase1) in blocks of ramp_block; phase 2: the plateau
  // in blocks of refactor. dt is constant inside a block (the plan's
  // contract; the wrapper checks that the block sizes divide the phases),
  // so the block's first dt serves every step.
  for (int phase = 0; phase < 2; ++phase) {
    const int k_lo = phase == 0 ? 0 : plan.n_phase1;
    const int k_hi = phase == 0 ? plan.n_phase1 : plan.n_steps;
    const int F = phase == 0 ? plan.ramp_block : plan.refactor;
    const int ni = phase == 0 ? plan.newton_iters : plan.ni_plateau;
    for (int k0 = k_lo; k0 < k_hi; k0 += F) {
      const S h = dt_b[k0];
      sim.factor(y, h * sc.gamma);
      for (int k = k0; k < k0 + F; ++k) {
        const S r = sim.stages(y, h, sc, ni);
        emit(k + 1, r);
      }
    }
  }
}

// ---- the float design up to 128 cells: a thread per cell ----

// Per-thread context of one simulation in which thread t owns every row
// of one cell, i = lane * NW + warp for NW = blockDim.x / 32 warps (1, 2
// or 4, a power of two). Cells that lie s apart with NW | s sit on
// lanes s / NW apart in one warp, so every exchange at a shift s >= NW
// (the PCR levels from s = NW on, and at NW = 1 the neighbours too) is a
// warp shuffle, and only the shifts below NW (the neighbours and the
// levels s = 1, 2 at NW = 4) go through shared memory, one barrier each.
// Each thread calls the header's per-row functions for r = 0 .. NC-1 on
// the operands the thread-per-row design (Sim) gives them, so every
// output entry is computed by the same operations.
//
// Shared memory, in scalars: the parameters, two sets of per-warp
// reduction slots, two exchange buffers of NX planes (none with one warp)
// and the factors, FAC_PLANES per level. The exchanges use the buffers in
// turn, so between two writes of one buffer lies the other's barrier,
// which every reader of the first has passed: one barrier an exchange.
// Planes hold one value per thread at stride LD = blockDim.x, at the
// thread's index: a warp's lanes touch consecutive words.
template <typename S, int NC>
struct CellSim {
  using Mo = Model<NC>;
  using Pa = Pattern<NC>;
  static constexpr unsigned FULL = 0xffffffffu;
  static constexpr int NA = popc(Pa::ALPHA), NB = popc(Pa::BETA);
  static constexpr int FAC_PLANES = (NA + NB) * NC;  // per level
  // the rows of a partner's Dinv that the alpha rows read at -s (DM) and
  // the beta rows at +s (DP)
  static constexpr unsigned DM = rows_read(Pa::LX, Pa::ALPHA);
  static constexpr unsigned DP = rows_read(Pa::UX, Pa::BETA);
  static constexpr unsigned DX = DM | DP;
  // what a factor level exchanges: the Dinv rows DX, L on LX, U on UX
  static constexpr int NDI = popc(DX) * NC;
  static constexpr int NLX = popc(Pa::LX), NUX = popc(Pa::UX);
  static constexpr int NX = NDI + NLX + NUX;
  static_assert(NX >= NC && NX >= 3, "a buffer holds a state or a b");
  static constexpr int PAR = N_PARAM + (N_PARAM & 1);
  static constexpr int RED = 64;  // two slot sets x up to 32 warps

  static size_t smem_scalars(int threads, int n_levels) {
    const size_t ld = threads;
    return PAR + RED + (threads > 32 ? 2 * NX * ld : 0) +
           (size_t)n_levels * FAC_PLANES * ld;
  }

  int tid, lane, warp, NW, lg, i, n, n_levels, LD;
  S* base;
  int xpar, red_par;
  Params<S> P;
  S Dv[NC][NC];  // Dinv of the cell's final D, for the Newton iterations

  __device__ void init(S* smem, int nx, int levels) {
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    NW = blockDim.x >> 5;
    lg = 0;
    while ((1 << lg) < NW) ++lg;
    i = lane * NW + warp;
    n = nx;
    n_levels = levels;
    LD = blockDim.x;
    base = smem;
    xpar = red_par = 0;
  }

  __device__ bool act() const { return i < n; }
  // the parameters, staged in shared memory by the kernel, then held
  __device__ S* par_smem() const { return base; }
  __device__ void load_params() { P = *reinterpret_cast<Params<S>*>(base); }
  __device__ S* red() const { return base + PAR; }
  __device__ S* fst() const {
    return base + PAR + RED + (NW > 1 ? 2 * NX * LD : 0);
  }
  // index of cell j in the exchange planes (the index of its thread)
  __device__ int pos(int j) const { return (j & (NW - 1)) * 32 + (j >> lg); }
  __device__ S* next_buf() {
    S* x = base + PAR + RED + xpar * NX * LD;
    xpar ^= 1;
    return x;
  }
  __device__ void sync() const {
    if (NW == 1)
      __syncwarp();
    else
      __syncthreads();
  }

  // The values v of the cells i - s (lo) and i + s (hi): by warp shuffles
  // where both lie in this warp (s >= NW), else through the next exchange
  // buffer behind one barrier. Every thread calls it alike; for a partner
  // outside the grid it returns another lane's values or its own, which
  // the caller does not use.
  template <int K>
  __device__ void exchange(const S (&v)[K], int s, S (&lo)[K], S (&hi)[K]) {
    if (s >= NW) {
      const int d = s >> lg;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lo[k] = __shfl_up_sync(FULL, v[k], d);
        hi[k] = __shfl_down_sync(FULL, v[k], d);
      }
      return;
    }
    S* x = next_buf();
#pragma unroll
    for (int k = 0; k < K; ++k) x[k * LD + tid] = v[k];
    __syncthreads();
    const S* qm = x + (i - s >= 0 ? pos(i - s) : tid);
    const S* qp = x + (i + s < n ? pos(i + s) : tid);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lo[k] = qm[k * LD];
      hi[k] = qp[k * LD];
    }
  }

  // The block's NaN-winning max of |v| (v >= 0 or NaN, sign cleared);
  // every thread gets it.
  __device__ S block_max(S v) {
    v = warp_absmax(v);
    if (NW == 1) return v;
    S* slot = red() + 32 * red_par;
    red_par ^= 1;
    if (lane == 0) slot[warp] = v;
    __syncthreads();
    return warp_absmax(lane < NW ? slot[lane] : S(0));
  }

  // The cell, and its neighbours i - 1 (lo; read where i > 0) and i + 1
  // (hi; the cell itself at the last cell, as Sim reads it), from the
  // state rows y.
  __device__ void cells(const S (&y)[NC], Cell<S>* lo, Cell<S>* me,
                        Cell<S>* hi) {
    const S v[3] = {y[Mo::N], y[Mo::D], y[Mo::E]};
    S vl[3], vh[3];
    exchange(v, 1, vl, vh);
    *me = make_cell(v[0], v[1], v[2], P);
    *hi = i < n - 1 ? make_cell(vh[0], vh[1], vh[2], P) : *me;
    *lo = make_cell(vl[0], vl[1], vl[2], P);
  }

  // dy/dt of the cell's rows (Sim::rhs): both edge currents, then each
  // row. One exchange.
  __device__ void rhs(const S (&y)[NC], S (&out)[NC]) {
    Cell<S> lo, me, hi;
    cells(y, &lo, &me, &hi);
    S jn_l = S(0), F_l = S(0), jn_r = S(0), F_r = S(0);
    right_edge_flux(i, n, me, hi, P, &jn_r, &F_r);
    if (i > 0)
      right_edge_flux(i - 1, n, lo, me, P, &jn_l, &F_l);
    else  // front surface; the surface terms cancel in F
      jn_l = surface_flux(me, P.sf);
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      if constexpr (NC == 3)
        out[r] = rhs_row(r, i, n, me, jn_l, F_l, jn_r, F_r, P);
      else
        out[r] = rhs_row_traps(r, i, n, me, y[Mo::T], jn_l, F_l, jn_r, F_r,
                               P);
    }
  }

  __device__ static void invert(const S (&D)[NC][NC], S (&Di)[NC][NC]) {
#pragma unroll
    for (int r = 0; r < NC; ++r)
      inv_row<NC>(r, [&D](int k, int c) { return D[k][c]; }, Di[r]);
  }

  // entries of a packed level exchange: the Dinv rows DX, L on LX, U on UX
  SDIRK_HD static constexpr int di_at(int k, int c) {
    return popc(DX & ((1u << k) - 1u)) * NC + c;
  }
  SDIRK_HD static constexpr int l_at(int k, int c) {
    return NDI + pidx(Pa::LX, k, c);
  }
  SDIRK_HD static constexpr int u_at(int k, int c) {
    return NDI + NLX + pidx(Pa::UX, k, c);
  }

  // One PCR factor level at shift s (Sim::level): the cell's Dinv, the
  // partners' Dinv, L and U in one exchange, then each row's alpha and
  // beta, stored, and its next L, D, U.
  template <bool FIRST>
  __device__ void level(int lev, int s, S (&L)[NC][NC], S (&D)[NC][NC],
                        S (&U)[NC][NC]) {
    S Di[NC][NC];
    invert(D, Di);
    S v[NX], lo[NX], hi[NX];
#pragma unroll
    for (int k = 0; k < NC; ++k)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if ((DX >> k) & 1u) v[di_at(k, c)] = Di[k][c];
        if (pbit(Pa::LX, k, c)) v[l_at(k, c)] = L[k][c];
        if (pbit(Pa::UX, k, c)) v[u_at(k, c)] = U[k][c];
      }
    exchange(v, s, lo, hi);
    const bool has_m = i - s >= 0, has_p = i + s < n;
    // entry (k, c) of a partner's Dinv, L or U in its exchanged values
    auto di = [](const S(&w)[NX]) {
      return [&w](int k, int c) { return w[di_at(k, c)]; };
    };
    auto lx = [](const S(&w)[NX]) {
      return [&w](int k, int c) { return w[l_at(k, c)]; };
    };
    auto ux = [](const S(&w)[NX]) {
      return [&w](int k, int c) { return w[u_at(k, c)]; };
    };
    S* f = fst() + lev * FAC_PLANES * LD + tid;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      S alpha[NC], beta[NC];
      pcr_level_row<NC, FIRST>(r, L[r], D[r], U[r], has_m, has_p,
                               di(lo), lx(lo), ux(lo), di(hi), lx(hi),
                               ux(hi), alpha, beta);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (pbit(Pa::ALPHA, 0, r))
          f[(pidx(Pa::ALPHA, 0, r) * NC + c) * LD] = alpha[c];
        if (pbit(Pa::BETA, 0, r))
          f[((NA + pidx(Pa::BETA, 0, r)) * NC + c) * LD] = beta[c];
      }
    }
  }

  // PCR factorization of M = I - hg*J(y) (Sim::factor): the cell's own
  // Jacobian rows from its edges, the levels, and the final Dinv, which
  // the thread keeps.
  __device__ void factor(const S (&y)[NC], S hg) {
    Cell<S> lo, me, hi;
    cells(y, &lo, &me, &hi);
    const EdgeJac<S> ek = own_edge_jac(i, n, me, hi, P);
    EdgeJac<S> ep = {S(0), S(0), S(0), S(0), S(0), S(0), S(0), S(0)};
    if (i > 0) ep = own_edge_jac(i - 1, n, lo, me, P);
    S L[NC][NC], D[NC][NC], U[NC][NC];
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      S JL[NC], JD[NC], JU[NC];
      if constexpr (NC == 3)
        jac_row(r, i, n, me, ek, ep, P, JL, JD, JU);
      else
        jac_row_traps(r, i, n, me, y[Mo::T], ek, ep, P, JL, JD, JU);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        D[r][c] = c == r ? S(1) - hg * JD[c] : -hg * JD[c];
        L[r][c] = -hg * JL[c];
        U[r][c] = -hg * JU[c];
      }
    }
    int s = 1;
    for (int lev = 0; lev < n_levels; ++lev, s *= 2) {
      if (lev == 0)
        level<true>(lev, s, L, D, U);
      else
        level<false>(lev, s, L, D, U);
    }
    invert(D, Dv);
  }

  // x = M^-1 g with the stored factors (Sim::apply): one exchange of the
  // cell's right-hand side per level, then the thread's own Dinv.
  __device__ void apply(const S (&g)[NC], S (&x)[NC]) {
    S b[NC];
#pragma unroll
    for (int r = 0; r < NC; ++r) b[r] = g[r];
    int s = 1;
    for (int lev = 0; lev < n_levels; ++lev, s *= 2) {
      // the level's factors first, all at once: their loads overlap the
      // exchange, and the rows' updates below wait on nothing else
      const S* f = fst() + lev * FAC_PLANES * LD + tid;
      S fv[FAC_PLANES];
#pragma unroll
      for (int e = 0; e < FAC_PLANES; ++e) fv[e] = f[e * LD];
      S lo[NC], hi[NC];
      exchange(b, s, lo, hi);
      const bool has_m = i - s >= 0, has_p = i + s < n;
      // each side's update computed whatever the partner and kept only
      // where the partner exists: the operations of
      // pcr_apply_row(r, b, has_m, has_p, ...), without a branch per row,
      // so that the rows' chains overlap
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        auto al = [&](int c) { return fv[pidx(Pa::ALPHA, 0, r) * NC + c]; };
        auto be = [&](int c) {
          return fv[(NA + pidx(Pa::BETA, 0, r)) * NC + c];
        };
        auto bm = [&](int k) { return lo[k]; };
        auto bp = [&](int k) { return hi[k]; };
        const S bm_r = pcr_apply_row<NC>(r, b[r], true, false, al, be, bm, bp);
        b[r] = has_m ? bm_r : b[r];
        const S bp_r = pcr_apply_row<NC>(r, b[r], false, true, al, be, bm, bp);
        b[r] = has_p ? bp_r : b[r];
      }
    }
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      S acc = S(0);
#pragma unroll
      for (int k = 0; k < NC; ++k) acc = madd(Dv[r][k], b[k], acc);
      x[r] = acc;
    }
  }

  // One step's stage sweep with the current factors (Sim::stages, its
  // rows held by one thread). Advances y in place; returns the step's
  // residual.
  __device__ S stages(S (&y)[NC], S h, const Scheme<S>& sc, int ni) {
    S fs[3][NC];
    S Y[NC], acc[NC];
    S resid = S(0);
    bool have_resid = false;
    auto coef = [&](int a, int b) { return sc.A[a][b]; };
    auto set_fs = [&](int st, int r, S v) {
      if (st == 0)
        fs[0][r] = v;
      else if (st == 1)
        fs[1][r] = v;
      else
        fs[2][r] = v;
    };
#pragma unroll
    for (int r = 0; r < NC; ++r) Y[r] = y[r];
    for (int st = 0; st < sc.n_stages; ++st) {
#pragma unroll
      for (int r = 0; r < NC; ++r) acc[r] = y[r];
      for (int jj = 0; jj < st; ++jj) {
        const S a = coef(st, jj);
        if (a != S(0))
#pragma unroll
          for (int r = 0; r < NC; ++r)
            acc[r] = acc[r] + (h * a) * (jj == 0 ? fs[0][r] : fs[1][r]);
      }
      if (coef(st, st) == S(0)) {  // explicit first stage (ESDIRK)
        S f[NC];
        rhs(y, f);
#pragma unroll
        for (int r = 0; r < NC; ++r) set_fs(st, r, f[r]);
        continue;
      }
#pragma unroll
      for (int r = 0; r < NC; ++r) Y[r] = acc[r];
      S rs = S(0);
      for (int it = 0; it < ni; ++it) {
        S f[NC], G[NC], d[NC];
        rhs(Y, f);
#pragma unroll
        for (int r = 0; r < NC; ++r)
          G[r] = act() ? Y[r] - h * sc.gamma * f[r] - acc[r] : S(0);
        apply(G, d);
        // max |d| over the cell's rows by the bits of |d| (NaN winning),
        // as the block max takes it
        S m = S(0);
        if (act())
#pragma unroll
          for (int r = 0; r < NC; ++r) m = max_abs_bits(m, d[r]);
        const S dmax = block_max(m);
        // trust-region damping: scale the update so max|d| <= cap
        const S cap = S(NEWTON_DAMP);
        const S sc_ = dmax <= cap ? S(1)
                                  : nan_min(S(1), cap / nan_max(dmax, cap));
        if (act())
#pragma unroll
          for (int r = 0; r < NC; ++r) {
            d[r] = sc_ * d[r];
            Y[r] = Y[r] - d[r];
          }
        rs = sc_ * dmax;
      }
      resid = have_resid ? nan_max(resid, rs) : rs;
      have_resid = true;
#pragma unroll
      for (int r = 0; r < NC; ++r)
        set_fs(st, r, (Y[r] - acc[r]) / (h * sc.gamma));
    }
#pragma unroll
    for (int r = 0; r < NC; ++r) y[r] = Y[r];
    return resid;
  }

  // The knot's sums of the scaled TRPL and TRTS terms over the cells, in
  // Sim's order: warp_sum over the cells 32g + l of each group g (the
  // butterfly pairs l with l ^ 16, ^ 8, .. ^ 1), then warp_sum over the
  // groups' sums in order. Cell 32g + l lies at lane (32g + l) / NW of
  // warp l % NW: the pairs at l-shifts from NW up are lanes of one warp
  // (lane shift l-shift / NW), those below NW are warps, whose partial
  // sums cross shared memory once. The second warp_sum adds exact zeros
  // from its lanes NW .. 31 (Sim's other warps sum zeros too); with a_g =
  // S_g + 0 (the first such add: it only turns -0 into +0, and later ones
  // change nothing), it is a_0 for one group, a_0 + a_1 for two and (a_0
  // + a_2) + (a_1 + a_3) for four, which thread 0 adds directly. Valid in
  // thread 0.
  __device__ void sums(const S (&y)[NC], S* sm, S* st) {
    S m = S(0), t = S(0);
    if (act()) {
      const Cell<S> c = make_cell(y[Mo::N], y[Mo::D], y[Mo::E], P);
      m = c.M;
      t = P.diff_n * c.dN + P.diff_p * c.dP;
    }
    for (int off = 16; off >= NW; off >>= 1) {
      m += __shfl_xor_sync(FULL, m, off >> lg);
      t += __shfl_xor_sync(FULL, t, off >> lg);
    }
    if (NW == 1) {
      *sm = m + S(0);
      *st = t + S(0);
      return;
    }
    // the partial sums of group g in warp w at [w * 4 + g] (+16: TRTS)
    S* x = next_buf();
    const int per = 32 >> lg;  // lanes of a group
    if (lane % per == 0) {
      x[warp * 4 + lane / per] = m;
      x[16 + warp * 4 + lane / per] = t;
    }
    __syncthreads();
    if (tid != 0) return;
    // the pairs of warps at l-shift NW / 2, then 1: each group's sum
    auto group = [&](const S* q, int g) {
      return NW == 2 ? q[g] + q[4 + g]
                     : (q[g] + q[8 + g]) + (q[4 + g] + q[12 + g]);
    };
    auto total = [&](const S* q) {
      if (NW == 2) return (group(q, 0) + S(0)) + (group(q, 1) + S(0));
      return ((group(q, 0) + S(0)) + (group(q, 2) + S(0))) +
             ((group(q, 1) + S(0)) + (group(q, 3) + S(0)));
    };
    *sm = total(x);
    *st = total(x + 16);
  }
};

template <typename S, int NC>
__global__ void __launch_bounds__(128, NC == 3 ? 3 : 2)
sdirk_cell_kernel(const S* __restrict__ dt, const S* __restrict__ y0,
                  const S* __restrict__ par, const S* __restrict__ dx,
                  S* __restrict__ pl_out, S* __restrict__ tr_out,
                  S* __restrict__ rs_out, int nx, int n_levels, int W,
                  int cpt, const __grid_constant__ Scheme<S> sc,
                  const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int b = blockIdx.x;
  CellSim<S, NC> sim;
  sim.init(reinterpret_cast<S*>(smem_raw), nx, n_levels);
  if (threadIdx.x < N_PARAM)
    sim.par_smem()[threadIdx.x] = par[(size_t)b * N_PARAM + threadIdx.x];
  sim.sync();
  sim.load_params();

  const int n_out = plan.n_steps + 1;
  const S* dt_b = dt + (size_t)b * plan.n_steps;
  const S dxb = dx[b];
  S y[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r)
    y[r] = sim.act() ? y0[((size_t)b * NC + r) * nx + sim.i] : S(0);

  // Observables of the state at knot k: each knot written on its own, so
  // a NaN step stays in its own knot.
  auto emit = [&](int k, S resid) {
    S sm, st;
    sim.sums(y, &sm, &st);
    if (threadIdx.x == 0) {
      pl_out[(size_t)b * n_out + k] = dxb * sm;
      tr_out[(size_t)b * n_out + k] = dxb * st;
      rs_out[(size_t)b * n_out + k] = resid;
    }
  };

  emit(0, S(0));
  // the phases and chord blocks of sdirk_solve_kernel
  for (int phase = 0; phase < 2; ++phase) {
    const int k_lo = phase == 0 ? 0 : plan.n_phase1;
    const int k_hi = phase == 0 ? plan.n_phase1 : plan.n_steps;
    const int F = phase == 0 ? plan.ramp_block : plan.refactor;
    const int ni = phase == 0 ? plan.newton_iters : plan.ni_plateau;
    for (int k0 = k_lo; k0 < k_hi; k0 += F) {
      const S h = dt_b[k0];
      sim.factor(y, h * sc.gamma);
      for (int k = k0; k < k0 + F; ++k) {
        const S r = sim.stages(y, h, sc, ni);
        emit(k + 1, r);
      }
    }
  }
}

// ---- the design of a grid: shared by the launch, the occupancy query
// and the CPU build of the tests ----

// Which design runs an nx-cell grid, with its block shape and dynamic
// shared memory.
struct Shape {
  bool cell;  // a thread per cell (CellSim), else per block row (Sim)
  int n_levels, cpt, W, threads;
  size_t smem;
};

// Sim's shape (the double instantiations' at every width, the float
// ones' past 128 cells): up to 128 cells a thread per block row and
// cell, the factors in shared memory; beyond, two cells per thread up to
// 256, else up to 8, the factors thread-local.
template <typename S, int NC>
Shape row_shape(int nx) {
  Shape v{false, 0, 0, 0, 0, 0};
  while ((1 << v.n_levels) < nx) ++v.n_levels;
  v.cpt = nx <= 128 ? 1 : (nx + 127) / 128;
  v.W = ((nx + v.cpt - 1) / v.cpt + 31) / 32 * 32;
  v.threads = NC * v.W;
  v.smem = (v.cpt == 1   ? Sim<S, NC, 1>::smem_scalars(nx, v.n_levels)
            : v.cpt == 2 ? Sim<S, NC, 2>::smem_scalars(nx, v.n_levels)
                         : Sim<S, NC, 8>::smem_scalars(nx, v.n_levels)) *
           sizeof(S);
  return v;
}

// The shape a launch takes: float up to 128 cells a thread per cell in
// 1, 2 or 4 warps (a power of two, so that the warps tile every PCR
// shift from NW on); everything else row_shape.
template <typename S, int NC>
Shape shape_of(int nx) {
  if (sizeof(S) != 4 || nx > 128) return row_shape<S, NC>(nx);
  Shape v{true, 0, 1, 0, 32, 0};
  while ((1 << v.n_levels) < nx) ++v.n_levels;
  while (v.threads < nx) v.threads *= 2;
  v.W = v.threads;
  v.smem = CellSim<S, NC>::smem_scalars(v.threads, v.n_levels) * sizeof(S);
  return v;
}

template <typename S, int NC>
using Kern = decltype(&sdirk_solve_kernel<S, NC, 1>);  // one signature

// The kernel of a shape_of shape (float runs Sim only past 128 cells, so
// Sim's one-cell variant is built for double alone).
template <typename S, int NC>
Kern<S, NC> kernel_of(const Shape& v) {
  if constexpr (sizeof(S) == 4) {
    if (v.cell) return sdirk_cell_kernel<S, NC>;
  } else {
    if (v.cpt == 1) return sdirk_solve_kernel<S, NC, 1>;
  }
  return v.cpt == 2 ? sdirk_solve_kernel<S, NC, 2>
                    : sdirk_solve_kernel<S, NC, 8>;
}

// ---- host side: the launch and the occupancy (the CPU build of the
// tests cuts the source here) ----

// past 48 KiB a kernel must opt in to its dynamic shared memory
template <typename S, int NC>
cudaError_t opt_in(Kern<S, NC> kern, const Shape& v) {
  if (v.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)v.smem);
}

template <typename S, int NC>
int launch(const void* dt, const void* y0, const void* par, const void* dx,
           void* pl, void* tr, void* rs, int B, int nx, int n_steps,
           int n_stages, const double* A, double gamma, int newton_iters,
           int n_phase1, int ramp_block, int refactor, int ni_plateau,
           void* stream) {
  if (B < 1 || nx < 1 || nx > 1024 || n_stages < 1 || n_stages > 3 ||
      ramp_block < 1 || refactor < 1)
    return (int)cudaErrorInvalidValue;
  Scheme<S> sc;
  sc.n_stages = n_stages;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      sc.A[r][c] = (r < n_stages && c < n_stages) ? S(A[r * n_stages + c])
                                                   : S(0);
  sc.gamma = S(gamma);
  Plan plan{n_steps, newton_iters, n_phase1, ramp_block, refactor,
            ni_plateau};
  const Shape v = shape_of<S, NC>(nx);
  const Kern<S, NC> kern = kernel_of<S, NC>(v);
  cudaError_t e = opt_in<S, NC>(kern, v);
  if (e != cudaSuccess) return (int)e;
  kern<<<B, v.threads, v.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(dt), static_cast<const S*>(y0),
      static_cast<const S*>(par), static_cast<const S*>(dx),
      static_cast<S*>(pl), static_cast<S*>(tr), static_cast<S*>(rs), nx,
      v.n_levels, v.W, v.cpt, sc, plan);
  return (int)cudaGetLastError();
}

// Blocks of an nx-cell grid's variant that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), with the block's
// threads and dynamic shared memory: a batch of more rows than
// blocks_per_sm x the SM count runs in several waves.
template <typename S, int NC>
int occupancy(int nx, int* blocks_per_sm, int* threads, int* smem) {
  if (nx < 1 || nx > 1024) return (int)cudaErrorInvalidValue;
  const Shape v = shape_of<S, NC>(nx);
  const Kern<S, NC> kern = kernel_of<S, NC>(v);
  cudaError_t e = opt_in<S, NC>(kern, v);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern,
                                                      v.threads, v.smem);
  *threads = v.threads;
  *smem = (int)v.smem;
  return (int)e;
}

}  // namespace sdirk

// Plain C interface, loaded with ctypes: one entry point per model and
// scalar type, metrotrpl_sdirk_solve_{std,traps}_{f32,f64}. Arrays are
// contiguous device buffers: dt (B, n_steps), y0 (B, NC, nx), par (B, 17),
// dx (B,), outputs (B, n_steps + 1). A is the host n_stages x n_stages
// Butcher table. Returns the launch's cudaError_t (0 on success).
#define SDIRK_ENTRY(NAME, S, NC)                                            \
  extern "C" int NAME(const void* dt, const void* y0, const void* par,      \
                      const void* dx, void* pl, void* tr, void* rs, int B,  \
                      int nx, int n_steps, int n_stages, const void* A,     \
                      double gamma, int newton_iters, int n_phase1,         \
                      int ramp_block, int refactor, int ni_plateau,         \
                      void* stream) {                                       \
    return sdirk::launch<S, NC>(dt, y0, par, dx, pl, tr, rs, B, nx,         \
                                n_steps, n_stages,                          \
                                static_cast<const double*>(A), gamma,       \
                                newton_iters, n_phase1, ramp_block,         \
                                refactor, ni_plateau, stream);              \
  }

SDIRK_ENTRY(metrotrpl_sdirk_solve_std_f32, float, 3)
SDIRK_ENTRY(metrotrpl_sdirk_solve_std_f64, double, 3)
SDIRK_ENTRY(metrotrpl_sdirk_solve_traps_f32, float, 4)
SDIRK_ENTRY(metrotrpl_sdirk_solve_traps_f64, double, 4)

// metrotrpl_sdirk_occupancy_{std,traps}_{f32,f64}(nx, &blocks_per_sm,
// &threads, &smem_bytes): the occupancy of the variant the solve entry
// point launches for nx cells. Returns a cudaError_t (0 on success).
#define SDIRK_OCCUPANCY(NAME, S, NC)                                        \
  extern "C" int NAME(int nx, int* blocks_per_sm, int* threads, int* smem) { \
    return sdirk::occupancy<S, NC>(nx, blocks_per_sm, threads, smem);       \
  }

SDIRK_OCCUPANCY(metrotrpl_sdirk_occupancy_std_f32, float, 3)
SDIRK_OCCUPANCY(metrotrpl_sdirk_occupancy_std_f64, double, 3)
SDIRK_OCCUPANCY(metrotrpl_sdirk_occupancy_traps_f32, float, 4)
SDIRK_OCCUPANCY(metrotrpl_sdirk_occupancy_traps_f64, double, 4)
