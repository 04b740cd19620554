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
// traps); four C entry points instantiate the four combinations.
//
// Design: one thread per cell (blockDim = nx rounded up to a warp, ragged
// threads masked), the cell's state and its per-level PCR alpha/beta
// factors in registers / local memory; only what neighbours read crosses
// shared memory: the state for each RHS/Jacobian pass, the (Dinv, L, U)
// blocks at shift +-s in each PCR factor level, the right-hand side at
// +-s in each PCR apply level. One buffer of 3*NC*NC*nx scalars serves
// all three (27*nx at NC=3: about 27 KB at nx=128 in double; 48*nx at
// NC=4: 48 KB, above the 48 KB static limit, so the launch opts in to
// more dynamic shared memory). The edge currents and edge Jacobian planes
// sit past the NC state planes, at NC*nx. Block reductions (the damping
// max, the residual max, the observable sums) go through warp shuffles;
// the max lets NaN win, as jnp.max / torch.amax do.
// Per thread, the PCR factors are 2*levels*NC*NC + NC*NC values (336 at
// NC=4 with 10 levels: 2.7 KB in double) in local memory.
//
// What bounds it on an H100: latency and occupancy, not bandwidth or
// FLOPs. By the operations the function needs (solve_kernel.solve_flops,
// on the non-zero entries of the blocks: 1.3 GFLOP for std float on the
// fast plan, 4.1 GFLOP for traps double on the rung plan, at B=48,
// nx=128) it could finish in 0.02-0.12 ms at the card's non-tensor-core
// peak; it takes about 70 to 150 times that (PERF.md). Its block algebra
// is dense: about 1.6 (NC=3) to 2.4 (NC=4) times the work the blocks'
// non-zero patterns need. At the flagship shape it launches 48 blocks (8
// chains x 6 measurements) of 128 threads on 132 SMs, and each Newton
// iteration is a chain of dependent shared-memory exchanges and
// __syncthreads. Making it fast (several simulations per block, fewer
// barriers, factors in shared memory for float, sparse block algebra) is
// later work.
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

template <typename S>
__device__ __forceinline__ S warp_max(S v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename S>
__device__ __forceinline__ S warp_sum(S v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide NaN-propagating max; every thread gets the result.
template <typename S>
__device__ S block_max(S v, S* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    S w = lane < n_warps ? red[lane] : S(0);
    w = warp_max(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const S out = red[32];
  __syncthreads();
  return out;
}

// Block-wide sums of two values; every thread gets both.
template <typename S>
__device__ void block_sum2(S a, S b, S* red, S* sa, S* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    S wa = lane < n_warps ? red[lane] : S(0);
    S wb = lane < n_warps ? red[32 + lane] : S(0);
    wa = warp_sum(wa);
    wb = warp_sum(wb);
    if (lane == 0) {
      red[64] = wa;
      red[65] = wb;
    }
  }
  __syncthreads();
  *sa = red[64];
  *sb = red[65];
  __syncthreads();
}

// Per-thread context of one simulation of an NC-component model.
template <typename S, int NC>
struct Sim {
  using Mo = Model<NC>;
  static constexpr int NBK = NC * NC;  // entries of one block
  // exchange-buffer planes: the Dinv, L and U blocks of a PCR level
  static constexpr int XCH_PLANES = 3 * NBK;

  int i, n;
  bool active;
  Params<S> p;
  S* xch;  // exchange buffer, XCH_PLANES * n scalars
  S* red;  // reduction scratch, 66 scalars
  int n_levels;
  S alpha[MAX_LEVELS][NBK];
  S beta[MAX_LEVELS][NBK];
  S dinv[NBK];

  // Publish the plane state y; return this cell and the next one (the
  // cell itself at the last cell, where the next is never read).
  __device__ void cells(const S* y, Cell<S>* me, Cell<S>* hi) {
    if (active)
      for (int c = 0; c < NC; ++c) xch[c * n + i] = y[c];
    __syncthreads();
    if (active) {
      *me = make_cell(xch[Mo::N * n + i], xch[Mo::D * n + i],
                      xch[Mo::E * n + i], p);
      const int j = i < n - 1 ? i + 1 : i;
      *hi = make_cell(xch[Mo::N * n + j], xch[Mo::D * n + j],
                      xch[Mo::E * n + j], p);
    }
  }

  // dy/dt of this cell (rhs_std_planes / rhs_traps_planes). Each edge's
  // currents are computed once, by the cell to its left, and read by the
  // cell to its right through shared memory, past the NC state planes.
  __device__ void rhs(const S* y, S* out) {
    Cell<S> me, hi;
    cells(y, &me, &hi);
    S jn_r = S(0), F_r = S(0);
    S* edge = xch + NC * n;
    if (active) {
      right_edge_flux(i, n, me, hi, p, &jn_r, &F_r);
      edge[i] = jn_r;
      edge[n + i] = F_r;
    }
    __syncthreads();
    if (active) {
      S jn_l, F_l;
      if (i > 0) {
        jn_l = edge[i - 1];
        F_l = edge[n + i - 1];
      } else {  // front surface; the surface terms cancel in F
        jn_l = surface_flux(me, p.sf);
        F_l = S(0);
      }
      if constexpr (NC == 3)
        rhs_cell(i, n, me, jn_l, F_l, jn_r, F_r, p, out);
      else
        rhs_cell_traps(i, n, me, y[Mo::T], jn_l, F_l, jn_r, F_r, p, out);
    }
    __syncthreads();
  }

  // PCR factorization of M = I - hg*J(y) (sdirk_factors + pcr_factor).
  __device__ void factor(const S* y, S hg) {
    Cell<S> me, hi;
    cells(y, &me, &hi);
    EdgeJac<S> ek;
    if (active) {
      ek = own_edge_jac(i, n, me, hi, p);
      S* e = xch + NC * n + i;
      e[0] = ek.jn_dNk;
      e[n] = ek.jn_dNk1;
      e[2 * n] = ek.jn_dE;
      e[3 * n] = ek.F_dNk;
      e[4 * n] = ek.F_dNk1;
      e[5 * n] = ek.F_dDk;
      e[6 * n] = ek.F_dDk1;
      e[7 * n] = ek.F_dE;
    }
    __syncthreads();
    S L[NBK], D[NBK], U[NBK];
    if (active) {
      EdgeJac<S> ep = {S(0), S(0), S(0), S(0), S(0), S(0), S(0), S(0)};
      if (i > 0) {
        const S* e = xch + NC * n + i - 1;
        ep = {e[0], e[n], e[2 * n], e[3 * n], e[4 * n], e[5 * n], e[6 * n],
              e[7 * n]};
      }
      S JL[NBK], JD[NBK], JU[NBK];
      if constexpr (NC == 3)
        jac_cell(i, n, me, ek, ep, p, JL, JD, JU);
      else
        jac_cell_traps(i, n, me, y[Mo::T], ek, ep, p, JL, JD, JU);
      for (int e = 0; e < NBK; ++e) {
        const bool diag = e % (NC + 1) == 0;
        D[e] = diag ? S(1) - hg * JD[e] : -hg * JD[e];
        L[e] = -hg * JL[e];
        U[e] = -hg * JU[e];
      }
    }
    __syncthreads();
    int s = 1;
    for (int lev = 0; lev < n_levels; ++lev, s *= 2) {
      S Di[NBK];
      if (active) {
        inv<NC>(D, Di);
        for (int e = 0; e < NBK; ++e) {
          xch[e * n + i] = Di[e];
          xch[(NBK + e) * n + i] = L[e];
          xch[(2 * NBK + e) * n + i] = U[e];
        }
      }
      __syncthreads();
      S Dm[NBK], Dp[NBK], Lm[NBK], Um[NBK], Lp[NBK], Up[NBK];
      if (active) {
        const bool has_m = i - s >= 0, has_p = i + s < n;
        for (int e = 0; e < NBK; ++e) {
          Dm[e] = has_m ? xch[e * n + i - s] : S(0);
          Lm[e] = has_m ? xch[(NBK + e) * n + i - s] : S(0);
          Um[e] = has_m ? xch[(2 * NBK + e) * n + i - s] : S(0);
          Dp[e] = has_p ? xch[e * n + i + s] : S(0);
          Lp[e] = has_p ? xch[(NBK + e) * n + i + s] : S(0);
          Up[e] = has_p ? xch[(2 * NBK + e) * n + i + s] : S(0);
        }
      }
      __syncthreads();
      if (active) {
        S t[NBK], u[NBK];
        mm<NC>(L, Dm, t);
        for (int e = 0; e < NBK; ++e) alpha[lev][e] = -t[e];
        mm<NC>(U, Dp, t);
        for (int e = 0; e < NBK; ++e) beta[lev][e] = -t[e];
        mm<NC>(alpha[lev], Lm, L);
        mm<NC>(alpha[lev], Um, t);
        mm<NC>(beta[lev], Lp, u);
        for (int e = 0; e < NBK; ++e) D[e] = D[e] + (t[e] + u[e]);
        mm<NC>(beta[lev], Up, U);
      }
    }
    if (active) inv<NC>(D, dinv);
  }

  // x = M^-1 b with the stored factors (pcr_apply).
  __device__ void apply(const S* b_in, S* x) {
    S b[NC];
    for (int c = 0; c < NC; ++c) b[c] = active ? b_in[c] : S(0);
    int s = 1;
    for (int lev = 0; lev < n_levels; ++lev, s *= 2) {
      if (active)
        for (int c = 0; c < NC; ++c) xch[c * n + i] = b[c];
      __syncthreads();
      S bm[NC], bp[NC];
      if (active) {
        const bool has_m = i - s >= 0, has_p = i + s < n;
        for (int c = 0; c < NC; ++c) {
          bm[c] = has_m ? xch[c * n + i - s] : S(0);
          bp[c] = has_p ? xch[c * n + i + s] : S(0);
        }
      }
      __syncthreads();
      if (active) {
        S lo[NC], hi[NC];
        mv<NC>(alpha[lev], bm, lo);
        mv<NC>(beta[lev], bp, hi);
        for (int c = 0; c < NC; ++c) b[c] = b[c] + lo[c] + hi[c];
      }
    }
    if (active) mv<NC>(dinv, b, x);
  }

  // One step's stage sweep with the current factors (sdirk_stages).
  // Advances y in place; returns the step's residual.
  __device__ S stages(S* y, S h, const Scheme<S>& sc, int ni) {
    S fs[3][NC];
    S Y[NC], acc[NC];
    S resid = S(0);
    bool have_resid = false;
    for (int c = 0; c < NC; ++c) Y[c] = y[c];
    for (int st = 0; st < sc.n_stages; ++st) {
      for (int c = 0; c < NC; ++c) acc[c] = y[c];
      for (int j = 0; j < st; ++j)
        if (sc.A[st][j] != S(0))
          for (int c = 0; c < NC; ++c)
            acc[c] = acc[c] + (h * sc.A[st][j]) * fs[j][c];
      if (sc.A[st][st] == S(0)) {  // explicit first stage (ESDIRK)
        rhs(y, fs[st]);
        continue;
      }
      for (int c = 0; c < NC; ++c) Y[c] = acc[c];
      S r = S(0);
      for (int it = 0; it < ni; ++it) {
        S f[NC], G[NC], d[NC];
        rhs(Y, f);
        for (int c = 0; c < NC; ++c)
          G[c] = active ? Y[c] - h * sc.gamma * f[c] - acc[c] : S(0);
        apply(G, d);
        // max |d| over every plane (_maxabs_update), NaN winning
        S m = S(0);
        if (active) {
          m = abs_(d[0]);
          for (int c = 1; c < NC; ++c) m = nan_max(m, abs_(d[c]));
        }
        const S dmax = block_max(m, red);
        // trust-region damping: scale the update so max|d| <= cap
        const S cap = S(NEWTON_DAMP);
        const S sc_ = nan_min(S(1), cap / nan_max(dmax, cap));
        for (int c = 0; c < NC; ++c) {
          d[c] = sc_ * d[c];
          Y[c] = Y[c] - d[c];
        }
        // max|s*d| == s*max|d| exactly (rounding is monotone, s >= 0)
        r = sc_ * dmax;
      }
      resid = have_resid ? nan_max(resid, r) : r;
      have_resid = true;
      for (int c = 0; c < NC; ++c)
        fs[st][c] = (Y[c] - acc[c]) / (h * sc.gamma);
    }
    for (int c = 0; c < NC; ++c) y[c] = Y[c];
    return resid;
  }
};

template <typename S, int NC, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
sdirk_solve_kernel(const S* __restrict__ dt, const S* __restrict__ y0,
                   const S* __restrict__ par, const S* __restrict__ dx,
                   S* __restrict__ pl_out, S* __restrict__ tr_out,
                   S* __restrict__ rs_out, int nx, int n_levels,
                   Scheme<S> sc, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* smem = reinterpret_cast<S*>(smem_raw);

  const int b = blockIdx.x;
  Sim<S, NC> sim;
  sim.i = threadIdx.x;
  sim.n = nx;
  sim.active = sim.i < nx;
  sim.p = load_params(par + (size_t)b * N_PARAM);
  sim.xch = smem;
  sim.red = smem + (size_t)Sim<S, NC>::XCH_PLANES * nx;
  sim.n_levels = n_levels;

  const int n_out = plan.n_steps + 1;
  const S* dt_b = dt + (size_t)b * plan.n_steps;
  const S dxb = dx[b];
  S y[NC];
  for (int c = 0; c < NC; ++c)
    y[c] = sim.active ? y0[((size_t)b * NC + c) * nx + sim.i] : S(0);

  // Observables of the state at knot k: each knot written on its own, so
  // a NaN step stays in its own knot.
  auto emit = [&](int k, S resid) {
    S m = S(0), t = S(0);
    if (sim.active) {
      using Mo = Model<NC>;
      const Cell<S> c = make_cell(y[Mo::N], y[Mo::D], y[Mo::E], sim.p);
      m = c.M;
      t = sim.p.diff_n * c.dN + sim.p.diff_p * c.dP;
    }
    S sm, st;
    block_sum2(m, t, sim.red, &sm, &st);
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
  int n_levels = 0;
  while ((1 << n_levels) < nx) ++n_levels;
  const int threads = ((nx + 31) / 32) * 32;
  const size_t smem =
      ((size_t)Sim<S, NC>::XCH_PLANES * nx + 66) * sizeof(S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const S* a_dt = static_cast<const S*>(dt);
  const S* a_y0 = static_cast<const S*>(y0);
  const S* a_par = static_cast<const S*>(par);
  const S* a_dx = static_cast<const S*>(dx);
  S* a_pl = static_cast<S*>(pl);
  S* a_tr = static_cast<S*>(tr);
  S* a_rs = static_cast<S*>(rs);
  // the two instantiations differ only in their register budget
  // (__launch_bounds__), so they share one signature
  auto kern = threads <= 256 ? sdirk_solve_kernel<S, NC, 256>
                             : sdirk_solve_kernel<S, NC, 1024>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B, threads, smem, st>>>(a_dt, a_y0, a_par, a_dx, a_pl, a_tr, a_rs,
                                 nx, n_levels, sc, plan);
  return (int)cudaGetLastError();
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
