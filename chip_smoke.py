#!/usr/bin/env python3
"""Smoke test of the PyTorch port (metrotrpl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on failure:

1. The card's name and power limit (nvidia-smi); build the CUDA solve
   kernel (four instantiations: std and traps model, float and double)
   from metrotrpl_tpu_torch/solver/csrc with nvcc.
2. The std kernel against its plain PyTorch version at the flagship
   shape: 48 rows (8 states around the staub truth x 6 measurements),
   nx=128. float32 on the fast plan (hmax 48, chord blocks of 4): the rows
   over the Newton thresholds (0.5 and the 0.97*cap pin) must be the same
   rows, and on the others |d log10 observable| <= 1e-4. float64 on the
   escalation-rung plan (hmax 16, chord-free): relative error <= 1e-9.
   CUDA-event times of both (the kernel's over 20 runs, the plain
   version's of the compared call), and of the float64 kernel at B=9 (the
   rung's rows per iteration in a profiled flagship walk), on a line of
   its own.
3. The 8 high-mobility ridge states (scripts/.probe_r14_ridge_states.npz)
   through the port's eval_logll on the flagship plan in a float32 walk:
   the float64 rung must launch and every logll_T must be finite.
4. The std main path: the `write-example --fast` config
   (cli.write_example_config) into chip_smoke_out/, then `cli mcmc
   --device cuda` for 200 iterations, checkpointing every 100. The
   pickle must load, the cold chain's acceptance lie in
   [0.05, 0.8], the float32 std kernel must have launched at least once
   per iteration and the float64 rung at least once.
5. The traps kernel (C=4) against its plain version as in phase 2, on the
   traps config (the same builder's flagship geometry under the
   shallow-trap model, data synthesized by the float64 LSODA oracle at
   the traps truth): float32 on the fast plan, float64 on the rung plan,
   same tolerances and times.
6. The traps ladder: 8 states with mu_n just above the escalation trigger
   (40 cm^2/Vs) through eval_logll in a float32 walk: the float64 traps
   kernel must launch and every logll_T must be finite.
7. The traps main path: `cli mcmc --device cuda` on the traps config for
   100 iterations, checkpointing every 50, with the checks of phase 4 on
   the traps kernels.
8. The fused std walk: `cli mcmc --ensembles 8 --device cuda` on the
   flagship config for 100 iterations, checkpointing at 50. All 8
   CPU{j}-final.pik must load, every cold chain be finite with acceptance
   in [0.05, 0.8], the replicas differ, the float32 std kernel launch
   once per iteration (the initial evaluation included: launches =
   iterations, not 8 times that) and the float64 rung at least once.
   Then the steady-state aggregate walker-steps/s of fused windows at E =
   1, 2, 4, 8 (30 timed iterations from the walk's last states).
9. Fused equals separate on the card: metro(n_ensembles=2) for 20
   iterations against each replica walked alone at its seed; History and
   swap counters must agree bit for bit.
10. The dense sampler: `cli dense --device cuda` on the flagship config,
    2048 samples (4 chunks of 512 states x 6 curves). Every P must be
    finite or a conceded -inf; solves/s, and the rung's launches.
11. The MLE: `cli mle --maxiter 40 --device cuda` on the flagship config
    (float64: the std double kernel on the fast and the rung plan). The
    best logll of the trace must be finite and no worse than the first.
12. Kernel time against batch size, per instantiation (CUDA events):
    float at B = 48, 96, 192, 384 on the fast plan, double at B = 9, 72,
    144 on the rung plan, beside the resident blocks per SM that the CUDA
    occupancy API gives for the launch's variant; the float ones also at
    the committed posteriors' fast-leg shapes (nx=32: std B=192, traps
    B=64; kernel_times.posterior_fast_batch), beside theirs.

13. The reference-pinned likelihood fixtures (reference
    Tests/test_eval_trial_move.py) at nx=128: float64 evaluations (the std
    double kernel, 1001 output knots) held to the pinned constants at
    decimal=0, the force_min_y fixture to its monotonicity; float32 values
    printed beside them without a limit.
14. The real measured staub data (Inputs/real_staub_*.csv, density-mode
    profiles, 3 curves to 4248 ns): `write-real-example --fast` then `cli
    mcmc --device cuda`, 100 iterations x 8 chains; the same with --irf
    (the 745 nm IRF); --irf --ensembles 8 for 50 iterations. Walker-steps/s,
    launches and rung rows per iteration, peak memory; the IRF compare
    pipeline's and its grouped conv1d's CUDA-event times at 8 and 64
    states, the evaluation with and without the IRF, and one dense chunk
    of 512 prior samples on the IRF plan with its peak memory. Each
    checkpoint must load, each cold chain be finite, the std float kernel
    launch at least once per iteration.
15. The NN surrogate walk: seeded weights saved to chip_smoke_out/nn/,
    data from the surrogate at the staub truth, metro on the card for 200
    iterations: no kernel launch, a finite cold chain, and the card's
    eval_logll equal to the same plan's CPU one within 1e-9 (float64) and
    1e-4 (float32, whose own rounding against float64 is ~3e-5 here) of
    the largest |ll|.
16. The pa toy walk: `write-pa-example` then `cli mcmc --device cuda`,
    500 iterations: finite.
17. The native runtime (metrotrpl_tpu_torch/runtime, g++ into its
    _build/): both libraries build; the compiled std RHS's dy equals the
    numpy RHS on a flagship state (rel 1e-12 per block); load_csv equals
    np.loadtxt bit for bit on every Inputs/*.csv; one flagship
    solve_reference(rhs="native") equals rhs="numpy" (rel 1e-9), both
    timed.
18. Quicksim on the card: phases 4's and 7's checkpoints through the
    GUI's tk-free data layer (load_ensemble_chains, export_all into
    chip_smoke_out/gui/); 4 std tasks from the std walk's last states and
    2 traps tasks from the traps walk's, at the GUI's defaults (nx=128,
    500 knots to 2000 ns); run_tasks(device="cuda") (the double kernels)
    against the same tasks through the plain version on the CPU, rel <=
    1e-9; one QuicksimManager(device="cuda") round trip in a spawned
    child, equal to the parent's solve; ms per batch.
19. Short posterior legs (scripts/posterior_torch.py): the std fast leg,
    32 chains x 1000 iterations, and the traps fast leg, 32 x 500, on
    their datasets. Every state and log-likelihood finite, acceptance in
    [0.05, 0.8], the model's float kernel launched at least once per
    iteration; walker-steps/s and launches per iteration. Then the float
    kernel against its plain version (as in phase 2, at nx=32) at the
    leg's last 32 states x its curves on the three plans the full legs
    run: the fast plan (B=192 std, 64 traps), its ladder's chord-free
    plan and the gold leg's plan; error, ms and bound per shape.
20. The sharded walk (metrotrpl_tpu_torch/parallel) on the one card:
    metro(mesh_shape=...) on the flagship config, E=2 x 8 chains, every
    rank on cuda:0, at 1x1 (NCCL, a world of one), 2x1 and 1x2 (gloo:
    NCCL refuses two ranks on one GPU; 2x2 would pass the phase's 90 s,
    MESH_LAYOUTS): 50 iterations, then 50 more resumed from the
    per-replica checkpoints. History and swap
    counters must equal the fused metro(n_ensembles=2) walk of 100
    iterations bit for bit after each half; each rank's std float kernel
    must launch once per iteration on E_l*K_l*6 rows, the rung at least
    once per layout. Aggregate walker-steps/s per layout (with the
    spawn, and inside the ranks' walks) beside the fused walk's.
21. The flagship posterior's pieces (scripts/flagship_torch.py): its
    dataset (nx=128, 501 points to 2000 ns, 6 curves, by the port's LSODA
    oracle), whose SHA-256 must be the committed oracle chain's; a short
    production leg, 8 ensembles x 4 temperatures x 200 iterations in
    float32 with the float64 rung: every state and ll finite, the std
    float kernel launched at least once per iteration, each launch on 192
    rows; the 8 committed ridge states through the leg's evaluation on the
    card: equal to the same evaluation through the plain version on the
    host (rel 1e-5 in ll, the same rows repaired) and within |dll| 0.1 of
    their committed oracle ll, 0.125 at mu_n 55.9, where the reference's
    own rung is 0.118-0.119 from it (each |dll| is printed); each std
    instantiation against its plain version at the leg's last 8 cold
    states x 6 curves (float on the fast plan, double on the rung's).

Launch counts are zeroed just before each main path (phases 4, 7, 8, 10,
11, 13-16, 18, each leg of 19, in each rank of 20, and 21's leg) and read
just after it. The last three lines of standard output are the
kernels JSON object (one entry per instantiation, with its launches on
its main path, its error against the plain version, CUDA-event times of
kernel and plain version, and its bound: the larger of the FLOPs it needs
(solve_kernel.solve_flops) over the card's non-tensor-core peak and its
bytes over the memory rate; the float ones also the comparisons of phase
19 under posterior_shapes, the std ones phase 21's under flagship_shape),
the nvidia-smi line and {"ok": true, "device": {...}}. Without CUDA, or
outside the repository, it exits non-zero and prints no result.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from metrotrpl_tpu_torch.solver.kernel_times import (
    cuda_ms,
    kernel_inputs,
    kernel_vs_plain,
    nvidia_smi_line,
    posterior_fast_batch,
    solve_bound,
)

REPO = Path(__file__).resolve().parent
N_ITERS = 200          # std walk
N_ITERS_TRAPS = 100    # traps walk
E_FUSED = 8            # fused ensembles of the fused std walk
N_ITERS_FUSED = 100    # its iterations
N_ITERS_PAIR = 20      # fused against separate walks
N_DENSE = 2048         # dense samples
MLE_MAXITER = 40       # Nelder-Mead iterations
N_ITERS_REAL = 100     # real-data walks, with and without the IRF
N_ITERS_REAL_E8 = 50   # the real-data IRF walk at E_FUSED ensembles
N_ITERS_NN = 200       # NN surrogate walk
N_ITERS_PA = 500       # pa toy walk
N_ITERS_POST = 1000    # the std posterior fast leg (32 chains)
N_ITERS_POST_TRAPS = 500   # the traps posterior fast leg (32 chains)
N_ITERS_MESH = 100     # the sharded walk, 50 + 50 resumed
# (d_e, d_c, whether every rank shares cuda:0 (else rank r has cuda:r));
# 2x2 on the one card is left out: with it the phase took 102.6 s, past
# its 90 s
MESH_LAYOUTS = ((1, 1, True), (2, 1, True), (1, 2, True))
MESH_SEED = 88
N_ITERS_FLAGSHIP = 200  # the short flagship leg (8 ensembles x 4 temperatures)
#: each committed ridge state's |ll - oracle ll| limit (mu_n 50.1, 55.9,
#: 66.0, 77.4, 83.5, 88.0, 93.7, 100.0): 0.1, but 0.125 at mu_n 55.9, where
#: the reference's own rung (h16 chord-free float64) is 0.118 from the
#: oracle by metrotrpl_tpu/inference/likelihood.py:406 and 0.119 by
#: scripts/probe_r14_ridge64.py --prod; and the card's relative limit
#: against the same evaluation through the plain version on the host (the
#: float32 walk's likelihood sums its 3006 terms in another order there:
#: 1.2e-6 apart at |ll| ~ 1010 on the card)
RIDGE_DLL_LIMITS = (0.1, 0.125, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
RIDGE_CARD_RTOL = 1e-5

#: the reference-pinned likelihood fixtures (reference
#: Tests/test_eval_trial_move.py, as tests/test_reference_parity.py:64-186
#: states them): a radiative-only 2000 nm material with uniform density
#: profiles, data of 23 (TRPL) or -2 (TRTS) decades, u = 1e-99, 1001
#: output knots over [0, 100] ns
PIN_NAMES = ["n0", "p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Tm", "Sf", "Sb",
             "tauN", "tauP", "eps", "m"]
PIN_UC = {"n0": 1e-21, "p0": 1e-21, "mu_n": 1e5, "mu_p": 1e5, "ks": 1e12,
          "Sf": 1e-2, "Sb": 1e-2}
PIN_BASE = {"n0": 0, "p0": 0, "mu_n": 0, "mu_p": 0, "ks": 1e-11, "Sf": 0,
            "Sb": 0, "Cn": 0, "Cp": 0, "Tm": 300, "tauN": 1e99,
            "tauP": 1e99, "eps": 10, "m": 1}


def pinned_fixtures(nx):
    """name -> (sim_info, parameter names, states, MCMC_fields, e_data,
    iniPar, pinned per-measurement values or None, pinned sum or None);
    force_min_y's two states must order its likelihoods instead."""
    import numpy as np

    def grid(types):
        return {"lengths": [2000] * len(types), "nx": [nx] * len(types),
                "meas_types": list(types), "num_meas": len(types)}

    def data(nt, t_end, vals):
        t = np.linspace(0, t_end, nt + 1)
        return ([t] * len(vals), [np.full(nt + 1, v) for v in vals],
                [np.full(nt + 1, 1e-99)] * len(vals))

    mc = {"solver": ("solveivp",), "model": "std", "ini_mode": "density",
          "hmax": 4, "log_y": 1, "model_uncertainty": {"TRPL": 1}}
    prof = np.array([1e15 * np.ones(nx), 1e16 * np.ones(nx)])
    two = (-59340.105083, -32560.139058)
    scaled = dict(PIN_BASE, ks=1e-20, _s0=2e-17 ** -1, _s1=2e-15 ** -1)
    mixed = dict(PIN_BASE, mu_n=0.01, mu_p=0.01)
    fmy = dict(PIN_BASE, n0=1e8, p0=1e17, ks=1e-13, tauN=4, tauP=4)
    t = np.linspace(0, 100, 1001)
    return {
        "two_trpl": (grid(["TRPL"] * 2), PIN_NAMES, [PIN_BASE], mc,
                     data(1000, 100, [23, 23]), prof, two, sum(two)),
        "time_cutoff": (grid(["TRPL"] * 2), PIN_NAMES, [PIN_BASE], mc,
                        data(500, 50, [23, 23]), prof, None, -45982),
        "scale_factors": (grid(["TRPL"] * 2), PIN_NAMES + ["_s0", "_s1"],
                          [scaled],
                          dict(mc, scale_factor=[0.02, [0, 1], None, [1, 1]]),
                          data(1000, 100, [23, 23]), prof, None, 0),
        "mixed_trpl_trts": (grid(["TRPL", "TRTS"]), PIN_NAMES, [mixed],
                            dict(mc, model_uncertainty={"TRPL": 1,
                                                        "TRTS": 10}),
                            data(1000, 100, [23, -2]), prof[[0, 0]],
                            (two[0], -517.98), two[0] - 517.98),
        "force_min_y": (grid(["TRPL"]), PIN_NAMES,
                        [fmy, dict(fmy, tauN=4.01, tauP=4.01)],
                        dict(mc, force_min_y=1),
                        ([t], [np.log10(2e14 * np.exp(-t / 8))],
                         [np.full(1001, 1e-99)]), prof[:1], None, None),
    }


def phase13_pinned(card, dev):
    """The pinned fixtures on the card at nx=128: float64 evaluations
    (the std double kernel) held to the reference's constants at
    decimal=0 and force_min_y to its monotonicity; float32 values printed
    beside them without a limit. Returns the phase's launches."""
    import numpy as np

    from metrotrpl_tpu_torch.inference.likelihood import (
        build_likelihood_plan,
        make_eval_logll,
    )
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    f32, f64 = torch.float32, torch.float64
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    for name, (sim_info, names, states, mcmc, e_data, ini, pinned,
               total) in pinned_fixtures(128).items():
        pi = {"names": names, "unit_conversions": PIN_UC,
              "active": {n: 0 for n in names}, "init_guess": states[0],
              "trial_move": {n: 0 for n in names}}
        plan = build_likelihood_plan(sim_info, pi, mcmc, e_data, ini)
        st = np.array([[s[n] for n in names] for s in states])
        pm = {}
        for dt in (f64, f32):
            out = make_eval_logll(plan, dtype=dt, device=dev)(
                torch.as_tensor(st, dtype=dt, device=dev),
                torch.ones(1, dtype=dt, device=dev))
            pm[dt] = out["per_meas"][..., 0].double().cpu().numpy()
        a = pm[f64]
        print(f"phase 13 {name}: n_steps {plan.fwd[0][1].n_steps}, "
              f"per_meas float64 {a.tolist()}, float32 "
              f"{pm[f32].tolist()} (no limit), pinned "
              f"{pinned if pinned is not None else total}")
        if not np.isfinite(a).all():
            raise RuntimeError(f"phase 13 {name}: a float64 value is not "
                               "finite")
        if pinned is not None and np.abs(a[0] - pinned).max() >= 1.5:
            raise RuntimeError(f"phase 13 {name}: {a[0]} not {pinned} at "
                               "decimal=0")
        if total is not None and abs(a[0].sum() - total) >= 1.5:
            raise RuntimeError(f"phase 13 {name}: sum {a[0].sum()} not "
                               f"{total} at decimal=0")
        if name == "force_min_y" and not a[1, 0] > a[0, 0]:
            raise RuntimeError("phase 13 force_min_y: the move toward the "
                               "data's decay did not improve the likelihood")
    torch.cuda.synchronize()
    launches = dict(sk.LAUNCHES)
    print(f"phase 13: 5 pinned fixtures x float64 and float32 in "
          f"{time.perf_counter() - t0:.2f} s on {card}; launches std f64 "
          f"{launches[('std', f64)]}, f32 {launches[('std', f32)]}")
    if launches[("std", f64)] < 5:
        raise RuntimeError("phase 13: the std double kernel did not run "
                           "every fixture")
    return launches


def phase14_real(card, dev, work, cli):
    """The real measured staub data: `write-real-example --fast` (and
    --irf) then `cli mcmc --device cuda`, 100 iterations x 8 chains each,
    and --irf --ensembles 8 for 50; the IRF compare pipeline's time and
    memory. Returns ({walk label: launches}, the IRF plan, its
    param_info)."""
    import numpy as np

    from metrotrpl_tpu_torch.cli import _load_common
    from metrotrpl_tpu_torch.inference.likelihood import (
        _make_compare_pipeline,
        make_eval_logll,
    )
    from metrotrpl_tpu_torch.inference.metropolis import (
        load_checkpoint,
        plans_from_config,
    )
    from metrotrpl_tpu_torch.ops.convolve import (
        convolve_moments,
        load_irf_tables,
    )
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    f32, f64 = torch.float32, torch.float64
    inputs, irf_dir = REPO / "Inputs", str(REPO / "IRFs")
    walks = {}
    for label, irf, n_iters, E in (("real", False, N_ITERS_REAL, 1),
                                   ("real_irf", True, N_ITERS_REAL, 1),
                                   ("real_irf_e8", True, N_ITERS_REAL_E8,
                                    E_FUSED)):
        cfg = work / f"{label}.txt"
        cli(["write-real-example", str(cfg), "--fast", "--num-iters",
             str(n_iters), "--init-cond", str(inputs / "real_staub_input.csv"),
             "--measurement",
             str(inputs / "real_staub_aug_corr_renoised.csv"), "--output",
             str(work / label)] + (["--irf"] if irf else []))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        cli(["mcmc", str(cfg), "--device", "cuda", "--irf-dir", irf_dir,
             "--ensembles", str(E)])
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        launches, rows = dict(sk.LAUNCHES), dict(sk.ROWS)
        peak = torch.cuda.max_memory_allocated(dev)
        enss = [load_checkpoint(str(work / label / f"CPU{j}-final.pik"))
                for j in range(E)]
        K = enss[0].H.accept.shape[0]
        acc = [float(e.H.accept[0, 1:].mean()) for e in enss]
        n32, n64 = launches[("std", f32)], launches[("std", f64)]
        print(f"phase 14 {label}: {E} x {n_iters} iterations x {K} chains "
              f"in {walk_s:.2f} s (plan build and first evaluation "
              f"included): {n_iters * K * E / walk_s:.1f} walker-steps/s on "
              f"{card}; launches per iteration std f32 {n32 / n_iters:.2f}, "
              f"f64 {n64 / n_iters:.2f}; rung rows per iteration "
              f"{rows[('std', f64)] / n_iters:.2f} of {K * E * 3}; peak "
              f"memory {peak / 2**20:.1f} MiB; cold-chain acceptance "
              f"{np.round(acc, 3).tolist()}")
        for j, e in enumerate(enss):
            if (e.latest_iter != n_iters
                    or not np.isfinite(e.H.loglikelihood[0]).all()):
                raise RuntimeError(f"phase 14 {label}: replica {j} holds "
                                   f"{e.latest_iter} iterations or a "
                                   "non-finite cold chain")
        if n32 < n_iters:
            raise RuntimeError(f"phase 14 {label}: the std float kernel "
                               f"launched {n32} < {n_iters} times")
        walks[label] = launches

    # the compare pipeline and the evaluation with and without the IRF
    plans = {}
    for label in ("real", "real_irf"):
        sim_info, pi, _f, mcmc, ini, e_data = _load_common(
            str(work / f"{label}.txt"))
        tables = (load_irf_tables(mcmc["irf_convolution"], irf_dir)
                  if mcmc.get("irf_convolution") else {})
        plans[label], _ = plans_from_config(sim_info, pi, dict(mcmc),
                                            e_data, ini, irf_tables=tables)
    plan = plans["real_irf"]
    fp, fp_hi = plan.fwd[0][1], plan.fwd[0][2]
    M, R = plan.n_meas, plan.res_t.shape[1]
    print(f"phase 14: real plan nx={fp.nx}, n_steps {fp.n_steps} (rung "
          f"{fp_hi.n_steps}), {plan.exp_times.shape[1]} data points to "
          f"{plan.exp_times.max():.1f} ns, IRF resample R={R}")
    temps = torch.as_tensor(np.asarray(mcmc["parallel_tempering"]),
                            dtype=f32, device=dev)
    compare = _make_compare_pipeline(plan, f32, dev)
    names = list(plan.param_names)
    base = np.array([pi["init_guess"][n] for n in names])
    active = np.array([bool(pi["active"][n]) for n in names])
    rng = np.random.default_rng(3)
    cost = {}
    for K in (8, 64):
        sol = torch.as_tensor(10.0 ** plan.exp_vals, dtype=f32,
                              device=dev).repeat(K, 1)
        shift = torch.zeros(K * M, dtype=f32, device=dev)
        res = torch.rand((K * M, R), dtype=f32, device=dev)
        tabs = torch.as_tensor(plan.irf_tables, dtype=f32,
                               device=dev).repeat(K, 1, 1)
        st = torch.as_tensor(base[None] * 10.0 ** (rng.uniform(
            -0.1, 0.1, (K, len(names))) * active[None]), dtype=f32,
            device=dev)
        evs = {lb: make_eval_logll(pl, dtype=f32, device=dev)
               for lb, pl in plans.items()}
        cost[K] = dict(
            compare_ms=cuda_ms(lambda: compare(sol, shift, temps), 10),
            conv_ms=cuda_ms(lambda: convolve_moments(res, tabs), 10),
            eval_irf_ms=cuda_ms(lambda: evs["real_irf"](st, temps), 5),
            eval_ms=cuda_ms(lambda: evs["real"](st, temps), 5))
    print("phase 14 IRF cost: " + "; ".join(
        f"K={K} ({K * M} rows): compare pipeline {c['compare_ms']:.3f} ms, "
        f"of it the 3 grouped conv1d {c['conv_ms']:.3f} ms; evaluation "
        f"with the IRF {c['eval_irf_ms']:.3f} ms, without "
        f"{c['eval_ms']:.3f} ms" for K, c in cost.items()) + f" on {card}")

    return walks, plan, pi


def dense_chunk_on_irf_plan(card, dev, plan, pi):
    """Time and peak memory of one dense chunk (512 prior samples) on
    the real-data IRF plan: the largest compare step the port runs."""
    import numpy as np

    from metrotrpl_tpu_torch.inference.dense import random_grid
    from metrotrpl_tpu_torch.inference.likelihood import make_eval_logll

    f32 = torch.float32
    names = list(plan.param_names)
    lo = np.array([pi["prior_dist"][n][0] if pi["active"][n]
                   else pi["init_guess"][n] for n in names])
    hi = np.array([pi["prior_dist"][n][1] if pi["active"][n]
                   else pi["init_guess"][n] for n in names])
    X = random_grid(lo, hi, [pi["do_log"][n] for n in names], 512,
                    np.random.default_rng(0))
    xs = torch.as_tensor(X, dtype=f32, device=dev)
    one = torch.ones(1, dtype=f32, device=dev)
    ev = make_eval_logll(plan, dtype=f32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    chunk_ms = cuda_ms(lambda: ev(xs, one), 2)
    peak = torch.cuda.max_memory_allocated(dev) - held
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"phase 14: dense chunk of 512 samples x {plan.n_meas} curves on "
          f"the IRF plan: {chunk_ms:.3f} ms, peak memory "
          f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held, "
          f"of {total / 2**30:.1f} GiB, on {card}")


def phase15_nn(card, dev, work):
    """The NN surrogate walk: seeded weights saved to .npz, data made from
    the surrogate at the staub truth, metro on the card for 200
    iterations with no kernel launch; the card's evaluation against the
    same plan's CPU one at float64 and float32. Returns the walk's
    launches."""
    import numpy as np

    from metrotrpl_tpu_torch.inference.likelihood import (
        build_likelihood_plan,
        make_eval_logll,
    )
    from metrotrpl_tpu_torch.inference.metropolis import metro
    from metrotrpl_tpu_torch.solver import solve_kernel as sk
    from metrotrpl_tpu_torch.surrogate import NeuralNetwork
    from metrotrpl_tpu_torch.workloads import (
        STAUB_NAMES,
        STAUB_TRUE,
        staub_param_info,
    )

    f32, f64 = torch.float32, torch.float64
    nn_dir = work / "nn"
    nn_dir.mkdir()
    rng = np.random.default_rng(1)
    net = NeuralNetwork()
    net.set_params([(rng.standard_normal((14, 8)) * 0.3,
                     rng.standard_normal(8) * 0.1),
                    (rng.standard_normal((8, 4)) * 0.3,
                     rng.standard_normal(4) * 0.1)])
    scales = np.array([np.zeros(14), np.ones(14) * 20, np.zeros(4),
                       np.ones(4)], dtype=object)
    net.set_scales(scales)
    wpath, spath = str(nn_dir / "w.npz"), str(nn_dir / "s.npy")
    net.save_npz(wpath)
    np.save(spath, scales, allow_pickle=True)
    t = np.linspace(0, 100, 41)
    feats = np.array([[STAUB_TRUE[n] for n in
                       ("p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Sf", "Sb",
                        "tauN", "tauP")]
                      + [1 / STAUB_TRUE["eps"], 2.12e11, 6e4, 311.0]])
    e_data = ([t], [np.log10(net.predict(t, feats).numpy())],
              [np.full(len(t), 0.05)])
    sim_info = {"lengths": [311.0], "nx": [128], "meas_types": ["TRPL"],
                "num_meas": 1}
    pi = staub_param_info()
    ini = np.array([[2.12e11, 6e4, 1]])
    mcmc = {"init_cond_path": "x", "measurement_path": "x",
            "output_path": str(nn_dir / "out"), "ini_mode": "fluence",
            "num_iters": N_ITERS_NN, "solver": ("NN", wpath, spath),
            "model": "std", "model_uncertainty": 1, "log_y": 1,
            "hard_bounds": 1, "checkpoint_freq": N_ITERS_NN,
            "parallel_tempering": [1., 2., 4., 8., 16., 32., 64., 128.],
            "temper_freq": 10, "load_checkpoint": None}
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    ens = metro(sim_info, ini, e_data, dict(mcmc), pi, device="cuda",
                export_path="nn.pik", seed=5, trap_signals=False)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    H = ens.H
    K = H.accept.shape[0]
    print(f"phase 15: NN walk, {N_ITERS_NN} iterations x {K} chains in "
          f"{walk_s:.2f} s: {N_ITERS_NN * K / walk_s:.1f} walker-steps/s on "
          f"{card}; cold-chain acceptance {H.accept[0, 1:].mean():.3f}; "
          f"kernel launches {sum(launches.values())}")
    if sum(launches.values()) or not np.isfinite(H.loglikelihood[0]).all():
        raise RuntimeError("phase 15: the NN walk launched a solve kernel or "
                           "its cold chain is not finite")
    plan = build_likelihood_plan(sim_info, pi, mcmc, e_data, ini)
    names = list(STAUB_NAMES)
    base = np.array([STAUB_TRUE[n] for n in names])
    active = np.array([bool(pi["active"][n]) for n in names])
    st = base[None] * 10.0 ** (np.random.default_rng(2).uniform(
        -0.1, 0.1, (8, len(names))) * active[None])
    temps = np.asarray(mcmc["parallel_tempering"])
    cpu = torch.device("cpu")
    pm = {(d.type, dt): make_eval_logll(plan, dtype=dt, device=d)(
        torch.as_tensor(st, dtype=dt, device=d),
        torch.as_tensor(temps, dtype=dt, device=d))["per_meas"].cpu(
        ).double().numpy() for d in (dev, cpu) for dt in (f32, f64)}
    fin = np.isfinite(pm[("cpu", f64)])

    def rel(a, b):
        return np.abs(a[fin] - b[fin]).max() / np.abs(b[fin]).max()

    # float32 carries ~3e-5 of rounding against float64 on this curve
    # (exp of rate * t ~ -76 and log10 of values down to 1e-33), on either
    # device, so the float32 limit sits above it; float64 must agree
    errs = {dt: rel(pm[(dev.type, dt)], pm[("cpu", dt)]) for dt in (f32, f64)}
    floor = rel(pm[("cpu", f32)], pm[("cpu", f64)])
    limits = {f32: 1e-4, f64: 1e-9}
    print(f"phase 15: NN eval_logll card vs CPU, 8 states x 8 temperatures "
          f"(max |diff| / max |ll|): float64 {errs[f64]:.3e} (limit 1e-9), "
          f"float32 {errs[f32]:.3e} (limit 1e-4; float32 against float64 "
          f"on the CPU: {floor:.3e}); finite {int(fin.sum())} of {fin.size}")
    if (fin.sum() == 0 or any(
            not np.array_equal(np.isfinite(a), fin) for a in pm.values())
            or any(errs[dt] > limits[dt] for dt in limits)):
        raise RuntimeError("phase 15: the card's NN evaluation differs from "
                           "the CPU's")
    return launches


def phase16_pa(card, work, cli):
    """The pa toy walk: `write-pa-example` then `cli mcmc --device cuda`
    for 500 iterations. Returns the walk's launches."""
    import numpy as np

    from metrotrpl_tpu_torch.inference.metropolis import load_checkpoint
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    pa = work / "pa"
    pa.mkdir()
    cli(["write-pa-example", str(pa / "pa.txt"), "--num-iters",
         str(N_ITERS_PA), "--init-cond", str(pa / "pa_ic.csv"),
         "--measurement", str(pa / "pa_data.csv"), "--output",
         str(pa / "out")])
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    cli(["mcmc", str(pa / "pa.txt"), "--device", "cuda"])
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    H = load_checkpoint(str(pa / "out" / "CPU0-final.pik")).H
    K = H.accept.shape[0]
    print(f"phase 16: pa walk, {N_ITERS_PA} iterations x {K} chains in "
          f"{walk_s:.2f} s: {N_ITERS_PA * K / walk_s:.1f} walker-steps/s on "
          f"{card}; acceptance per chain "
          f"{np.round(H.accept[:, 1:].mean(axis=1), 3).tolist()}, swaps "
          f"accepted {H.swap_accept.tolist()}; kernel launches "
          f"{sum(launches.values())}")
    if (not np.isfinite(H.loglikelihood).all()
            or not np.isfinite(H.states).all()
            or H.accept.shape[1] != N_ITERS_PA):
        raise RuntimeError("phase 16: the pa walk is not finite or short")
    return launches


def phase17_runtime(card):
    """The native runtime: the CSV parser and the compiled std RHS build;
    the RHS, the parser and the oracle's native path against their numpy
    versions."""
    import numpy as np

    from metrotrpl_tpu_torch import runtime
    from metrotrpl_tpu_torch.constants import eps0, q_C
    from metrotrpl_tpu_torch.oracle import solve_reference
    from metrotrpl_tpu_torch.oracle.scipy_reference import (
        beer_lambert,
        dydt_std,
        efield_init,
    )
    from metrotrpl_tpu_torch.workloads import STAUB_TRUE, STAUB_UC

    if not (runtime.native_available() and runtime.native_rhs_available()):
        raise RuntimeError("phase 17: the native runtime did not build "
                           "(g++ into metrotrpl_tpu_torch/runtime/_build)")
    # a flagship state: staub truth, 311 nm, nx=128, the Beer-Lambert
    # profile at 2.12e11 cm^-2 with its initial field
    nx, L = 128, 311.0
    dx = L / nx
    pm = {k: v * STAUB_UC.get(k, 1) for k, v in STAUB_TRUE.items()}
    x = np.linspace(dx / 2, L - dx / 2, nx)
    ic = beer_lambert(2.12e11 * 1e-14, 6e4 * 1e-7, x)
    N, P = ic + pm["n0"], ic + pm["p0"]
    y = np.concatenate([N, P, efield_init(N, P, pm["n0"], pm["p0"],
                                          pm["eps"], dx)])
    lam = q_C / (pm["eps"] * eps0)
    ref = dydt_std(0.0, y, nx, dx, pm["n0"], pm["p0"], pm["mu_n"],
                   pm["mu_p"], pm["ks"], pm["Cn"], pm["Cp"], pm["Sf"],
                   pm["Sb"], pm["tauN"], pm["tauP"], lam, pm["Tm"])
    dy = runtime.dydt_std_native(y, nx, dx, pm)
    rel = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(
        np.split(dy, [nx, 2 * nx]), np.split(ref, [nx, 2 * nx])))
    print(f"phase 17: native std RHS vs numpy on a flagship state (nx=128): "
          f"max rel err per block {rel:.3e} (limit 1e-12)")
    if not rel <= 1e-12:
        raise RuntimeError(f"phase 17: native RHS rel err {rel}")
    names = sorted(f.name for f in (REPO / "Inputs").glob("*.csv"))
    for name in names:
        path = str(REPO / "Inputs" / name)
        a, b = runtime.load_csv(path), np.loadtxt(path, delimiter=",")
        if a.shape != b.shape or a.dtype != b.dtype \
                or not np.array_equal(a, b):
            raise RuntimeError(f"phase 17: load_csv({name}) differs from "
                               "np.loadtxt")
    print(f"phase 17: load_csv equals np.loadtxt bit for bit on {names}")
    t = np.linspace(0, 2000, 501)
    secs, curves = {}, {}
    for rhs in ("numpy", "native"):
        t0 = time.perf_counter()
        curves[rhs] = solve_reference(ic, L, nx, t, pm, rhs=rhs)
        secs[rhs] = time.perf_counter() - t0
    rel = np.max(np.abs(curves["native"] - curves["numpy"])
                 / np.abs(curves["numpy"]))
    print(f"phase 17: solve_reference nx=128, 501 points to 2000 ns: "
          f"rhs=numpy {secs['numpy']:.3f} s, rhs=native "
          f"{secs['native']:.3f} s (host CPU of {card}); max rel diff "
          f"{rel:.3e} (limit 1e-9)")
    if not rel <= 1e-9:
        raise RuntimeError(f"phase 17: native oracle rel diff {rel}")


def phase18_quicksim(card, work):
    """Quicksim on the card from the std and traps walks' checkpoints:
    the GUI's data layer, run_tasks on the double kernels against the
    plain version on the CPU, and a QuicksimManager round trip. Returns
    the launches of the card's run_tasks calls."""
    import numpy as np

    from metrotrpl_tpu_torch.gui.popups import EXT_DEFAULTS
    from metrotrpl_tpu_torch.gui.quicksim import (
        QuicksimManager,
        QuicksimTask,
        run_tasks,
    )
    from metrotrpl_tpu_torch.gui.window import export_all, load_ensemble_chains
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    f64 = torch.float64
    gui = work / "gui"
    gui.mkdir()
    batches = {}
    for model, run, n_tasks in (("std", "run", 4), ("traps", "run_traps", 2)):
        chains, meta = load_ensemble_chains(str(work / run /
                                                "CPU0-final.pik"))
        out_dir = export_all(chains, meta, out_parent=str(gui),
                             tstamp=model)
        ef = meta["ensemble"].ensemble_fields
        units = {n: float(u) for n, u in zip(meta["names"], ef["units"])}
        ext = {k: float(v) for k, v in EXT_DEFAULTS.items()}
        tasks = [QuicksimTask(
            thickness=ext["thickness"], nx=int(ext["nx"]),
            final_time=ext["final_time"], nt=int(ext["nt"]),
            fluence=ext["fluence"], absp=ext["absp"],
            direction=ext["direction"], model=ef["model"],
            params={p: float(np.asarray(c.data[p])[-1])
                    for p in meta["names"]}) for c in chains[:n_tasks]]
        print(f"phase 18 {model}: {len(chains)} chains loaded, exported to "
              f"{out_dir} ({len(list(Path(out_dir).iterdir()))} files); "
              f"{n_tasks} tasks from the last states")
        batches[model] = (tasks, units)

    sk.reset_launch_counts()
    cards, ms = {}, {}
    for model, (tasks, units) in batches.items():
        run_tasks(tasks, units=units, device="cuda")   # plan and warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cards[model] = run_tasks(tasks, units=units, device="cuda")
        ms[model] = (time.perf_counter() - t0) * 1e3
    launches = dict(sk.LAUNCHES)
    for model, (tasks, units) in batches.items():
        t0 = time.perf_counter()
        plain = run_tasks(tasks, units=units, device="cpu")
        plain_s = time.perf_counter() - t0
        rel = max(np.max(np.abs(a[1] - b[1]) / np.abs(b[1]))
                  for a, b in zip(cards[model], plain))
        fin = all(np.isfinite(a[1]).all() and a[1].shape == (tasks[0].nt,)
                  for a in cards[model])
        print(f"phase 18 {model}: run_tasks B={len(tasks)} nx=128, "
              f"{tasks[0].nt} knots to {tasks[0].final_time:g} ns: card "
              f"{ms[model]:.3f} ms per batch on {card}, plain PyTorch on "
              f"the CPU {plain_s:.2f} s; max rel diff {rel:.3e} (limit "
              f"1e-9); launches {model} f64 {launches[(model, f64)]}")
        if not (fin and rel <= 1e-9):
            raise RuntimeError(f"phase 18 {model}: the card's quicksim "
                               f"differs from the plain version ({rel}) or "
                               "is not finite")
        if launches[(model, f64)] != 2:
            raise RuntimeError(f"phase 18 {model}: {launches[(model, f64)]} "
                               "double launches for 2 batches")

    tasks, units = batches["std"]
    qs = QuicksimManager(device="cuda")
    t0 = time.perf_counter()
    qs.simulate(tasks, units=units)
    items, done = [], False
    while not done and time.perf_counter() - t0 < 300:
        got, done = qs.poll()
        items.extend(got)
        time.sleep(0.2)
    qs.join(30)
    rt = time.perf_counter() - t0
    errors = [msg for idx, _, _, msg in items if idx < 0]
    if not done or errors or len(items) != len(tasks):
        raise RuntimeError(f"phase 18: the quicksim child did not finish "
                           f"({done}, {len(items)} results, {errors})")
    rel = max(np.max(np.abs(s - cards["std"][idx][1])
                     / np.abs(cards["std"][idx][1]))
              for idx, _, s, _ in items)
    print(f"phase 18: QuicksimManager(device='cuda') round trip of "
          f"{len(tasks)} std tasks in a spawned child: {rt:.2f} s (the "
          f"child's start, imports and library load included); max rel "
          f"diff from the parent's card solve {rel:.3e} (limit 1e-9)")
    if not rel <= 1e-9:
        raise RuntimeError(f"phase 18: the child's solve differs ({rel})")
    return launches


def phase19_posterior(card, dev):
    """The posterior script's fast legs, short: std 32 x 1000, traps 32 x
    500. Then the model's float kernel against its plain version at the
    leg's last 32 states x its curves on the three plans the full legs
    run: the fast plan, its ladder's chord-free plan, and the gold leg's
    plan. Returns ({model: the leg's launches}, {model: the comparisons})."""
    import numpy as np

    sys.path.insert(0, str(REPO / "scripts"))
    import posterior_torch

    f32 = torch.float32
    launches, checks = {}, {}
    for model, n_iters in (("std", N_ITERS_POST),
                           ("traps", N_ITERS_POST_TRAPS)):
        w = posterior_torch.WORKLOADS[model]()
        t0 = time.perf_counter()
        t, vals = posterior_torch.make_dataset(w)
        data_s = time.perf_counter() - t0
        r = posterior_torch.run_leg(w, t, vals, "fast", n_iters,
                                    posterior_torch.N_CHAINS, "cuda",
                                    log=lambda line: None)
        launches[model] = r["launches"]
        n32 = r["launches"][(model, f32)]
        print(f"phase 19 {model}: fast leg, {r['n_chains']} chains x "
              f"{n_iters} iterations in {r['seconds']:.2f} s (dataset "
              f"{data_s:.1f} s before it): "
              f"{r['walker_steps_per_s']:.1f} walker-steps/s past the initial "
              f"evaluation on {card}; acceptance {r['acceptance']:.3f}; "
              f"launches per iteration "
              f"{ {k: round(v, 3) for k, v in r['launches_per_iteration'].items()} }; "
              f"repaired rows per iteration "
              f"{r['repaired_rows_per_iteration']:.3f} of "
              f"{r['rows_per_iteration']}")
        if not (np.isfinite(r["states"]).all() and np.isfinite(r["ll"]).all()):
            raise RuntimeError(f"phase 19 {model}: a state or its "
                               "log-likelihood is not finite")
        if not 0.05 <= r["acceptance"] <= 0.8:
            raise RuntimeError(f"phase 19 {model}: acceptance "
                               f"{r['acceptance']}")
        if n32 < n_iters:
            raise RuntimeError(f"phase 19 {model}: the float {model} kernel "
                               f"launched {n32} < {n_iters} times")
        # the fast leg's plan and its ladder's, then the gold leg's plan
        checks[model] = posterior_torch.kernel_checks(r, card, dev)
        g = posterior_torch.LEGS["gold"]
        gold = posterior_torch.build_plans(w, t, vals, g["hmax"],
                                           g["refactor"], g["refine"])[0]
        c = kernel_vs_plain(card, dev, gold, gold.fwd[0][1], f32,
                            r["states"], f"phase 19 {model} gold plan")
        print(f"{model} gold leg's plan: {c.pop('line')}")
        checks[model].append(dict(plan="gold leg's plan", **c))
    return launches, checks


def phase20_mesh(card, work, fluences, layouts=MESH_LAYOUTS):
    """The sharded flagship walk: metro(mesh_shape=...), E=2 ensembles x
    8 chains, the float64 rung on, at each of layouts ((d_e, d_c, shared):
    by default 1x1 (NCCL, a world of one), 2x1 and 1x2 (gloo, ranks
    sharing cuda:0); scripts/mesh_cards.py gives a card per rank on a
    host with several). Each layout walks 50
    iterations, then resumes from its per-replica checkpoints to 100; its
    History (states, ll, accepts, swap counters) must equal the fused
    metro(n_ensembles=2) walk of 100 iterations at the same seeds bit for
    bit, after the first half and after the resume. Each rank's report
    (mesh_rank{r}.json) gives its backend and its launches and rows: the
    std float kernel must launch once per iteration per rank on E_l*K_l*6
    rows, the std double kernel (the rung) at least once in the layout.
    Returns {layout: summed (model, dtype) launches of its ranks}."""
    import json

    import numpy as np

    from metrotrpl_tpu_torch.cli import _load_common, write_example_config
    from metrotrpl_tpu_torch.inference.metropolis import metro
    from metrotrpl_tpu_torch.parallel import mesh_backend, mesh_devices
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    tags = {"std_f32": ("std", f32), "std_f64": ("std", f64),
            "traps_f32": ("traps", f32), "traps_f64": ("traps", f64)}
    fields = ("states", "loglikelihood", "accept", "swap_attempts",
              "swap_accept")
    configs = {}
    for n in (N_ITERS_MESH // 2, N_ITERS_MESH):
        path = work / f"mesh{n}.txt"
        write_example_config(str(path), model="std", fast=True, num_iters=n,
                             init_cond=str(fluences),
                             measurement=str(work / "staub_nonoise.csv"),
                             output=str(work / "mesh"),
                             checkpoint_freq=N_ITERS_MESH // 2)
        configs[n] = _load_common(str(path))

    def walk(n, out, load=None, **kw):
        sim, pi, _f, mc, ini, ed = configs[n]
        t0 = time.perf_counter()
        enss = metro(sim, ini, ed, dict(mc, output_path=str(work / out),
                                        load_checkpoint=load), pi,
                     device="cuda", trap_signals=False, seed=MESH_SEED,
                     n_ensembles=2, **kw)
        torch.cuda.synchronize()
        return enss, time.perf_counter() - t0

    sk.reset_launch_counts()
    ref, ref_s = walk(N_ITERS_MESH, "mesh_fused")
    K = ref[0].H.accept.shape[0]
    steps = N_ITERS_MESH * K * 2
    print(f"phase 20: fused metro(n_ensembles=2), {N_ITERS_MESH} iterations "
          f"x {K} chains: {steps / ref_s:.1f} aggregate walker-steps/s (plan "
          f"build and first evaluation included) on {card}; launches std "
          f"f32 {sk.LAUNCHES[('std', f32)]} f64 {sk.LAUNCHES[('std', f64)]}")

    def same(enss, upto, label):
        """History to iteration upto (and the swap counters, at the end)
        against the fused walk's."""
        for e, (x, y) in enumerate(zip(enss, ref)):
            for a in fields[:3] if upto < N_ITERS_MESH else fields:
                u, v = getattr(x.H, a), getattr(y.H, a)
                if a in fields[:3]:
                    u, v = u[..., :upto], v[..., :upto]
                if not np.array_equal(u, v):
                    bad = np.argwhere(u != v)[0].tolist()
                    raise RuntimeError(
                        f"phase 20 {label}: replica {e} {a} differs from the "
                        f"fused walk's, first at {bad}: {u[tuple(bad)]!r} vs "
                        f"{v[tuple(bad)]!r}")

    launches = {}
    for d_e, d_c, shared in layouts:
        n_ranks = d_e * d_c
        label = f"{d_e}x{d_c}" + ("" if shared or n_ranks == 1
                                  else "_own_cards")
        devices = ["cuda:0"] * n_ranks if shared else None
        want_backend = mesh_backend(mesh_devices((d_e, d_c), devices))
        out = f"mesh_{label}"
        tot = {k: 0 for k in tags.values()}
        reports, secs = [], []
        for n, load in ((N_ITERS_MESH // 2, None),
                        (N_ITERS_MESH, "CPU{e}-final.pik")):
            enss, s = walk(n, out, load, mesh_shape=(d_e, d_c),
                           devices=devices)
            secs.append(s)
            same(enss, n, f"{label} after {n} iterations")
            reps = []
            for r in range(n_ranks):
                with open(work / out / f"mesh_rank{r}.json") as f:
                    reps.append(json.load(f))
            rows_per_launch = (2 // d_e) * (K // d_c) * 6
            for rep in reps:
                n32 = rep["launches"]["std_f32"]
                if (rep["backend"] != want_backend or n32 != N_ITERS_MESH // 2
                        or rep["rows"]["std_f32"] != n32 * rows_per_launch):
                    raise RuntimeError(
                        f"phase 20 {label}: rank {rep['rank']} ran "
                        f"{rep['backend']} with {n32} std f32 launches on "
                        f"{rep['rows']['std_f32']} rows (want {want_backend},"
                        f" {N_ITERS_MESH // 2} launches of "
                        f"{rows_per_launch} rows)")
                for key, v in rep["launches"].items():
                    tot[tags[key]] += v
            reports.append(reps)
        if tot[("std", f64)] < 1:
            raise RuntimeError(f"phase 20 {label}: the float64 rung never "
                               "launched")
        launches[label] = tot
        in_rank = [max(r["walk_s"] for r in reps) for reps in reports]
        print(f"phase 20 {label}: {n_ranks} rank(s) on "
              f"{devices or 'a card each'}, backend "
              f"{reports[0][0]['backend']}: {N_ITERS_MESH // 2} + "
              f"{N_ITERS_MESH // 2} iterations resumed from "
              f"CPU{{e}}-final.pik equal the fused walk bit for bit (History "
              f"and swap counters, after each half); "
              f"{steps / sum(secs):.1f} aggregate walker-steps/s with spawn "
              f"({secs[0]:.2f} + {secs[1]:.2f} s), "
              f"{steps / sum(in_rank):.1f} inside the ranks' walks "
              f"({in_rank[0]:.2f} + {in_rank[1]:.2f} s) against the fused "
              f"walk's {steps / ref_s:.1f}, on {card}; per rank std f32 / f64 "
              "launches (first half + resume): " + "; ".join(
                  f"rank {a['rank']} ({a['i_e']},{a['i_c']}) "
                  f"{a['launches']['std_f32']}+{b['launches']['std_f32']} on "
                  f"{a['rows']['std_f32'] // max(a['launches']['std_f32'], 1)}"
                  f" rows / {a['launches']['std_f64']}+"
                  f"{b['launches']['std_f64']} on "
                  f"{a['rows']['std_f64'] + b['rows']['std_f64']} rows"
                  for a, b in zip(*reports)))
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase21_flagship(card, dev):
    """The flagship posterior's pieces (scripts/flagship_torch.py): its
    dataset, whose digest must be the committed oracle chain's; a short
    production leg, 8 ensembles x 4 temperatures x N_ITERS_FLAGSHIP
    iterations in float32 with the float64 rung, whose states and ll must
    be finite and whose std float kernel must launch at least once per
    iteration, every launch on 192 rows; the 8 committed ridge states
    through the leg's evaluation on the card, against the committed
    oracle ll and against the same evaluation through the plain version
    on the host; and each std instantiation against its plain version at
    the leg's last 8 cold states x 6 curves (float on the fast plan,
    double on the rung's). Returns (the leg's launches, the comparisons)."""
    import numpy as np

    sys.path.insert(0, str(REPO / "scripts"))
    import flagship_torch

    from metrotrpl_tpu_torch.inference.likelihood import make_eval_logll

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    w = flagship_torch.flagship_workload()
    t, vals, digest = flagship_torch.checked_dataset(w)
    data_s = time.perf_counter() - t_phase
    r = flagship_torch.walk_leg(w, t, vals, "f32", N_ITERS_FLAGSHIP, dev,
                                log=lambda line: None)
    n32, rows32 = r["launches"][("std", f32)], r["rows"][("std", f32)]
    lpi = {k: round(v, 3) for k, v in r["launches_per_iteration"].items()}
    print(f"phase 21: flagship dataset in {data_s:.1f} s, SHA-256 {digest} "
          f"(the oracle chain's); leg of {r['n_chains']} ensembles x "
          f"{r['n_temps']} temperatures x {N_ITERS_FLAGSHIP} iterations in "
          f"{r['seconds']:.2f} s: {r['walker_steps_per_s']:.1f} "
          f"walker-steps/s, {r['ms_per_iteration']:.3f} ms an iteration "
          f"past the initial evaluation on {card}; cold-chain acceptance "
          f"{r['acceptance']:.3f}; launches per iteration {lpi}; std f32 "
          f"{n32} launches on {rows32} rows; repaired rows per iteration"
          f" {r['repaired_rows_per_iteration']:.3f} of "
          f"{r['rows_per_iteration']}")
    if not (np.isfinite(r["states"]).all() and np.isfinite(r["ll"]).all()):
        raise RuntimeError("phase 21: a state or its log-likelihood is not "
                           "finite")
    if n32 < N_ITERS_FLAGSHIP or rows32 != n32 * r["rows_per_iteration"] \
            or r["rows_per_iteration"] != 192:
        raise RuntimeError(f"phase 21: the std float kernel launched {n32} "
                           f"times on {rows32} rows (want at least "
                           f"{N_ITERS_FLAGSHIP} launches of 192 rows)")

    # the ridge states through the leg's evaluation (float32 walk, the
    # float64 rung), on the card and through the plain version on the host
    ridge = np.load(flagship_torch.RIDGE_STATES)
    rstates = np.stack([ridge[n] if n in ridge.files
                        else np.full(8, w.true[n]) for n in w.names], axis=1)
    ll_o = ridge["ll_o"]

    def ridge_ll(where):
        ev = make_eval_logll(r["plan"], dtype=f32, device=where)
        o = ev(torch.as_tensor(rstates, dtype=f32, device=where),
               torch.ones(1, dtype=f32, device=where))
        return (o["logll_T"][:, 0].double().cpu().numpy(),
                o["repair_states"].cpu().numpy())

    (ll_k, rep_k), (ll_p, rep_p) = map(ridge_ll, (dev, torch.device("cpu")))
    dll, dll_p = np.abs(ll_k - ll_o), np.abs(ll_p - ll_o)
    print("phase 21 ridge states (mu_n " + ", ".join(
        f"{m:.1f}" for m in ridge["mu_n"]) + f"): |ll - oracle ll| on the "
          f"card {np.round(dll, 4).tolist()}, through the plain version "
          f"{np.round(dll_p, 4).tolist()}; card - plain max "
          f"{np.abs(ll_k - ll_p).max():.3e}; rows repaired per state "
          f"{rep_k.tolist()} (plain {rep_p.tolist()})")
    if not (np.isfinite(ll_k).all() and np.array_equal(rep_k, rep_p)
            and np.all(np.abs(ll_k - ll_p) <= RIDGE_CARD_RTOL * np.abs(ll_p))):
        raise RuntimeError("phase 21: the card's ridge evaluation is not "
                           "finite or differs from the plain version's")
    if len(dll) != len(RIDGE_DLL_LIMITS):
        raise RuntimeError(f"phase 21: {len(dll)} ridge states, want "
                           f"{len(RIDGE_DLL_LIMITS)}")
    miss = ~(dll <= np.asarray(RIDGE_DLL_LIMITS))
    if miss.any():
        raise RuntimeError(f"phase 21: ridge states {np.nonzero(miss)[0]} "
                           f"over their |dll| limits {RIDGE_DLL_LIMITS} on "
                           "the card")
    print(f"phase 21: every ridge state within its |dll| limit "
          f"{RIDGE_DLL_LIMITS} of the oracle")

    # each std instantiation against its plain version at the leg's last
    # cold states
    cold = r["states"].reshape(r["n_chains"], r["n_temps"], -1)[:, 0]
    _, fp, fp_hi = r["plan"].fwd[0]
    checks = {}
    for label, fp_x, dtype in (("std_f32", fp, f32), ("std_f64", fp_hi, f64)):
        c = kernel_vs_plain(card, dev, r["plan"], fp_x, dtype, cold,
                            f"phase 21 {label}")
        print(f"phase 21 {label} at the leg's last {len(cold)} cold states: "
              f"{c.pop('line')}")
        checks[label] = c
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return r["launches"], checks


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "check needs a CUDA device")
    import numpy as np

    from metrotrpl_tpu_torch.cli import _load_common
    from metrotrpl_tpu_torch.cli import main as cli
    from metrotrpl_tpu_torch.cli import write_example_config
    from metrotrpl_tpu_torch.inference.likelihood import (
        ESCALATE_MU_MODEL,
        make_eval_logll,
    )
    from metrotrpl_tpu_torch.inference.metropolis import (
        build_mh_kernel,
        load_checkpoint,
        metro,
        plans_from_config,
        vmap_ensembles,
    )
    from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
    from metrotrpl_tpu_torch.inference.moves import n_tries
    from metrotrpl_tpu_torch.solver import solve_kernel as sk
    from metrotrpl_tpu_torch.workloads import STAUB_TRUE, TRAPS_TRUE

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    card = nvidia_smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # ---- phase 1: build the kernel from the checkout's sources ----
    t0 = time.perf_counter()
    lib = sk.kernel_library()
    print(f"phase 1: kernel library {lib.path.name}: nvcc "
          f"{lib.build_seconds:.2f} s, ready in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # the flagship config as `write-example --fast` writes it (data
    # synthesized by the float64 LSODA oracle at the staub truth),
    # checkpoint every 100; the traps config beside it, from the same
    # builder
    work = REPO / "chip_smoke_out"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fluences = REPO / "Inputs" / "staub_MAPI_threepower_twothick_fluences.csv"
    cfg, cfg_traps = work / "flagship.txt", work / "traps.txt"
    for path, model, n_iters, ckpt, data, out in (
            (cfg, "std", N_ITERS, 100, "staub_nonoise.csv", "run"),
            (cfg_traps, "traps", N_ITERS_TRAPS, 50,
             "staub_traps_nonoise.csv", "run_traps")):
        t0 = time.perf_counter()
        write_example_config(str(path), model=model, fast=True,
                             num_iters=n_iters, init_cond=str(fluences),
                             measurement=str(work / data),
                             output=str(work / out), checkpoint_freq=ckpt)
        print(f"{model} config and oracle data: "
              f"{time.perf_counter() - t0:.1f} s")

    def load_plan(path, model):
        sim_info, param_info, _f, mcmc, iniPar, e_data = _load_common(
            str(path))
        plan, move = plans_from_config(sim_info, param_info, dict(mcmc),
                                       e_data, iniPar)
        g_idx, fp, fp_hi = plan.fwd[0]
        if (fp.nx != 128 or len(g_idx) != 6 or fp.model != model
                or fp_hi.solve_dtype != "float64"):
            raise RuntimeError(f"the {model} plan is not nx=128 x 6 with "
                               "an f64 rung")
        return plan, move, param_info, mcmc

    plan, move, param_info, mcmc = load_plan(cfg, "std")
    plan_t, _, param_info_t, _ = load_plan(cfg_traps, "traps")
    temps = torch.as_tensor(np.asarray(mcmc["parallel_tempering"]),
                            dtype=f32, device=dev)

    results = {}

    def flagship_vs_plain(phase, pl, pinfo, truth):
        """Both instantiations of pl's model against the plain version on
        8 states (+-0.1 dex on the active parameters) x 6 measurements:
        float32 on the fast plan, float64 on the rung plan."""
        names = list(pl.param_names)
        rng = np.random.default_rng(0)
        base = np.array([truth[n] for n in names], dtype=float)
        active = np.array([bool(pinfo["active"][n]) for n in names])
        states = base[None] * 10.0 ** (
            rng.uniform(-0.1, 0.1, (8, len(names))) * active[None])
        _, fp, fp_hi = pl.fwd[0]
        for dlabel, fp_x, dtype in (("f32", fp, f32), ("f64", fp_hi, f64)):
            label = f"{fp_x.model}_{dlabel}"
            r = kernel_vs_plain(card, dev, pl, fp_x, dtype, states, label)
            ms_b9 = None
            if dlabel == "f64":
                # the rung's rows per iteration in a profiled flagship walk
                (p9, y9, dt9, dx9), kw = kernel_inputs(dev, pl, states,
                                                       fp_x, dtype)
                args9 = (type(p9)(*(a[:9] for a in p9)), y9[:9], dt9[:, :9],
                         dx9[:9])
                ms_b9 = cuda_ms(
                    lambda: sk.integrate_observables_cuda(*args9, **kw), 20)
                print(f"phase {phase} {label}: B=9 nx=128 n_steps="
                      f"{fp_x.n_steps}: kernel {ms_b9:.3f} ms on {card}")
            results[label] = dict(
                max_abs_err=r["max_abs_err"], max_rel_err=r["max_rel_err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None, ms_b9=ms_b9,
                tolerance=r["tolerance"], shape=r["shape"])
            print(f"phase {phase} {label}: {r['line']}")

    def walk(phase, path, run_dir, n_iters, model):
        """`cli mcmc --device cuda` on path; checks the pickle, the
        cold chain and the launches of the model's kernels."""
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        cli(["mcmc", str(path), "--device", "cuda"])
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        ens = load_checkpoint(str(run_dir / "CPU0-final.pik"))
        H = ens.H
        K = H.accept.shape[0]
        acc_cold = float(H.accept[0, 1:].mean())
        n32, n64 = launches[(model, f32)], launches[(model, f64)]
        print(f"phase {phase}: {model} walk, {n_iters} iterations x {K} "
              f"chains in {walk_s:.2f} s (plan build and first evaluation "
              f"included): {n_iters * K / walk_s:.1f} walker-steps/s on "
              f"{card}; cold-chain acceptance {acc_cold:.3f}; swaps "
              f"accepted {H.swap_accept.tolist()} of "
              f"{H.swap_attempts.tolist()}; launches {model} f32 {n32} "
              f"f64 {n64}, of the other model "
              f"{sum(launches.values()) - n32 - n64}")
        if ens.latest_iter != n_iters or H.accept.shape != (K, n_iters):
            raise RuntimeError(f"phase {phase}: the checkpoint does not "
                               "hold the walk")
        if ens.ensemble_fields["model"] != model:
            raise RuntimeError(f"phase {phase}: the checkpoint is not a "
                               f"{model} walk")
        if not np.isfinite(H.loglikelihood[0]).all():
            raise RuntimeError(f"phase {phase}: non-finite cold-chain "
                               "log-likelihood")
        if not 0.05 <= acc_cold <= 0.8:
            raise RuntimeError(f"phase {phase}: cold-chain acceptance "
                               f"{acc_cold}")
        if n32 < n_iters:
            raise RuntimeError(f"phase {phase}: the float32 {model} kernel "
                               f"launched {n32} < {n_iters} times")
        return launches

    def ladder(phase, pl, states, model):
        """eval_logll of states in a float32 walk on plan pl: the float64
        instantiation of the model must launch, every logll_T be finite."""
        ev = make_eval_logll(pl, dtype=f32, device=dev)
        sk.reset_launch_counts()
        out = ev(torch.as_tensor(states, dtype=f32, device=dev), temps)
        torch.cuda.synchronize()
        ll = out["logll_T"].cpu().numpy()
        n64 = sk.LAUNCHES[(model, f64)]
        print(f"phase {phase}: {model} ladder: repaired rows per state "
              f"{out['repair_states'].tolist()}, fail_states "
              f"{out['fail_states'].tolist()}, f64 launches {n64}, "
              f"logll_T(T=1) {np.round(ll[:, 0], 3).tolist()}")
        if n64 < 1 or not np.isfinite(ll).all():
            raise RuntimeError(f"phase {phase}: the float64 {model} rung "
                               "did not launch or a logll_T is not finite")

    # ---- phase 2: std kernel vs plain version at the flagship shape ----
    flagship_vs_plain(2, plan, param_info, STAUB_TRUE)

    # ---- phase 3: the float64 rung on the flagship ridge states ----
    ridge = np.load(REPO / "scripts" / ".probe_r14_ridge_states.npz")
    rstates = np.stack([ridge[n] if n in ridge.files
                        else np.full(8, STAUB_TRUE[n], dtype=float)
                        for n in plan.param_names], axis=1)
    ladder(3, plan, rstates, "std")

    # ---- phase 4: the std main path, `cli mcmc --device cuda` ----
    launches_std = walk(4, cfg, work / "run", N_ITERS, "std")
    if launches_std[("std", f64)] < 1:
        raise RuntimeError("phase 4: the float64 rung never launched")

    # ---- phase 5: traps kernel vs plain version ----
    truth_t = {**STAUB_TRUE, **TRAPS_TRUE}
    flagship_vs_plain(5, plan_t, param_info_t, truth_t)

    # ---- phase 6: the traps ladder just above the mobility trigger ----
    names_t = list(plan_t.param_names)
    tstates = np.tile(np.array([truth_t[n] for n in names_t]), (8, 1))
    mu_entry = ESCALATE_MU_MODEL / plan_t.units[names_t.index("mu_n")]
    tstates[:, names_t.index("mu_n")] = mu_entry * np.linspace(1.02, 1.2, 8)
    ladder(6, plan_t, tstates, "traps")

    # ---- phase 7: the traps main path ----
    launches_traps = walk(7, cfg_traps, work / "run_traps", N_ITERS_TRAPS,
                          "traps")

    def flagship_config(name, n_iters, ckpt, out):
        """The flagship config (std, the phase-4 data) with another walk
        length, checkpoint interval and output directory."""
        path = work / name
        write_example_config(str(path), model="std", fast=True,
                             num_iters=n_iters, init_cond=str(fluences),
                             measurement=str(work / "staub_nonoise.csv"),
                             output=str(work / out), checkpoint_freq=ckpt)
        return path

    # ---- phase 8: the fused std walk, `cli mcmc --ensembles 8` ----
    cfg_e8 = flagship_config("fused.txt", N_ITERS_FUSED, N_ITERS_FUSED // 2,
                             "run_e8")
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    cli(["mcmc", str(cfg_e8), "--ensembles", str(E_FUSED), "--device",
         "cuda"])
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launches_e8 = dict(sk.LAUNCHES)
    enss = [load_checkpoint(str(work / "run_e8" / f"CPU{j}-final.pik"))
            for j in range(E_FUSED)]
    K = enss[0].H.accept.shape[0]
    acc_cold = [float(e.H.accept[0, 1:].mean()) for e in enss]
    n32, n64 = launches_e8[("std", f32)], launches_e8[("std", f64)]
    print(f"phase 8: fused std walk, {E_FUSED} ensembles x {N_ITERS_FUSED} "
          f"iterations x {K} chains in {fused_s:.2f} s (plan build and "
          f"first evaluation included): "
          f"{N_ITERS_FUSED * K * E_FUSED / fused_s:.1f} aggregate "
          f"walker-steps/s on {card}; cold-chain acceptance "
          f"{np.round(acc_cold, 3).tolist()}; launches std f32 {n32}, "
          f"f64 {n64}")
    for j, e in enumerate(enss):
        if (e.latest_iter != N_ITERS_FUSED
                or not np.isfinite(e.H.loglikelihood[0]).all()
                or not 0.05 <= acc_cold[j] <= 0.8):
            raise RuntimeError(f"phase 8: replica {j}: latest_iter "
                               f"{e.latest_iter}, cold-chain acceptance "
                               f"{acc_cold[j]} or a non-finite logll")
    if any(np.array_equal(enss[0].H.states, e.H.states) for e in enss[1:]):
        raise RuntimeError("phase 8: two replicas walked the same chain")
    if n32 != N_ITERS_FUSED or n64 < 1:
        raise RuntimeError(f"phase 8: std f32 launched {n32} times for "
                           f"{N_ITERS_FUSED} evaluations (one per "
                           f"iteration and the initial one), f64 {n64}")

    # steady state: fused windows at E = 1, 2, 4, 8 from the walk's last
    # states, 5 warm-up and 30 timed iterations each
    ef = enss[0].ensemble_fields
    temps_np = np.asarray(ef["_T"], dtype=float)
    rates = {}
    for E in (1, 2, 4, 8):
        kern = vmap_ensembles(build_mh_kernel(
            plan, move, temps_np, ef["base_trial_move"], ef["temper_freq"],
            True, dtype=f32, device=dev))
        P = len(plan.param_names)
        sources = [TorchDraws(1000 + e, K, P, n_tries(move),
                              move.mu_constraint is not None, f32, dev)
                   for e in range(E)]
        st = torch.as_tensor(np.stack([e.H.states[:, :, -1]
                                       for e in enss[:E]]),
                             dtype=f32, device=dev)
        out = kern.run_window(st, kern.init_ll(st), 1, 5, sources)
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        out = kern.run_window(out[0], out[1], 6, 30, sources)
        _ = [h.cpu() for h in out[5]]
        dt = time.perf_counter() - t0
        rates[E] = dict(
            walker_steps_per_s=30 * K * E / dt, ms_per_iteration=dt / 30e-3,
            f32_per_iteration=sk.LAUNCHES[("std", f32)] / 30,
            f64_per_iteration=sk.LAUNCHES[("std", f64)] / 30)
    print("phase 8 steady state (30 iterations after 5): " + "; ".join(
        f"E={E}: {r['walker_steps_per_s']:.1f} aggregate walker-steps/s, "
        f"{r['ms_per_iteration']:.3f} ms/iteration, launches per iteration "
        f"std f32 {r['f32_per_iteration']:.2f} f64 "
        f"{r['f64_per_iteration']:.2f}" for E, r in rates.items())
        + f" on {card}")

    # ---- phase 9: fused equals separate on the card ----
    cfg_pair = flagship_config("pair.txt", N_ITERS_PAIR, N_ITERS_PAIR,
                               "run_pair")
    sim9, pi9, _f, mc9, ini9, ed9 = _load_common(str(cfg_pair))

    def walk_pair(out, **kw):
        return metro(sim9, ini9, ed9, dict(mc9, output_path=str(work / out)),
                     pi9, device="cuda", trap_signals=False, **kw)

    pair = walk_pair("pair_fused", seed=77, n_ensembles=2)
    for e in range(2):
        solo = walk_pair(f"pair_solo{e}", seed=77 + e, export_path="s.pik")
        for a in ("states", "loglikelihood", "accept", "swap_attempts",
                  "swap_accept"):
            x, y = getattr(pair[e].H, a), getattr(solo.H, a)
            if not np.array_equal(x, y):
                raise RuntimeError(
                    f"phase 9: replica {e} {a} differs from its separate "
                    f"walk: max |diff| "
                    f"{np.max(np.abs(x.astype(float) - y)):.3e}")
    print(f"phase 9: metro(n_ensembles=2) x {N_ITERS_PAIR} iterations "
          "equals each replica walked alone at its seed, History and swap "
          f"counters bit for bit, on {card}")

    # ---- phase 10: the dense sampler, `cli dense` ----
    cfg_dense = flagship_config("dense.txt", N_DENSE, N_DENSE, "run_dense")
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    cli(["dense", str(cfg_dense), "--device", "cuda"])
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    launches_dense = dict(sk.LAUNCHES)
    Pd = np.load(work / "run_dense" / "CPU0_P.npy")
    n_fin, n_inf = int(np.isfinite(Pd).sum()), int((Pd == -np.inf).sum())
    n_chunks = -(-N_DENSE // 512)
    # the steady rate: one more chunk of 512 samples, warm
    Xd = np.load(work / "run_dense" / "CPU0_X.npy")[:512]
    ev = make_eval_logll(plan, dtype=f32, device=dev)
    one = torch.ones(1, dtype=f32, device=dev)
    xs = torch.as_tensor(Xd, dtype=f32, device=dev)
    rung_rows = int(ev(xs, one)["repair_states"].sum())
    chunk_ms = cuda_ms(lambda: ev(xs, one), 3)
    print(f"phase 10: dense, {N_DENSE} samples x 6 curves in "
          f"{dense_s:.2f} s (plan build included): "
          f"{N_DENSE * 6 / dense_s:.1f} solves/s; one warm chunk of 512 "
          f"samples (the walk's plan) {chunk_ms:.3f} ms = "
          f"{512 * 6 / chunk_ms * 1e3:.1f} solves/s, {rung_rows} of its "
          f"3072 rows through the rung, on {card}; finite P {n_fin}, "
          f"conceded -inf {n_inf}; "
          f"launches std f32 {launches_dense[('std', f32)]}, f64 (the "
          f"rung) {launches_dense[('std', f64)]}")
    if n_fin + n_inf != N_DENSE or n_fin == 0:
        raise RuntimeError("phase 10: a dense P is NaN or +inf, or none is "
                           "finite")
    if launches_dense[("std", f32)] != n_chunks:
        raise RuntimeError(f"phase 10: std f32 launched "
                           f"{launches_dense[('std', f32)]} times for "
                           f"{n_chunks} chunks")

    # ---- phase 11: the MLE, `cli mle` ----
    cfg_mle = flagship_config("mle.txt", N_ITERS, N_ITERS, "run_mle")
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    cli(["mle", str(cfg_mle), "--maxiter", str(MLE_MAXITER), "--device",
         "cuda"])
    torch.cuda.synchronize()
    mle_s = time.perf_counter() - t0
    launches_mle = dict(sk.LAUNCHES)
    ens_mle = load_checkpoint(str(work / "run_mle" / "MLE0-final.pik"))
    trace = ens_mle.H.loglikelihood[0, 1:ens_mle.latest_iter]
    print(f"phase 11: mle, {MLE_MAXITER} Nelder-Mead iterations, "
          f"{len(trace)} evaluations in {mle_s:.2f} s on {card}: logll "
          f"first {trace[0]:.4f}, best {trace.max():.4f}; launches std f64 "
          f"{launches_mle[('std', f64)]}, f32 {launches_mle[('std', f32)]}")
    if not (np.isfinite(trace.max()) and trace.max() >= trace[0]):
        raise RuntimeError("phase 11: the MLE's best logll is not finite "
                           "or worse than its first")
    if launches_mle[("std", f64)] < len(trace) \
            or launches_mle[("std", f32)]:
        raise RuntimeError("phase 11: the MLE did not run every evaluation "
                           "through the std double kernel")

    # ---- phase 12: kernel time against batch size ----
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    by_batch = {}

    def batch_times(pl, pinfo, truth):
        names = list(pl.param_names)
        rng = np.random.default_rng(1)
        base = np.array([truth[n] for n in names], dtype=float)
        active = np.array([bool(pinfo["active"][n]) for n in names])
        states = base[None] * 10.0 ** (
            rng.uniform(-0.1, 0.1, (64, len(names))) * active[None])
        _, fp, fp_hi = pl.fwd[0]
        for dl, fp_x, dtype, Bs in (("f32", fp, f32, (48, 96, 192, 384)),
                                    ("f64", fp_hi, f64, (9, 72, 144))):
            label = f"{fp_x.model}_{dl}"
            (p, y0, dts, dx), kw = kernel_inputs(
                dev, pl, states[:max(Bs) // 6 + 1], fp_x, dtype)
            occ = sk.occupancy(fp_x.model, dtype, 128)
            resident = occ["blocks_per_sm"] * n_sm
            times = {}
            for B in Bs:
                sub = (type(p)(*(a[:B] for a in p)), y0[:B], dts[:, :B],
                       dx[:B])
                times[B] = cuda_ms(
                    lambda: sk.integrate_observables_cuda(*sub, **kw), 10)
            by_batch[label] = dict(ms=times, **occ, resident_rows=resident)
            print(f"phase 12 {label}: kernel ms at B = " + ", ".join(
                f"{B}: {t:.3f} ({-(-B // resident)} wave"
                f"{'s' if B > resident else ''})" for B, t in times.items())
                + f"; {occ['blocks_per_sm']} blocks/SM x {n_sm} SMs = "
                f"{resident} resident rows ({occ['threads']} threads, "
                f"{occ['smem_bytes']} B shared per block), n_steps "
                f"{fp_x.n_steps}, on {card}")

    batch_times(plan, param_info, STAUB_TRUE)
    batch_times(plan_t, param_info_t, truth_t)
    # the float instantiations at the committed posteriors' fast-leg
    # shapes (nx=32: 192 std rows, 64 traps rows)
    for model in ("std", "traps"):
        args, kw = posterior_fast_batch(model, dev)
        B, _, nx32 = args[1].shape
        occ = sk.occupancy(model, f32, nx32)
        ms = cuda_ms(lambda: sk.integrate_observables_cuda(*args, **kw), 10)
        by_batch[f"{model}_f32"].update(
            ms_nx32={B: ms}, blocks_per_sm_nx32=occ["blocks_per_sm"])
        print(f"phase 12 {model}_f32 nx=32: kernel ms at B = {B}: {ms:.3f}; "
              f"{occ['blocks_per_sm']} blocks/SM x {n_sm} SMs "
              f"({occ['threads']} threads, {occ['smem_bytes']} B shared per "
              f"block), n_steps {args[2].shape[0]}, on {card}")

    # ---- phases 13-16: the pinned fixtures, the real data, NN and pa ----
    launches_pin = phase13_pinned(card, dev)
    launches_real, plan_irf, pi_irf = phase14_real(card, dev, work, cli)
    launches_nn = phase15_nn(card, dev, work)
    launches_pa = phase16_pa(card, work, cli)
    dense_chunk_on_irf_plan(card, dev, plan_irf, pi_irf)

    # ---- phases 17-19: the native runtime, quicksim, posterior legs ----
    phase17_runtime(card)
    launches_qs = phase18_quicksim(card, work)
    launches_post, checks_post = phase19_posterior(card, dev)

    # ---- phase 20: the sharded walk on one card ----
    launches_mesh = phase20_mesh(card, work, fluences)

    # ---- phase 21: the flagship posterior's leg and ridge states ----
    launches_flag, checks_flag = phase21_flagship(card, dev)

    # one entry per instantiation; launches are each model's main-path
    # counts; max_abs_err is in decades of the observables
    launch_of = {"std": launches_std, "traps": launches_traps}
    kernels = [{
        "name": f"sdirk_solve_{model}_{dl}", "route": "cuda",
        "source": "metrotrpl_tpu_torch/solver/csrc/sdirk_solve.cu",
        "replaces": "metrotrpl_tpu/solver/pallas_step.py:47",
        "launches": launch_of[model][(model, dtype)],
        "launches_fused_e8": launches_e8[(model, dtype)],
        "launches_dense": launches_dense[(model, dtype)],
        "launches_mle": launches_mle[(model, dtype)],
        "launches_pinned": launches_pin[(model, dtype)],
        **{f"launches_{lb}": ln[(model, dtype)]
           for lb, ln in launches_real.items()},
        "launches_nn": launches_nn[(model, dtype)],
        "launches_pa": launches_pa[(model, dtype)],
        "launches_quicksim": launches_qs[(model, dtype)],
        **{f"launches_posterior_{m}": ln[(model, dtype)]
           for m, ln in launches_post.items()},
        **{f"launches_mesh_{lb}": ln[(model, dtype)]
           for lb, ln in launches_mesh.items()},
        "launches_flagship": launches_flag[(model, dtype)],
        "ms_by_batch": by_batch[f"{model}_{dl}"]["ms"],
        "blocks_per_sm": by_batch[f"{model}_{dl}"]["blocks_per_sm"],
        **{k: v for k, v in by_batch[f"{model}_{dl}"].items()
           if k.endswith("_nx32")},
        **results[f"{model}_{dl}"],
        "posterior_shapes": (checks_post[model] if dtype == f32 else []),
        "flagship_shape": checks_flag.get(f"{model}_{dl}"),
    } for model in ("std", "traps") for dl, dtype in (("f32", f32),
                                                       ("f64", f64))]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
