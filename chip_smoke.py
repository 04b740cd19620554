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
   CUDA-event times of both, and of the float64 kernel at B=9 (the
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
    occupancy API gives for the launch's variant.

Launch counts are zeroed just before each main path (phases 4, 7, 8, 10
and 11) and read just after it. The last three lines of standard output are the
kernels JSON object (one entry per instantiation, with its launches on
its main path, its error against the plain version, CUDA-event times of
kernel and plain version, and its bound: the larger of the FLOPs it needs
(solve_kernel.solve_flops) over the card's non-tensor-core peak and its
bytes over the memory rate), the nvidia-smi line and {"ok": true,
"device": {...}}. Without CUDA, or outside the repository, it exits
non-zero and prints no result.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
N_ITERS = 200          # std walk
N_ITERS_TRAPS = 100    # traps walk
E_FUSED = 8            # fused ensembles of the fused std walk
N_ITERS_FUSED = 100    # its iterations
N_ITERS_PAIR = 20      # fused against separate walks
N_DENSE = 2048         # dense samples
MLE_MAXITER = 40       # Nelder-Mead iterations

#: published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit):
#: non-tensor-core FLOP/s per scalar type, and the HBM rate in bytes/s
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12

def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n):
    """Mean milliseconds of fn() over n runs, by CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def solve_bound(dtype, B, nx, fp_x):
    """(bound_ms, bound_by, flops, bytes) of one kernel call on plan fp_x:
    the larger of the FLOPs it needs (solve_kernel.solve_flops, on this
    plan's steps, Newton iterations and factorizations) over the peak for
    its type, and of its bytes (inputs read once, outputs written once)
    over the memory rate."""
    from metrotrpl_tpu_torch.physics.models import N_COMP
    from metrotrpl_tpu_torch.solver.solve_kernel import solve_flops

    flops = B * solve_flops(
        fp_x.model, nx, fp_x.n_steps, scheme_name=fp_x.scheme,
        newton_iters=fp_x.newton_iters, refactor_every=fp_x.refactor_every,
        n_ramp=fp_x.n_ramp, ramp_block=fp_x.ramp_block,
        newton_plateau=fp_x.newton_plateau)
    n, nc = fp_x.n_steps, N_COMP[fp_x.model]
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (B * n + B * nc * nx + B * 17 + B + 3 * B * (n + 1))
    t_ops, t_mem = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem
            else "bytes", flops, nbytes)


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
        expand_states,
        make_eval_logll,
        newton_div_tol_default,
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
    from metrotrpl_tpu_torch.solver.forward import prepare_batch
    from metrotrpl_tpu_torch.solver.sdirk import NEWTON_DAMP
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
    # the ladder's thresholds at nx=128: Newton divergence, and the
    # cap-pinned rows that repair ungated
    resid_tol = newton_div_tol_default(128)
    pin = 0.97 * NEWTON_DAMP
    temps = torch.as_tensor(np.asarray(mcmc["parallel_tempering"]),
                            dtype=f32, device=dev)

    def batch(pl, states, fp_x, dtype):
        """Kernel inputs of K states x 6 measurements on plan fp_x."""
        t = lambda a, d=dtype: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=d, device=dev)
        K = states.shape[0]
        gi = torch.as_tensor(pl.fwd[0][0], device=dev)
        init, raw = expand_states(pl, gi, t(fp_x.x_centers), t(states),
                                  t(pl.init_profiles), t(pl.units))
        p, y0, dts, _ = prepare_batch(init, raw, t(fp_x.dx).repeat(K),
                                      t(fp_x.dt).repeat(K, 1), fp_x.model)
        kw = dict(model=fp_x.model, scheme_name=fp_x.scheme,
                  newton_iters=fp_x.newton_iters,
                  refactor_every=fp_x.refactor_every, n_ramp=fp_x.n_ramp,
                  ramp_block=fp_x.ramp_block,
                  newton_plateau=fp_x.newton_plateau)
        return (p, y0, dts, t(fp_x.dx).repeat(K)), kw

    results = {}

    def kernel_vs_plain(phase, pl, pinfo, truth):
        """Both instantiations of pl's model against the plain version on
        8 states (+-0.1 dex on the active parameters) x 6 measurements."""
        names = list(pl.param_names)
        rng = np.random.default_rng(0)
        base = np.array([truth[n] for n in names], dtype=float)
        active = np.array([bool(pinfo["active"][n]) for n in names])
        states = base[None] * 10.0 ** (
            rng.uniform(-0.1, 0.1, (8, len(names))) * active[None])
        _, fp, fp_hi = pl.fwd[0]
        for dlabel, fp_x, dtype in (("f32", fp, f32), ("f64", fp_hi, f64)):
            label = f"{fp_x.model}_{dlabel}"
            args, kw = batch(pl, states, fp_x, dtype)
            run_k = lambda: sk.integrate_observables_cuda(*args, **kw)  # noqa
            run_p = lambda: sk.integrate_observables_plain(*args, **kw)  # noqa
            out_k = run_k()
            out_p = run_p()
            torch.cuda.synchronize()
            pl_k, tr_k, rs_k = (a.double().cpu().numpy() for a in out_k)
            pl_p, tr_p, rs_p = (a.double().cpu().numpy() for a in out_p)
            r_k, r_p = rs_k.max(axis=0), rs_p.max(axis=0)
            for thr in (resid_tol, pin):
                fk, fp_ = ~(r_k < thr), ~(r_p < thr)
                if not np.array_equal(fk, fp_):
                    raise RuntimeError(
                        f"{label}: rows over resid {thr} differ: kernel "
                        f"{np.nonzero(fk)[0]} vs plain {np.nonzero(fp_)[0]}")
            ok = r_k < resid_tol
            if ok.sum() < 24:
                raise RuntimeError(f"{label}: only {ok.sum()} of 48 rows "
                                   "unflagged; the comparison would be "
                                   "vacuous")
            pairs = ((pl_k[:, ok], pl_p[:, ok]), (tr_k[:, ok], tr_p[:, ok]))
            dlog = max(np.abs(np.log10(a) - np.log10(b)).max()
                       for a, b in pairs)
            rel = max((np.abs(a - b) / np.abs(b)).max() for a, b in pairs)
            # float32: decades of the observables (the chord solve at
            # nx=128 amplifies rounding); float64: relative error
            err, limit = (dlog, 1e-4) if dlabel == "f32" else (rel, 1e-9)
            if not (np.isfinite(pl_k[:, ok]).all() and err <= limit):
                raise RuntimeError(f"{label}: kernel vs plain error {err} > "
                                   f"{limit}")
            ms = cuda_ms(run_k, 20)
            plain_ms = cuda_ms(run_p, 1)
            ms_b9 = None
            if dlabel == "f64":
                # the rung's rows per iteration in a profiled flagship walk
                p9, y9, dt9, dx9 = args
                args9 = (type(p9)(*(a[:9] for a in p9)), y9[:9], dt9[:, :9],
                         dx9[:9])
                ms_b9 = cuda_ms(
                    lambda: sk.integrate_observables_cuda(*args9, **kw), 20)
                print(f"phase {phase} {label}: B=9 nx=128 n_steps="
                      f"{fp_x.n_steps}: kernel {ms_b9:.3f} ms on {card}")
            bound_ms, bound_by, flops, nbytes = solve_bound(
                dtype, 48, 128, fp_x)
            results[label] = dict(
                max_abs_err=float(dlog), max_rel_err=float(rel), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, ms_b9=ms_b9,
                tolerance=(f"{'|d log10 obs|' if dlabel == 'f32' else 'rel'}"
                           f" <= {limit:g} on rows under resid {resid_tol}; "
                           "the same rows over it"),
                shape=f"B=48 nx=128 n_steps={fp_x.n_steps}")
            print(f"phase {phase} {label}: B=48 nx=128 n_steps="
                  f"{fp_x.n_steps} flagged rows {int((~ok).sum())}; max "
                  f"|dlog10| {dlog:.3e}, max rel err {rel:.3e} (limit "
                  f"{limit:g}); kernel {ms:.3f} ms, plain PyTorch "
                  f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {flops:.4g} FLOP, {nbytes} B) on {card}")

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
    kernel_vs_plain(2, plan, param_info, STAUB_TRUE)

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
    kernel_vs_plain(5, plan_t, param_info_t, truth_t)

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
            (p, y0, dts, dx), kw = batch(pl, states[:max(Bs) // 6 + 1],
                                         fp_x, dtype)
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
        "ms_by_batch": by_batch[f"{model}_{dl}"]["ms"],
        "blocks_per_sm": by_batch[f"{model}_{dl}"]["blocks_per_sm"],
        **results[f"{model}_{dl}"],
    } for model in ("std", "traps") for dl, dtype in (("f32", f32),
                                                       ("f64", f64))]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
