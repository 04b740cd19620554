#!/usr/bin/env python3
"""CUDA-event times of the solve kernel's instantiations, for one or
several checkouts of this repository, on the same inputs.

    python3 metrotrpl_tpu_torch/solver/kernel_times.py [--turns DIR ...]

Without ``--turns`` it times the checkout it lies in. With ``--turns A B``
it times A, B, B, A (each in its own process, each building its own
kernel library from its own sources; more directories go the same way
out and back), so that versions of the kernel are compared on one card
in turns. Every checkout must have the wrapper
``metrotrpl_tpu_torch.solver.solve_kernel.integrate_observables_cuda``
with its present arguments.

The inputs are made once, from this checkout, in a temporary directory
inside it (``make_inputs``): the flagship std config and the traps config
as ``cli.write_example_config(fast=True)`` writes them, 64 states (+-0.1
dex around the truth on the active parameters) x 6 measurements = 384
rows at nx=128, on the float32 fast plan and the float64 rung plan; and
the committed posteriors' fast-leg batches at nx=32 (32 states: 192 std
rows, 64 traps rows; ``f32_nx32``). Per checkout and instantiation it
reports:

- ``ms_B<B>``: the kernel on its plan at B rows: the float ones at B =
  48, 96, 192, 384 (one flagship iteration up to the fused E=8 walk),
  the double ones at 48, 9 (the rung's rows per iteration in a profiled
  flagship walk) and 1, the nx=32 batches whole;
- ``sha_B<B>``: a digest of those outputs, so that the summary can say
  whether two checkouts' kernels agree bit for bit (``out_sha256``:
  the first size's);
- ``blocks_per_sm``, ``threads``, ``smem_bytes``: the launch's
  occupancy (``solve_kernel.occupancy``);
- the split of its time: the first size's rows at a constant step (the
  plan's median dt) with the plan's Newton iterations and no chord
  (``as_is``), with ``newton_iters=1`` (``ni1``), and as a chord plan
  that refactors every 5 steps (``chord5``); the three times solved for
  ms per factorization, ms per Newton iteration and the rest (the
  observables and the launch).

Output, on stdout: one JSON line per checkout run, then a summary.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]
N_REP = 20


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit):
#: non-tensor-core FLOP/s per scalar size in bytes (float32, float64),
#: and the HBM rate in bytes/s
PEAK_FLOPS = {4: 67e12, 8: 34e12}
PEAK_BYTES = 3.35e12


def cuda_ms(fn, n):
    """Mean milliseconds of fn() over n runs, by CUDA events, after one
    warm-up run."""
    import torch

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
    import torch

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
    t_ops, t_mem = flops / PEAK_FLOPS[size], nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem
            else "bytes", flops, nbytes)


def kernel_inputs(dev, pl, states, fp_x, dtype):
    """Kernel arguments and keywords of K states x the measurements of
    pl's first solve group on plan fp_x."""
    import numpy as np
    import torch

    from metrotrpl_tpu_torch.inference.likelihood import expand_states
    from metrotrpl_tpu_torch.solver.forward import prepare_batch

    def t(a, d=dtype):
        return torch.as_tensor(np.asarray(a), dtype=d, device=dev)

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


def kernel_vs_plain(card, dev, pl, fp_x, dtype, states, label):
    """One instantiation of the solve kernel against its plain version on
    K states x the measurements of pl's first solve group, on plan fp_x.
    The rows over the Newton thresholds (the ladder's nx-aware divergence
    threshold and the 0.97*cap pin) must be the same rows, at least half
    the rows must be under them, and on those the observables must agree
    (float32: |d log10| <= 1e-4, the chord solve amplifying rounding;
    float64: rel <= 1e-9). Returns the comparison's numbers, the kernel's
    CUDA-event ms (20 runs after a warm-up), the plain version's (the
    compared call), the bound and a printable line."""
    import numpy as np
    import torch

    from metrotrpl_tpu_torch.inference.likelihood import (
        newton_div_tol_default,
    )
    from metrotrpl_tpu_torch.solver import solve_kernel as sk
    from metrotrpl_tpu_torch.solver.sdirk import NEWTON_DAMP

    args, kw = kernel_inputs(dev, pl, states, fp_x, dtype)
    resid_tol, pin = newton_div_tol_default(fp_x.nx), 0.97 * NEWTON_DAMP
    out_k = sk.integrate_observables_cuda(*args, **kw)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out_p = sk.integrate_observables_plain(*args, **kw)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    pl_k, tr_k, rs_k = (a.double().cpu().numpy() for a in out_k)
    pl_p, tr_p, rs_p = (a.double().cpu().numpy() for a in out_p)
    B = pl_k.shape[1]
    r_k, r_p = rs_k.max(axis=0), rs_p.max(axis=0)
    for thr in (resid_tol, pin):
        fk, fp_ = ~(r_k < thr), ~(r_p < thr)
        if not np.array_equal(fk, fp_):
            raise RuntimeError(
                f"{label}: rows over resid {thr} differ: kernel "
                f"{np.nonzero(fk)[0]} vs plain {np.nonzero(fp_)[0]}")
    ok = r_k < resid_tol
    if 2 * ok.sum() < B:
        raise RuntimeError(f"{label}: only {ok.sum()} of {B} rows "
                           "unflagged; the comparison would be vacuous")
    pairs = ((pl_k[:, ok], pl_p[:, ok]), (tr_k[:, ok], tr_p[:, ok]))
    dlog = max(np.abs(np.log10(a) - np.log10(b)).max() for a, b in pairs)
    rel = max((np.abs(a - b) / np.abs(b)).max() for a, b in pairs)
    f32 = dtype == torch.float32
    err, limit = (dlog, 1e-4) if f32 else (rel, 1e-9)
    if not (np.isfinite(pl_k[:, ok]).all() and err <= limit):
        raise RuntimeError(f"{label}: kernel vs plain error {err} > {limit}")
    ms = cuda_ms(lambda: sk.integrate_observables_cuda(*args, **kw), 20)
    bound_ms, bound_by, flops, nbytes = solve_bound(dtype, B, fp_x.nx, fp_x)
    shape = f"B={B} nx={fp_x.nx} n_steps={fp_x.n_steps}"
    return dict(
        max_abs_err=float(dlog), max_rel_err=float(rel), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        flagged=int((~ok).sum()), shape=shape,
        tolerance=(f"{'|d log10 obs|' if f32 else 'rel'} <= {limit:g} on "
                   f"rows under resid {resid_tol}; the same rows over it"),
        line=(f"{shape} flagged rows {int((~ok).sum())}; max |dlog10| "
              f"{dlog:.3e}, max rel err {rel:.3e} (limit {limit:g}); "
              f"kernel {ms:.3f} ms, plain PyTorch {plain_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {flops:.4g} FLOP, {nbytes} "
              f"B) on {card}"))


#: batch sizes timed per instantiation at nx=128: the float ones at the
#: walk's rows (48: one flagship iteration; 384: the fused E=8 walk),
#: the double ones at the rung's (48, and the ~9 rows it repairs)
SIZES = {"f32": (48, 96, 192, 384), "f64": (48, 9, 1)}


def _states(truth, names, active, n, seed=0):
    """n states +-0.1 dex around truth on the active parameters."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = np.array([truth[k] for k in names], dtype=float)
    act = np.array([bool(active[k]) for k in names])
    return base[None] * 10.0 ** (rng.uniform(-0.1, 0.1, (n, len(names)))
                                 * act[None])


def posterior_fast_batch(model, dev, n_states=32):
    """The kernel's arguments and keywords (as kernel_inputs gives them)
    on the committed posteriors' fast leg (scripts/posterior_torch.py,
    nx=32, hmax 48, chord blocks of 4, float32): n_states states +-0.1
    dex around the workload's start x its curves (192 std rows, 64 traps
    rows at 32 states). The data only enters the likelihood, so the plan
    is built on zeros in its place."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO / "scripts"))
    import posterior_torch

    w = posterior_torch.WORKLOADS[model]()
    t = np.linspace(0, w.t_end, w.nt)
    leg = posterior_torch.LEGS["fast"]
    pl = posterior_torch.build_plans(w, t, [np.zeros(w.nt)] * len(w.lengths),
                                     leg["hmax"], leg["refactor"],
                                     leg["refine"])[0]
    states = _states(w.start, list(pl.param_names),
                     {k: k in w.active for k in pl.param_names}, n_states)
    return kernel_inputs(dev, pl, states, pl.fwd[0][1], torch.float32)


def _stored(args, kw):
    """kernel_inputs' result as make_inputs stores it: (params list, y0,
    dts, dx, kwargs)."""
    p, y0, dts, dx = args
    return [a.contiguous() for a in p], y0, dts, dx, kw


def make_inputs(work):
    """The kernel inputs of both models on both plans, as CPU tensors:
    {(model, dtag): (params list, y0, dts, dx, kwargs)}. At nx=128 64
    states x 6 measurements (384 rows: the float instantiations are timed
    up to B=384, the double ones on the first 48) of the flagship std and
    the traps config as ``cli.write_example_config(fast=True)`` writes
    them, on the float32 fast plan and the float64 rung plan; at nx=32
    (``dtag`` "f32_nx32") the posterior fast legs' batches."""
    import torch

    from metrotrpl_tpu_torch.cli import _load_common, write_example_config
    from metrotrpl_tpu_torch.inference.metropolis import plans_from_config
    from metrotrpl_tpu_torch.workloads import STAUB_TRUE, TRAPS_TRUE

    work.mkdir(parents=True, exist_ok=True)
    fluences = REPO / "Inputs" / "staub_MAPI_threepower_twothick_fluences.csv"
    inputs = {}
    for model, truth in (("std", STAUB_TRUE),
                         ("traps", {**STAUB_TRUE, **TRAPS_TRUE})):
        cfg = work / f"{model}.txt"
        write_example_config(str(cfg), model=model, fast=True, num_iters=10,
                             init_cond=str(fluences),
                             measurement=str(work / f"{model}_data.csv"),
                             output=str(work / f"run_{model}"))
        sim_info, param_info, _f, mcmc, iniPar, e_data = _load_common(
            str(cfg))
        pl, _ = plans_from_config(sim_info, param_info, dict(mcmc), e_data,
                                  iniPar)
        states = _states(truth, list(pl.param_names), param_info["active"],
                         64)
        _, fp, fp_hi = pl.fwd[0]
        cpu = torch.device("cpu")
        for dtag, fp_x, dtype in (("f32", fp, torch.float32),
                                  ("f64", fp_hi, torch.float64)):
            inputs[(model, dtag)] = _stored(
                *kernel_inputs(cpu, pl, states, fp_x, dtype))
        inputs[(model, "f32_nx32")] = _stored(
            *posterior_fast_batch(model, cpu))
    return inputs


def _counts(n_steps, kw):
    """(factorizations, Newton iterations) of one row under kw (sdirk3:
    three implicit stages; a ramp, if any, factors every step)."""
    n_newton = 3 * kw["newton_iters"] * n_steps
    ramp = kw.get("n_ramp")
    if ramp is None:
        return n_steps, n_newton
    return ramp + -(-(n_steps - ramp) // kw["refactor_every"]), n_newton


def time_here(inputs_path):
    """Time this process's checkout (on sys.path) on the saved inputs."""
    import numpy as np
    import torch

    from metrotrpl_tpu_torch.physics.models import ScaledParams
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    dev = torch.device("cuda")
    lib = sk.kernel_library()
    inputs = torch.load(inputs_path, weights_only=False)

    def cuda_ms(fn, n=N_REP):
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

    def on_dev(p, y0, dts, dx, rows):
        return (ScaledParams(*(a[rows].to(dev) for a in p)),
                y0[rows].to(dev), dts[:, rows].to(dev), dx[rows].to(dev))

    def digest(outs):
        h = hashlib.sha256()
        for a in outs:
            h.update(a.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {"repo": os.getcwd(), "library": lib.path.name,
           "nvcc_s": lib.build_seconds}
    for (model, dtag), (p, y0, dts, dx, kw) in inputs.items():
        rec = dict(sk.occupancy(model, y0.dtype, y0.shape[-1]))
        sizes = SIZES.get(dtag, (y0.shape[0],))
        for B in sizes:
            args = on_dev(p, y0, dts, dx, slice(0, B))
            rec[f"ms_B{B}"] = cuda_ms(
                lambda: sk.integrate_observables_cuda(*args, **kw))
            # a digest of the outputs, to compare checkouts
            rec[f"sha_B{B}"] = digest(
                sk.integrate_observables_cuda(*args, **kw))
        Bs = sizes[0]
        rec["ms"], rec["out_sha256"] = rec[f"ms_B{Bs}"], rec[f"sha_B{Bs}"]
        n_steps = dts.shape[0]
        const = torch.full_like(dts, float(np.median(dts.numpy())))
        args = on_dev(p, y0, const, dx, slice(0, Bs))
        runs = {"as_is": dict(kw, n_ramp=None, refactor_every=1,
                              ramp_block=1, newton_plateau=None),
                "ni1": dict(kw, n_ramp=None, refactor_every=1,
                            ramp_block=1, newton_plateau=None,
                            newton_iters=1),
                "chord5": dict(kw, n_ramp=n_steps % 5, refactor_every=5,
                               ramp_block=1, newton_plateau=None)}
        rows, rhs = [], []
        for name, k in runs.items():
            ms = cuda_ms(lambda: sk.integrate_observables_cuda(*args,
                                                               **k))
            nf, nn = _counts(n_steps, k)
            rec[f"split_{name}_ms"] = ms
            rows.append([nf, nn, 1.0])
            rhs.append(ms)
        f, n, rest = np.linalg.solve(np.array(rows), np.array(rhs))
        rec.update(ms_per_factorization=float(f),
                   ms_per_newton_iteration=float(n),
                   ms_rest=float(rest), split_dt=float(const[0, 0]),
                   split_B=Bs, split_counts=rows, nx=int(y0.shape[-1]),
                   n_steps=n_steps)
        out[f"{model}_{dtag}"] = rec
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", nargs="+", metavar="DIR",
                    help="checkouts to time as A B ... then in reverse")
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA device")
    if a.inputs:                   # one checkout, in this process
        print(json.dumps(time_here(a.inputs)))
        return
    sys.path.insert(0, str(REPO))
    card = nvidia_smi_line()
    dirs = [Path(d).resolve() for d in (a.turns or [REPO])]
    order = dirs + dirs[::-1] if a.turns else dirs
    results = []
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        work = Path(tmp)
        inputs_path = work / "inputs.pt"
        torch.save(make_inputs(work), inputs_path)
        for d in order:
            env = dict(os.environ, PYTHONPATH=str(d))
            proc = subprocess.run(
                [sys.executable, str(HERE), "--inputs", str(inputs_path)],
                cwd=str(d), env=env, capture_output=True, text=True,
                timeout=1200)
            if proc.returncode != 0:
                sys.exit(f"kernel_times: {d} failed:\n{proc.stdout}\n"
                         f"{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res["card"] = card
            print(json.dumps(res), flush=True)
            results.append(res)
    print(f"card: {card}")
    for res in results:
        print(res["repo"], "; ".join(
            f"{k} " + " ".join(f"{m[3:]}={v[m]:.3f}" for m in v
                               if m.startswith("ms_B"))
            for k, v in res.items() if isinstance(v, dict)))
    for k, v in results[0].items():
        if isinstance(v, dict):
            shas = sorted(m for m in v if m.startswith("sha_B"))
            same = all(r[k][m] == v[m] for r in results for m in shas)
            print(f"{k}: outputs bit for bit the same in every checkout "
                  f"at {', '.join(m[4:] for m in shas)}: {same}")


if __name__ == "__main__":
    main()
