"""The mesh cells: the sharded tempered walk of ``metro(mesh_shape=(d_e,
d_c))`` (``cli mcmc --mesh ExC``), a process per rank and, on cards, a
card per rank over NCCL; window after window of the mix's iteration
count, each window's History gathered over the chains group and copied
to the host.

The configuration's ``deployment`` states the grid and the ensembles the
mix runs; a mix that differs from it is refused. This process builds the
plans from the configuration, as ``metro`` does,
writes them with the mix into a work directory under the cache, and
spawns the d_e * d_c ranks. Rank r = i_e * d_c + i_c is built from the
program's own sharded walk, as ``run_mh_sharded`` builds it:
``make_chain_mesh``, ``build_sharded_mh_kernel``, ``TorchDraws`` seeded
seed + e over the global ensemble index e, and each window's History
through ``_window_history`` over the mesh's History gather. It starts
every chain at the configuration's initial guess and walks one window
(set-up ends when every rank has walked it). The measured windows
follow on from there. No checkpoint is written.

Windows are timed on rank 0 between two world barriers. The stop is
rank 0's clock: after each window a one-int all-reduce over the world
carries its decision to every rank, so every rank walks the same
windows. Each rank then writes what it kept into the work directory
(the block's History from the block's leader, i_c == 0; its failures,
peak memory, loaded modules and counters; with ``--trace 1`` its traced
windows reduced), and this process checks the History of every ensemble
against the reference.

A rank that fails ends the run at once: the others are stopped and the
run raises. So does a run in which no rank has moved on for ``STALL_S``.
"""

import os
import pickle
import shutil
import sys
import uuid
from collections import defaultdict
from datetime import timedelta
from pathlib import Path
from time import perf_counter, time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

#: seconds without a rank moving on (or a collective waiting) before the
#: run is given up
STALL_S = 120
#: the program's spans around the chains group's collectives
GATHER = "metrotrpl.mesh.gather"
HISTORY = "metrotrpl.mesh.history"
FAIL_SUM = "metrotrpl.mesh.fail_sum"


class Job(NamedTuple):
    """What every rank reads from ``job.pik`` in the work directory."""
    shape: tuple             # (d_e, d_c)
    devices: list            # one device string per rank
    backend: str
    threads: int             # torch threads per rank
    like_plan: object
    move_plan: object
    temps: np.ndarray
    base_move: np.ndarray
    temper_freq: int
    x0: np.ndarray           # the configuration's initial guess (P,)
    n_ens: int               # E over the whole grid
    window_iters: int
    dtype: torch.dtype
    seed: int
    seconds: float
    trace_windows: int       # 0: untraced
    trace_dir: str
    t_start: float           # the harness's start (perf_counter)
    work: str
    prepare: Optional[Callable] = None   # called first in every rank


def _beat(work, rank):
    """Say that the rank has moved on."""
    Path(work, f"alive{rank}").touch()


class RankWalk:
    """One rank's block of the sharded walk, built as ``run_mh_sharded``
    builds it."""

    def __init__(self, job, mesh):
        from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
        from metrotrpl_tpu_torch.inference.moves import n_tries
        from metrotrpl_tpu_torch.parallel import sharded_mh

        d_e, d_c = mesh.shape
        self.mesh = mesh
        self.K = len(job.temps)
        self.E_l, self.K_l = job.n_ens // d_e, self.K // d_c
        self.W = int(job.window_iters)
        self.P = len(job.x0)
        self.dtype = job.dtype
        self.kernel = sharded_mh.build_sharded_mh_kernel(
            job.like_plan, job.move_plan, job.temps, job.base_move,
            job.temper_freq, self.K > 1, mesh, n_ens=job.n_ens,
            dtype=job.dtype)
        e0 = mesh.i_e * self.E_l
        #: global ensemble e draws from seed + e, as cli mcmc seeds it
        self.sources = [
            TorchDraws(job.seed + e0 + e, self.K, self.P,
                       n_tries(job.move_plan),
                       job.move_plan.mu_constraint is not None, job.dtype,
                       mesh.device) for e in range(self.E_l)]
        self.states = torch.as_tensor(
            np.broadcast_to(job.x0, (self.E_l, self.K_l, self.P)).copy(),
            dtype=job.dtype, device=mesh.device)
        self.ll = self.kernel.init_ll(self.states)
        # the program's History gather; a program without one gathers
        # with the plain all-gather
        hist = getattr(sharded_mh, "gather_history", sharded_mh.gather_chains)
        self.gather = lambda x: hist(mesh, x)
        self.k = 1
        self.leader = mesh.i_c == 0
        self.windows = []
        self.nfail = torch.zeros((self.E_l,), dtype=torch.int64,
                                 device=mesh.device)
        self.np_dtype = torch.empty((), dtype=job.dtype).numpy().dtype

    def window(self):
        """Walk one window; the leader keeps its History (first
        iteration, states (E_l, n, K, P), own-temperature ll (E_l, n, K),
        accepts (E_l, n, K)) as numpy in the walk dtype."""
        from metrotrpl_tpu_torch.inference.metropolis import _window_history

        k0 = self.k
        states, ll, att, acc, nfail, hist = self.kernel.run_window(
            self.states, self.ll, k0, self.W, self.sources)
        h_st, h_ll, h_acc, _, _, _ = _window_history(hist, att, acc, ll,
                                                     self.gather)
        self.states, self.ll = states, ll
        self.nfail = self.nfail + nfail
        self.k += self.W
        if self.leader:
            self.windows.append(
                (k0, h_st.transpose(0, 2, 1, 3).astype(self.np_dtype),
                 h_ll.transpose(0, 2, 1).astype(self.np_dtype),
                 h_acc.transpose(0, 2, 1)))

    def agree(self, flag):
        """A one-int all-reduce (max) over the world, waited for: with 0
        on every rank, a barrier."""
        import torch.distributed as dist

        t = torch.tensor([int(flag)], device=self.mesh.comm_device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def measure(self, seconds, max_windows=None, beat=None):
        """Windows between two world barriers until rank 0 has seen
        ``seconds`` pass (or ``max_windows``): (iterations, seconds on
        this rank's clock)."""
        self.agree(0)
        t0 = perf_counter()
        n = 0
        while True:
            self.window()
            n += 1
            if beat:
                beat()
            stop = (perf_counter() - t0 >= seconds
                    or bool(max_windows and n >= max_windows))
            if self.agree(stop and self.mesh.rank == 0):
                break
        self.agree(0)
        return n * self.W, perf_counter() - t0

    def history(self):
        """The leader's measured History: first iteration, start states
        (E_l, K, P) and own ll (E_l, K), states (E_l, n, K, P), ll
        (E_l, n, K) and accepts (E_l, n, K); the warm-up window's last
        row is the start."""
        warm, meas = self.windows[0], self.windows[1:]
        return (meas[0][0], warm[1][:, -1], warm[2][:, -1],
                np.concatenate([w[1] for w in meas], axis=1),
                np.concatenate([w[2] for w in meas], axis=1),
                np.concatenate([w[3] for w in meas], axis=1))


def _comm(mesh):
    """(collectives, bytes) the rank's program has counted, or None where
    the program keeps no count."""
    c = getattr(mesh, "comm", None)
    return None if c is None else (c.collectives, c.bytes)


def _span_kernel_seconds(path, names, match):
    """Device seconds of the kernels whose name satisfies ``match`` and
    whose launch lies inside a host range of each name in ``names`` on
    the launching thread: {name: seconds}. Unlike ``trace.py``'s
    attribution of every kernel of a range, it picks kernels by name and
    takes launches through the driver API too, which NCCL may use."""
    import bisect
    import json

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, ranges, kernels = {}, defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "kernel" and match(e["name"]):
            kernels.append((args.get("correlation"), dur))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat == "user_annotation" and e["name"] in names:
            ranges[e["name"]].append((e.get("tid"), ts, ts + dur))
    out = {}
    for name, rs in ranges.items():
        by_tid = defaultdict(list)
        for tid, a, b in sorted(rs, key=lambda r: r[1]):
            by_tid[tid].append((a, b))
        s = 0.0
        for corr, dur in kernels:
            hit = launches.get(corr)
            if hit is None or hit[0] not in by_tid:
                continue
            rr = by_tid[hit[0]]
            k = bisect.bisect_right([a for a, _ in rr], hit[1]) - 1
            if k >= 0 and hit[1] <= rr[k][1]:
                s += dur * 1e-6
        out[name] = s
    return out


def _is_nccl(name):
    return "nccl" in name.lower()


def _traced(job, w, rank):
    """The traced windows on this rank under torch.profiler, reduced: the
    trace's summary, the NCCL kernels' device seconds inside the mesh's
    spans, the program's traced spans counted by name, the solve kernel
    counters and the collectives over the windows, and the windows'
    iterations and swap rounds."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import outcome, spans, trace

    acts = [ProfilerActivity.CPU]
    if w.mesh.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    c0, comm0, k0 = outcome.counters(), _comm(w.mesh), w.k
    with profile(activities=acts) as prof:
        iters, dt = w.measure(float("inf"), max_windows=job.trace_windows)
    c1, comm1 = outcome.counters(), _comm(w.mesh)
    if w.mesh.device.type == "cuda":
        os.makedirs(job.trace_dir, exist_ok=True)
        path = os.path.join(job.trace_dir, f"rank{rank}.json")
        prof.export_chrome_trace(path)
        summary = trace.reduce_trace(path, dt)
        nccl_s = _span_kernel_seconds(path, (GATHER, HISTORY), _is_nccl)
    else:   # no device timeline to read
        summary = trace.TraceSummary([], 0.0, dt, {}, [])
        nccl_s = {}
    recs = spans.program_records() or []
    counts = defaultdict(int)
    for r in recs:
        if r[5]:
            counts[r[0]] += 1
    swaps = (0 if w.K < 2 else
             sum(1 for k in range(k0, w.k) if k % job.temper_freq == 0))
    return {"summary": summary, "nccl_s": nccl_s,
            "span_counts": dict(counts),
            "counters": {k: (c1[k][0] - c0[k][0], c1[k][1] - c0[k][1])
                         for k in c1},
            "comm": (None if comm0 is None else
                     (comm1[0] - comm0[0], comm1[1] - comm0[1])),
            "iterations": iters, "windows": iters // w.W,
            "swap_rounds": swaps, "window_s": dt}


def _walk_rank(job, rank, beat):
    """Build, warm up, measure (or trace) and gather this rank's block."""
    from metrotrpl_tpu_torch.parallel.mesh import make_chain_mesh

    from portbench.harness import outcome
    from portbench.run import forbidden_loaded

    mesh = make_chain_mesh(job.shape, job.devices, job.backend, STALL_S)
    w = RankWalk(job, mesh)
    beat()
    w.window()                                   # warm-up
    w.nfail.zero_()
    w.agree(0)                                   # every rank warmed up
    setup_s = perf_counter() - job.t_start
    beat()
    out = {"rank": rank, "i_e": mesh.i_e, "i_c": mesh.i_c,
           "device": str(mesh.device), "backend": mesh.backend,
           "setup_s": setup_s}
    c0 = outcome.counters()
    if job.trace_windows:
        out["traced"] = _traced(job, w, rank)
        beat()
        # the rest of the window untraced, so that the check draws from
        # as long a walk as an untraced run's (rank 0 decides)
        rest = job.seconds - out["traced"]["window_s"]
        iters, dt = (w.measure(rest, beat=beat)
                     if w.agree(rest > 0 and rank == 0) else (0, 0.0))
    else:
        iters, dt = w.measure(job.seconds, beat=beat)
    c1 = outcome.counters()
    out.update(iterations=iters, window_s=dt,
               nfail=w.nfail.cpu().numpy(), comm=_comm(mesh),
               rows={k: c1[k][1] - c0[k][1] for k in c1},
               forbidden=forbidden_loaded())
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
        out["memory_peak"] = torch.cuda.max_memory_allocated(mesh.device)
    else:
        out["memory_peak"] = 0
    if w.leader:
        out["history"] = w.history()
    return out


def _rank(rank, work):
    """Entry point of one spawned rank: join the world, walk, and write
    ``rank{rank}.pik`` into the work directory."""
    import torch.distributed as dist

    with open(os.path.join(work, "job.pik"), "rb") as f:
        job = pickle.load(f)
    if job.prepare is not None:
        job.prepare(rank)
    torch.set_num_threads(job.threads)
    device = torch.device(job.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)

    def beat():
        _beat(work, rank)

    beat()
    dist.init_process_group(
        job.backend, rank=rank, world_size=len(job.devices),
        init_method="file://" + os.path.join(work, "rendezvous"),
        timeout=timedelta(seconds=STALL_S))
    try:
        out = _walk_rank(job, rank, beat)
        tmp = os.path.join(work, f"rank{rank}.pik.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(work, f"rank{rank}.pik"))
    finally:
        dist.destroy_process_group()


def _stalled(work, n, t0):
    """Whether no rank has moved on for STALL_S seconds."""
    beats = [Path(work, f"alive{r}") for r in range(n)]
    last = max([p.stat().st_mtime for p in beats if p.exists()] + [t0])
    return time() - last > STALL_S


def _spawn(job):
    """Run every rank to its end; raise (with every rank stopped) where
    one fails or none moves on. Returns each rank's output, in rank
    order."""
    import torch.multiprocessing as mp

    from portbench.harness import common

    n = len(job.devices)
    with open(os.path.join(job.work, "job.pik"), "wb") as f:
        pickle.dump(job, f, protocol=pickle.HIGHEST_PROTOCOL)
    t0 = time()
    ctx = mp.start_processes(_rank, args=(job.work,), nprocs=n, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if _stalled(job.work, n, t0):
                raise RuntimeError(f"no rank of the mesh moved on for "
                                   f"{STALL_S} s; every rank stopped")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    common.log(f"{n} ranks joined after {time() - t0:.3f} s")
    outs = []
    for r in range(n):
        with open(os.path.join(job.work, f"rank{r}.pik"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _job(cell, args, t_start, work, prepare):
    from metrotrpl_tpu_torch import default_walk_dtype
    from metrotrpl_tpu_torch.inference.metropolis import plans_from_config
    from metrotrpl_tpu_torch.parallel.mesh import mesh_backend, mesh_devices

    from portbench.harness import common, outcome

    tr = cell.traffic
    dep = cell.config.get("deployment")
    if dep and [list(dep["mesh"]), dep["ensembles"]] != \
            [list(tr["mesh"]), tr["ensembles"]]:
        raise ValueError(f"{cell.name}: the traffic's mesh and ensembles "
                         f"differ from the configuration's deployment")
    sim_info, param_info, mc, e_data, iniPar, irf_tables = \
        common.program_inputs(cell)
    like_plan, move_plan = plans_from_config(
        sim_info, param_info, dict(mc), e_data, iniPar,
        irf_tables=irf_tables)
    names = list(param_info["names"])
    shape = tuple(int(x) for x in tr["mesh"])
    devices = mesh_devices(shape, device=outcome.DEVICE)
    n = shape[0] * shape[1]
    return Job(
        shape=shape, devices=[str(d) for d in devices],
        backend=mesh_backend(devices),
        threads=max(1, torch.get_num_threads() // n),
        like_plan=like_plan, move_plan=move_plan,
        temps=np.asarray(mc["parallel_tempering"], dtype=float),
        base_move=np.array([param_info["trial_move"][nm]
                            if param_info["active"][nm] else 0.0
                            for nm in names]),
        temper_freq=int(mc.get("temper_freq", 10)),
        x0=np.array([param_info["init_guess"][nm] for nm in names]),
        n_ens=int(tr["ensembles"]), window_iters=int(tr["window_iters"]),
        dtype=default_walk_dtype(outcome.DEVICE), seed=int(args.seed),
        seconds=float(args.seconds),
        trace_windows=int(tr["trace_windows"]) if args.trace else 0,
        trace_dir=str(common.CACHE_DIR / "trace" / cell.name),
        t_start=t_start, work=str(work), prepare=prepare)


def _merged_trace(traced):
    """The ranks' traced windows as one summary: their kernels, and busy
    and window seconds summed (so a share of the window is the ranks'
    mean), device seconds per range summed, the longest idle gaps."""
    from portbench.harness.trace import TraceSummary

    span_s = defaultdict(float)
    for t in traced:
        for k, v in t["summary"].span_device_s.items():
            span_s[k] += v
    gaps = sorted((g for t in traced for g in t["summary"].idle_gaps),
                  key=lambda g: -g[1])
    return TraceSummary(
        [k for t in traced for k in t["summary"].kernels],
        sum(t["summary"].busy_s for t in traced),
        sum(t["summary"].window_s for t in traced), dict(span_s),
        gaps[:10])


def run(cell, args, t_start, prepare=None):
    """Set up, measure or trace, and check one mesh cell. ``prepare(rank)``
    runs first in every rank (tests plant faults with it)."""
    from portbench.harness import check, common, outcome

    outcome.load_library()
    work = common.CACHE_DIR / f"mesh-{uuid.uuid4().hex}"
    work.mkdir(parents=True)
    try:
        job = _job(cell, args, t_start, work, prepare)
        outs = _spawn(job)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in outs:
        if r["forbidden"]:
            raise RuntimeError(f"rank {r['rank']} loaded modules that must "
                               f"not load: {r['forbidden']}")
        common.log(f"rank {r['rank']} ({r['device']}, {r['backend']}): "
                   f"{r['iterations']} iterations in {r['window_s']:.3f} s; "
                   f"rows solved since the warm-up {r['rows']}; "
                   f"collectives, bytes: {r['comm']}; peak memory "
                   f"{r['memory_peak']}")
        t = r.get("traced")
        if t:
            common.log(
                f"rank {r['rank']} traced: {t['iterations']} iterations, "
                f"{t['swap_rounds']} swap rounds, {t['window_s']:.3f} s, "
                f"busy {t['summary'].busy_s:.3f} s; NCCL device s in "
                f"spans {t['nccl_s']}; rows {t['counters']}; spans "
                f"{t['span_counts']}; collectives, bytes {t['comm']}")
    r0 = outs[0]
    E, K = job.n_ens, len(job.temps)
    leaders = sorted((r for r in outs if r["i_c"] == 0),
                     key=lambda r: r["i_e"])
    parts = [r["history"] for r in leaders]
    hist = (parts[0][0],) + tuple(
        np.concatenate([p[i] for p in parts]) for i in range(1, 6))
    seeds = [job.seed + e for e in range(E)]
    common.log(f"set-up {r0['setup_s']:.3f} s; window "
               f"{r0['window_s']:.3f} s")

    o = outcome.Outcome()
    o.memory_peak = max(r["memory_peak"] for r in outs)
    o.attempted = hist[3].shape[1] * E * K * cell.config["simPar"]["num_meas"]
    o.failed = int(sum(int(r["nfail"].sum()) for r in leaders))
    o.e2e = {"setup_s": r0["setup_s"]}
    if r0["window_s"] > 0:
        o.e2e["walker_steps_per_s"] = r0["iterations"] * K * E / \
            r0["window_s"]
    o.history, o.seeds, o.dtype = hist, seeds, job.dtype
    if args.trace:
        traced = [r["traced"] for r in outs]
        c1 = defaultdict(lambda: (0, 0))
        for t in traced:
            for k, (n, rows) in t["counters"].items():
                c1[k] = (c1[k][0] + n, c1[k][1] + rows)
        c1 = dict(c1)
        it = traced[0]["iterations"]
        o.ctx = outcome.reader_context(
            cell, {k: (0, 0) for k in c1}, c1, _merged_trace(traced),
            iters=it, evals=it)
        o.ctx["ranks"] = traced
    t_check = perf_counter()
    o.compared, o.correct = check.walk_verdict(cell, hist, seeds, job.dtype,
                                               outcome.DEVICE, args.seed)
    common.log(f"check {perf_counter() - t_check:.3f} s")
    sys.stderr.flush()
    return o
