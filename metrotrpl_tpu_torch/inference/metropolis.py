"""Metropolis-Hastings walk with parallel tempering, one or E ensembles.

Counterpart of ``metrotrpl_tpu/inference/metropolis.py``: :func:`metro`
builds the plans from the parsed config and data; :func:`run_mh_fused`
drives checkpoint windows of :func:`build_mh_kernel`'s window function
over E independent tempered ensembles fused into one solve batch
(:func:`vmap_ensembles`), copies each window's states / log-likelihoods
/ accepts of all ensembles to the host History once, and writes one
checkpoint per ensemble that the reference GUI and both packages'
``io.ensemble.load_checkpoint`` load. :func:`run_mh` is the same loop for
one ensemble.

The escalation ladder runs inline in every evaluation, for the rows of
all ensembles at once. The JAX package defers it (it re-runs a failing
window through an inline-escalation kernel, because an untaken
``lax.cond`` is costly on a TPU); its re-run reproduces the inline window
exactly (JAX metropolis.py:707-712), so the walk's semantics are the
same. What exists only for that TPU schedule is not ported: the deferred
re-runs and their streak counter, the switch to a fused inline kernel,
``_plan_has_f64_rung``, and the ``batch_mult`` / ``block_b`` batch
tiling.

:func:`run_mh_sharded` is the sharded walk's host loop, run by every rank
of a (d_e, d_c) grid of processes (``parallel/``);
``metro(mesh_shape=(d_e, d_c))`` spawns the ranks and returns the
ensembles their block leaders wrote.
"""

import json
import os
import signal
from datetime import timedelta
from time import perf_counter
from typing import NamedTuple

import numpy as np
import torch

from metrotrpl_tpu_torch.constants import MSG_FREQ
from metrotrpl_tpu_torch.io.ensemble import Ensemble, load_checkpoint
from metrotrpl_tpu_torch import default_walk_dtype, resolve_device
from metrotrpl_tpu_torch.inference.likelihood import (
    build_likelihood_plan,
    make_eval_logll,
    resolve_solver_mode,
)
from metrotrpl_tpu_torch.inference.mh_core import (
    TorchDraws,
    WalkEval,
    make_window_body,
)
from metrotrpl_tpu_torch.inference.moves import build_move_plan, n_tries


class MHKernel(NamedTuple):
    run_window: callable      # (states, ll_T, k0, n_iters, source) ->
                              # (states, ll_T, swap_att, swap_acc, nfail, hist)
    init_ll: callable         # states -> ll_T
    fused_window: callable    # the window over E ensembles both forms run
                              # (mh_core.make_window_body)


def build_mh_kernel(like_plan, move_plan, temps, base_trial_move, temper_freq,
                    do_tempering, dtype=torch.float64, device="cuda",
                    _eager=False):
    """The MH window function of one ensemble on ``device``: run_window
    takes states (K, P), ll_T (K, K) and one draw source; init_ll takes
    (K, P) states. :func:`vmap_ensembles` gives its form over E ensembles.

    temps : (K,) tempering temperatures (one chain per temperature).
    base_trial_move : (P,) per-parameter move widths (0 = frozen).
    _eager : walk eagerly on a card too, without the CUDA graphs (tests).
    """
    device = resolve_device(device)
    temps_t = torch.as_tensor(np.asarray(temps), dtype=dtype, device=device)
    base_move = torch.as_tensor(np.asarray(base_trial_move), dtype=dtype,
                                device=device)
    widths = torch.sqrt(temps_t)[:, None] * base_move[None, :]   # (K, P)
    eval_nf = WalkEval(make_eval_logll(like_plan, dtype=dtype,
                                       device=device), temps_t)
    window = make_window_body(eval_nf, move_plan, widths, temper_freq,
                              do_tempering, _eager=_eager)

    def run_window(states, ll_T, k0, n_iters, source):
        out = window(states[None], ll_T[None], k0, n_iters, [source])
        *head, hist = out
        return (*(a[0] for a in head), tuple(h[0] for h in hist))

    return MHKernel(run_window=run_window,
                    init_ll=lambda states: eval_nf(states)[0],
                    fused_window=window)


def vmap_ensembles(kernel):
    """The kernel over E ensembles fused into one solve batch (the JAX
    ``vmap_ensembles``): run_window takes states (E, K, P), ll_T
    (E, K, K) and E draw sources and returns every output with a leading
    E axis; init_ll takes (E, K, P) states. Each iteration evaluates the
    E * K proposals in one call, so every kernel instantiation launches
    at most once per iteration and measurement group whatever E is, and
    the ladder's one host sync per group is shared by all ensembles."""
    def init_ll(states_E):
        E, K, P = states_E.shape
        return kernel.init_ll(states_E.reshape(E * K, P)).reshape(E, K, -1)

    return kernel._replace(run_window=kernel.fused_window, init_ll=init_ll)


def run_ensembles_sequential(kernel, states_E, ll_E, k0, n_iters, sources):
    """Advance E independent tempered ensembles one window each by running
    the single-ensemble ``kernel`` back to back: E evaluations per
    iteration instead of :func:`vmap_ensembles`' one.

    states_E : (E, K, P); ll_E : (E, K, K); sources : E draw sources.
    Returns the outputs of the fused window, stacked with a leading E."""
    outs = [kernel.run_window(states_E[e], ll_E[e], k0, n_iters, sources[e])
            for e in range(states_E.shape[0])]
    *head, hists = zip(*outs)
    return (*(torch.stack(a) for a in head),
            tuple(torch.stack(h) for h in zip(*hists)))


def _restore_carried_ll(ensembles, K):
    """The (E, K, K) ll matrices carried at checkpoint time, or None if
    any replica lacks one (reference pickles, or a rewound resume)."""
    mats = [getattr(ens, "_carried_ll", None) for ens in ensembles]
    if any(m is None or np.shape(m) != (K, K) for m in mats):
        return None
    return np.stack(mats)


def _even_window(total_iters, checkpoint_freq):
    """Window length splitting `total_iters` into near-equal windows no
    longer than `checkpoint_freq`."""
    total = max(1, int(total_iters))
    n_win = -(-total // max(1, int(checkpoint_freq)))
    return -(-total // n_win)


def kill_from_cl(signal_n, frame):
    raise KeyboardInterrupt("Terminate from command line")


def all_signal_handler(func):
    """Trap genuine termination signals to ``func``."""
    for name in ("SIGINT", "SIGTERM", "SIGHUP", "SIGQUIT", "SIGUSR1",
                 "SIGUSR2"):
        s = getattr(signal, name, None)
        if s is None:
            continue
        try:
            signal.signal(s, func)
        except (ValueError, OSError):
            continue


def _window_history(hist, swap_att, swap_acc, ll, gather):
    """A window's History rows of an (E_l, K_l) block, put together over
    the chains by ``gather`` in one call: numpy states (E_l, K, n, P),
    ll_own (E_l, K, n), accept (E_l, K, n), swap_att and swap_acc
    (E_l, K) and the carried ll (E_l, K, K) in the walk dtype."""
    h_states, h_ll, h_acc = hist
    E_l, n, K_l, P = h_states.shape
    f64 = torch.float64
    buf = torch.cat([
        h_states.permute(0, 2, 1, 3).reshape(E_l, K_l, n * P).to(f64),
        h_ll.transpose(1, 2).to(f64), h_acc.transpose(1, 2).to(f64),
        swap_att[..., None].to(f64), swap_acc[..., None].to(f64),
        ll.to(f64)], dim=2)
    g = gather(buf).cpu()                  # (E_l, K, n * P + 2 n + 2 + K)
    K = g.shape[1]
    cut = np.cumsum([n * P, n, n, 1, 1])
    st, lo, acc, att, sacc, llc = torch.tensor_split(g, cut.tolist(), dim=2)
    return (st.reshape(E_l, K, n, P).numpy(), lo.numpy(),
            acc.numpy().astype(bool), att[..., 0].numpy().astype(np.int64),
            sacc[..., 0].numpy().astype(np.int64), llc.to(ll.dtype).numpy())


def _walk_windows(ensembles, kernel, sources, logger, export_paths, dtype,
                  device, starting_iter, need_initial_state, block=None,
                  gather=None, owner=True):
    """The host loop of checkpoint windows (reference metro() loop,
    metropolis.py:373-463) shared by :func:`run_mh_fused` and
    :func:`run_mh_sharded`: E_l ensembles, of whose K chains this process
    walks ``block = (c0, K_l)`` (default all of them) through
    ``kernel.run_window``. Each window's History rows are copied to the
    host once, put together over the chains by ``gather`` (default: the
    block is the whole ensemble); the ``owner`` of the ensembles' History
    writes it into them and checkpoints them, every window and at the
    end."""
    E_l = len(ensembles)
    ef0 = ensembles[0].ensemble_fields
    num_iters = ef0["num_iters"]
    checkpoint_freq = ef0.get("checkpoint_freq") or num_iters
    K = len(ef0["_T"])
    c0, K_l = block or (0, K)
    rows = slice(c0, c0 + K_l)
    gather = gather or (lambda x: x)
    clock0 = perf_counter()

    states = torch.as_tensor(np.stack(
        [ens.H.states[rows, :, max(starting_iter - 1, 0)]
         for ens in ensembles]), dtype=dtype, device=device)
    window = _even_window(num_iters - max(1, starting_iter) + 1,
                          checkpoint_freq)
    carried = (None if need_initial_state
               else _restore_carried_ll(ensembles, K))
    ll = (kernel.init_ll(states) if carried is None
          else torch.as_tensor(carried[:, rows], dtype=dtype, device=device))
    if need_initial_state:
        logger.info(f"Simulating initial state ({E_l} ensembles x {K_l} "
                    "chains):")
        ll_diag = gather(torch.diagonal(ll, c0, dim1=1, dim2=2)[..., None])
        ll_diag = ll_diag[..., 0].cpu().numpy()
        if owner:
            for e, ens in enumerate(ensembles):
                ens.H.loglikelihood[:, 0] = ll_diag[e]
        starting_iter = 1

    k = starting_iter
    while k < num_iters:
        n_this = min(window, num_iters - k)
        logger.info(f"Simulating from {k} to {k + n_this} ({E_l} "
                    f"ensembles x {K_l} chains)")
        t_win = perf_counter()
        states, ll, swap_att, swap_acc, nfail, hist = kernel.run_window(
            states, ll, k, n_this, sources)
        # one copy to the host per window, for all ensembles
        h_states, h_ll, h_accept, att_h, acc_h, ll_host = _window_history(
            hist, swap_att, swap_acc, ll, gather)
        nfail_h = nfail.cpu().numpy()
        dt_win = perf_counter() - t_win
        logger.info(
            f"Window of {n_this} iters x {E_l} ensembles x {K_l} chains "
            f"took {dt_win:.3f} s "
            f"({n_this * K_l * E_l / max(dt_win, 1e-9):.1f} walker-steps/s)")
        k += n_this
        if not owner:
            continue
        for e in np.nonzero(nfail_h)[0]:
            logger.warning(f"Ensemble {e} window {k - n_this}-{k}: "
                           f"{int(nfail_h[e])} solves failed after "
                           "escalation (rejected as -inf)")
        for e, ens in enumerate(ensembles):
            H = ens.H
            H.states[:, :, k - n_this:k] = h_states[e].transpose(0, 2, 1)
            H.loglikelihood[:, k - n_this:k] = h_ll[e]
            H.accept[:, k - n_this:k] = h_accept[e]
            H.swap_attempts += att_h[e]
            H.swap_accept += acc_h[e]
            ens.latest_iter = k
            ens._carried_ll = ll_host[e]
        if k < num_iters:
            logger.info(f"Saving checkpoints at k={k}")
            for ens, ep in zip(ensembles, export_paths):
                ens.checkpoint(os.path.join(
                    ens.ensemble_fields["output_path"], ep))
        if k % MSG_FREQ < window:
            for e, ens in enumerate(ensembles):
                for m in range(K):
                    logger.info(
                        f"Iter {k} ensemble {e} chain {m} state: "
                        f"{ens.H.states[m, :, k - 1]} "
                        f"logll {ens.H.loglikelihood[m, k - 1]}")

    logger.info(f"Total walk ({E_l} ensembles x {K_l} chains) took "
                f"{perf_counter() - clock0} s")
    if not owner:
        return
    for ens, ep in zip(ensembles, export_paths):
        H = ens.H
        with np.errstate(divide="ignore", invalid="ignore"):
            rate = 100 * H.swap_accept[:-1] / np.maximum(H.swap_attempts[:-1],
                                                         1)
        logger.info(
            f"Swap accept rate: {H.swap_accept} accepted of "
            f"{H.swap_attempts} attempts ({rate} %)")
        ens.checkpoint(os.path.join(ens.ensemble_fields["output_path"], ep))


def _draw_sources(seeds, K, n_params, move_plan, dtype, device):
    """The production draw source of each ensemble (all K chains)."""
    return [TorchDraws(seed, K, n_params, n_tries(move_plan),
                       move_plan.mu_constraint is not None, dtype, device)
            for seed in seeds]


def run_mh_fused(ensembles, like_plan, move_plan, logger, seeds,
                 export_paths=None, dtype=torch.float64, device="cuda",
                 starting_iter=0, need_initial_state=True,
                 draw_sources=None):
    """Advance E independent tempered ensembles in lockstep through one
    fused window (:func:`vmap_ensembles`): host loop of checkpoint windows
    (reference metro() loop structure, metropolis.py:373-463).

    All ensembles share the run geometry (temps, num_iters,
    checkpoint_freq, proposal plan: the same config), but each has its
    own draw stream, states, History and export file; ensemble e equals a
    single-ensemble walk at seeds[e].

    ensembles : list of metrotrpl_tpu_torch.io.ensemble.Ensemble (mutated
        in place).
    seeds : E draw-stream seeds (reference jobid semantics, main.py:36).
    export_paths : per-ensemble checkpoint filenames (default
        CPU{e}-final.pik).
    draw_sources : replace the production :class:`TorchDraws` (tests).
    """
    device = resolve_device(device)
    if export_paths is None:
        export_paths = [f"CPU{e}-final.pik" for e in range(len(ensembles))]
    ef0 = ensembles[0].ensemble_fields
    temps = np.asarray(ef0["_T"], dtype=float)
    for ens, seed in zip(ensembles, seeds):
        ens.ensemble_fields["_rng_seed"] = seed
    kernel = vmap_ensembles(build_mh_kernel(
        like_plan, move_plan, temps, ef0["base_trial_move"],
        ef0.get("temper_freq", 10), ef0["do_parallel_tempering"],
        dtype=dtype, device=device))
    sources = draw_sources or _draw_sources(
        seeds, len(temps), ensembles[0].H.states.shape[1], move_plan, dtype,
        device)
    _walk_windows(ensembles, kernel, sources, logger, export_paths, dtype,
                  device, starting_iter, need_initial_state)
    return ensembles


def run_mh(ensemble, like_plan, move_plan, logger, seed=235817049752375780,
           export_path="", dtype=torch.float64, device="cuda",
           starting_iter=0, need_initial_state=True, draw_source=None):
    """Host loop of one ensemble: :func:`run_mh_fused` with E = 1.

    ensemble : metrotrpl_tpu_torch.io.ensemble.Ensemble (mutated in place).
    draw_source : replaces the production :class:`TorchDraws` (tests).
    """
    run_mh_fused([ensemble], like_plan, move_plan, logger, [seed],
                 export_paths=[export_path], dtype=dtype, device=device,
                 starting_iter=starting_iter,
                 need_initial_state=need_initial_state,
                 draw_sources=None if draw_source is None else [draw_source])
    return ensemble


def run_mh_sharded(ensembles, like_plan, move_plan, logger, seeds, mesh,
                   export_paths=None, dtype=torch.float64, starting_iter=0,
                   need_initial_state=True, draw_sources=None):
    """One rank's host loop of the sharded walk (JAX ``run_mh_sharded``):
    the checkpoint windows of :func:`run_mh_fused` over the rank's block
    of E_l ensembles x K_l chains (``parallel/sharded_mh``), on
    ``mesh.device``.

    Every rank of the (d_e, d_c) grid calls it with its block's
    ensembles, seeds and export paths. Each window the block's leader
    (i_c == 0) all-gathers its chains group's History rows (states,
    own-temperature ll, accepts, swap counters, carried ll), owns the
    block's History and writes its ``CPU{j}-final.pik`` every window and
    at the end; the other ranks' ensembles only seed their rows.

    ensembles : the block's E_l Ensembles (mutated in place on the
        leader).
    seeds : the block's E_l draw-stream seeds; ensemble e's source draws
        all K chains and the rank keeps its own, so any layout equals
        ``run_mh_fused`` at the same seeds.
    mesh : the rank's :class:`~metrotrpl_tpu_torch.parallel.ChainMesh`.
    draw_sources : replace the production :class:`TorchDraws` (tests).
    """
    from metrotrpl_tpu_torch.parallel.sharded_mh import (
        build_sharded_mh_kernel,
        gather_history,
    )

    E_l = len(ensembles)
    if export_paths is None:
        export_paths = [f"CPU{mesh.i_e * E_l + e}-final.pik"
                        for e in range(E_l)]
    ef0 = ensembles[0].ensemble_fields
    temps = np.asarray(ef0["_T"], dtype=float)
    for ens, seed in zip(ensembles, seeds):
        ens.ensemble_fields["_rng_seed"] = seed
    kernel = build_sharded_mh_kernel(
        like_plan, move_plan, temps, ef0["base_trial_move"],
        ef0.get("temper_freq", 10), ef0["do_parallel_tempering"], mesh,
        n_ens=E_l * mesh.shape[0], dtype=dtype)
    sources = draw_sources or _draw_sources(
        seeds, len(temps), ensembles[0].H.states.shape[1], move_plan, dtype,
        mesh.device)
    _walk_windows(ensembles, kernel, sources, logger, export_paths, dtype,
                  mesh.device, starting_iter, need_initial_state,
                  block=(kernel.topo.offsets()[1], kernel.topo.K_l),
                  gather=lambda x: gather_history(mesh, x),
                  owner=mesh.i_c == 0)
    return ensembles


#: seconds a mesh rank waits at the rendezvous or a collective before it
#: fails (and its failure stops the others): the slowest rank's start,
#: or its walk between two tempering swaps, must fit in it
MESH_TIMEOUT_S = 300


class _MeshJob(NamedTuple):
    """What every rank of a spawned mesh walk reads from ``job.pik`` in
    its work directory (beside the rendezvous file and each ensemble
    block's ``block{i_e}.pik``): passed as spawn arguments, a payload
    larger than a pipe's buffer holds each start until the rank before
    it has read its own."""
    mesh_shape: tuple
    devices: list            # one device string per rank
    backend: str
    threads: int             # torch threads per rank
    like_plan: object
    move_plan: object
    seeds: list
    export_paths: list
    dtype: torch.dtype
    starting_iter: int
    need_initial_state: bool
    log_dir: str
    logger_name: str
    verbose: bool


def _mesh_rank(rank, work_dir):
    """Entry point of one spawned rank: join the world, walk the rank's
    block (:func:`run_mh_sharded`), write ``mesh_rank{rank}.json`` (its
    place, device, backend, seconds, kernel launches and rows, and the
    collectives it made over its chains group with the bytes it put into
    them) into the log directory."""
    import pickle

    import torch.distributed as dist

    from metrotrpl_tpu_torch.io.logging import start_logging, stop_logging
    from metrotrpl_tpu_torch.parallel.mesh import make_chain_mesh
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    with open(os.path.join(work_dir, "job.pik"), "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(job.threads)
    d_e, d_c = job.mesh_shape
    device = torch.device(job.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        job.backend, rank=rank, world_size=d_e * d_c,
        init_method="file://" + os.path.join(work_dir, "rendezvous"),
        timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_chain_mesh(job.mesh_shape, job.devices, job.backend,
                               MESH_TIMEOUT_S)
        with open(os.path.join(work_dir, f"block{mesh.i_e}.pik"),
                  "rb") as f:
            ensembles = pickle.load(f)
        blk = slice(mesh.i_e * len(ensembles),
                    (mesh.i_e + 1) * len(ensembles))
        logger, handler = start_logging(
            job.log_dir, name=f"{job.logger_name}.rank{rank}",
            verbose=job.verbose)
        logger.info(f"Rank {rank} of a {d_e}x{d_c} mesh: ensembles "
                    f"{blk.start}-{blk.stop - 1}, chain block {mesh.i_c}, "
                    f"device {device}, backend {job.backend}")
        sk.reset_launch_counts()
        t0 = perf_counter()
        run_mh_sharded(ensembles, job.like_plan, job.move_plan, logger,
                       job.seeds[blk], mesh,
                       export_paths=job.export_paths[blk], dtype=job.dtype,
                       starting_iter=job.starting_iter,
                       need_initial_state=job.need_initial_state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        tag = {torch.float32: "f32", torch.float64: "f64"}
        report = {
            "rank": rank, "i_e": mesh.i_e, "i_c": mesh.i_c,
            "device": str(device), "backend": job.backend,
            "walk_s": perf_counter() - t0,
            "launches": {f"{m}_{tag[d]}": n
                         for (m, d), n in sk.LAUNCHES.items()},
            "rows": {f"{m}_{tag[d]}": n for (m, d), n in sk.ROWS.items()},
            "collectives": mesh.comm.collectives,
            "collective_bytes": mesh.comm.bytes}
        with open(os.path.join(job.log_dir, f"mesh_rank{rank}.json"),
                  "w") as f:
            json.dump(report, f)
        stop_logging(logger, handler)
        dist.barrier()   # every leader's checkpoints are on disk
    finally:
        dist.destroy_process_group()


def _walk_mesh(ensembles, like_plan, move_plan, logger, seeds, mesh_shape,
               devices, export_paths, dtype, starting_iter,
               need_initial_state, logger_name, verbose):
    """Spawn the d_e * d_c ranks of a mesh walk, join them (raising with
    the traceback of a rank that failed; the others are then stopped),
    and return the ensembles loaded from the checkpoints their block
    leaders wrote."""
    import pickle
    import shutil
    import uuid

    import torch.multiprocessing as mp

    from metrotrpl_tpu_torch.parallel.mesh import mesh_backend

    d_e, d_c = (int(x) for x in mesh_shape)
    E, K = len(ensembles), len(ensembles[0].ensemble_fields["_T"])
    if E % d_e or K % d_c:
        raise ValueError(f"(n_ens={E}, n_chains={K}) not divisible by mesh "
                         f"shape (ens={d_e}, chains={d_c})")
    n = d_e * d_c
    backend = mesh_backend(devices)
    logger.info(f"{d_e}x{d_c} mesh of processes, backend {backend}, "
                f"devices {[str(d) for d in devices]}")
    if any(d.type == "cuda" for d in devices):
        from metrotrpl_tpu_torch.solver._build import build_library
        build_library()   # here, so that the ranks load a finished library
    out_dir = ensembles[0].ensemble_fields["output_path"]
    work = os.path.join(out_dir, f".mesh-{uuid.uuid4().hex}")
    os.makedirs(work)
    E_l = E // d_e
    t0 = perf_counter()
    try:
        for i in range(d_e):
            with open(os.path.join(work, f"block{i}.pik"), "wb") as f:
                pickle.dump(ensembles[i * E_l:(i + 1) * E_l], f,
                            protocol=pickle.HIGHEST_PROTOCOL)
        job = _MeshJob(
            mesh_shape=(d_e, d_c), devices=[str(d) for d in devices],
            backend=backend,
            threads=max(1, torch.get_num_threads() // n),
            like_plan=like_plan, move_plan=move_plan, seeds=list(seeds),
            export_paths=list(export_paths), dtype=dtype,
            starting_iter=starting_iter,
            need_initial_state=need_initial_state, log_dir=out_dir,
            logger_name=logger_name, verbose=verbose)
        with open(os.path.join(work, "job.pik"), "wb") as f:
            pickle.dump(job, f, protocol=pickle.HIGHEST_PROTOCOL)
        ctx = mp.start_processes(_mesh_rank, args=(work,), nprocs=n,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = perf_counter() - t0
    reports = []
    for r in range(n):
        with open(os.path.join(out_dir, f"mesh_rank{r}.json")) as f:
            reports.append(json.load(f))
    n_iters = ensembles[0].ensemble_fields["num_iters"] - starting_iter
    logger.info(
        f"Mesh walk took {wall:.3f} s (spawn included): "
        f"{n_iters * K * E / wall:.1f} aggregate walker-steps/s; launches "
        "per rank " + "; ".join(
            f"{r['rank']}: " + ", ".join(
                f"{key} {v}" for key, v in r["launches"].items() if v)
            for r in reports))
    return [load_checkpoint(os.path.join(out_dir, ep))
            for ep in export_paths]


def _resolve_ckpt_paths(load_ckpt, n):
    """Per-replica checkpoint filenames for a resume: a list/tuple of n
    names, or a '{e}' template (e.g. 'CPU{e}-final.pik', the fused
    driver's own export naming)."""
    if isinstance(load_ckpt, (list, tuple)):
        if len(load_ckpt) != n:
            raise ValueError(
                f"load_checkpoint lists {len(load_ckpt)} files for "
                f"{n} ensembles")
        return list(load_ckpt)
    if n == 1:
        return [load_ckpt]
    paths = [load_ckpt.format(e=e) for e in range(n)]
    if len(set(paths)) != n:
        raise ValueError(
            "resuming n_ensembles > 1 needs per-replica checkpoints: pass "
            "load_checkpoint as a list or a '{e}' template, e.g. "
            "'CPU{e}-final.pik'")
    return paths


def _resume_starting_iter(ensembles, MCMC_fields, num_iters):
    """Rewind/extend loaded checkpoints to continue to ``num_iters``;
    returns the starting iteration (reference metropolis.py:342-353).
    Replicas checkpoint together, but an interrupt can leave them a
    window apart: all restart from the minimum."""
    latest = min(ens.latest_iter for ens in ensembles)
    if ("starting_iter" in MCMC_fields
            and MCMC_fields["starting_iter"] < latest):
        start = MCMC_fields["starting_iter"]
    else:
        start = min(latest, num_iters)
    for ens in ensembles:
        if start != ens.latest_iter:
            ens._carried_ll = None   # belongs to a later state
        ens.H.extend(start)
        ens.H.extend(num_iters)
        ens.ensemble_fields["num_iters"] = num_iters
        ens.latest_iter = start
    return start


def plans_from_config(sim_info, param_info, MCMC_fields, e_data, iniPar,
                      irf_tables=None, logger=None, **kwargs):
    """The likelihood and move plans :func:`metro` builds from a parsed
    config and its data (same kwargs as metro)."""
    from metrotrpl_tpu_torch.solver.forward import refine_for_tols

    refine = kwargs.get("refine")
    if refine is None:
        n_steps_est = max((len(t) for t in e_data[0]), default=500)
        refine = refine_for_tols(
            MCMC_fields.get("rtol"), MCMC_fields.get("atol"),
            n_steps=n_steps_est, logger=logger)
    hmax_kw, align_outputs = resolve_solver_mode(
        MCMC_fields, 4.0, kwargs.get("hmax"), kwargs.get("align_outputs"))
    if not align_outputs and logger is not None:
        logger.info(f"sdirk fast mode: decoupled step grid, hmax={hmax_kw}")
    like_plan = build_likelihood_plan(
        sim_info, param_info, MCMC_fields, e_data, iniPar,
        irf_tables=irf_tables,
        scheme=kwargs.get("scheme", "sdirk3"),
        newton_iters=kwargs.get("newton_iters", 2),
        hmax=hmax_kw, align_outputs=align_outputs,
        refactor_every=int(kwargs.get("refactor_every")
                           or MCMC_fields.get("refactor_every", 1)),
        ramp_block=int(kwargs.get("ramp_block")
                       or MCMC_fields.get("ramp_block", 1)),
        newton_plateau=(lambda v: None if v is None else int(v))(
            kwargs.get("newton_plateau",
                       MCMC_fields.get("newton_plateau"))),
        newton_div_tol=kwargs.get("newton_div_tol"),
        refine=refine, escalate=bool(kwargs.get("escalate", True)))
    return like_plan, build_move_plan(param_info, MCMC_fields)


def metro(sim_info, iniPar, e_data, MCMC_fields, param_info, verbose=False,
          export_path="", device="cuda", **kwargs):
    """Top-level MH inference entry point (reference metropolis.py:283
    signature). Builds plans from the parsed config and data, runs the
    walk on ``device``, writes GUI-loadable checkpoints; returns the
    ensemble.

    kwargs['n_ensembles'] = E > 1 runs E independent replicas of the walk
    (reference multi-jobid semantics, main.py:36) fused into one solve
    batch (:func:`run_mh_fused`): replica e draws from seed + e (on
    resume, from the seed its checkpoint stored) and writes its own
    ``CPU{e}-final.pik`` (or ``export_paths[e]``); returns the list of
    ensembles. Resume it by passing load_checkpoint as a '{e}' template
    or a list of per-replica files.

    kwargs['mesh_shape'] = (d_e, d_c) runs the same E replicas as the
    sharded walk: d_e * d_c processes (``torch.multiprocessing``, spawn),
    rank i_e * d_c + i_c walking ensembles [i_e E/d_e, (i_e+1) E/d_e) x
    chains [i_c K/d_c, (i_c+1) K/d_c) on its own device
    (:func:`run_mh_sharded`). ``devices`` names each rank's device (ranks
    may share a card: ``["cuda:0"] * 4``); by default each rank has a
    card of its own, or, with device="cpu", the CPU. The ranks meet
    through a ``file://`` store in the output directory; a rank that
    fails raises here with its traceback. The seeds are the fused walk's
    (seed + e, or ``seeds``), and so is the result, whatever the layout.
    (The JAX CLI gives a mesh one shared seed folded in per ensemble; the
    port's draws differ from JAX's stream anyway, and the tests hold the
    port to JAX through a replay of JAX's draws.) Each block leader
    writes its replicas' checkpoints every window, so an interrupted mesh
    run resumes from its last finished window.

    kwargs: n_ensembles, seed, seeds, export_paths, dtype (default float32
    on CUDA, float64 on the CPU), irf_dir, refine, hmax, align_outputs,
    scheme, newton_iters, refactor_every, ramp_block, newton_plateau,
    newton_div_tol, escalate, logger_name, trap_signals, draw_source (one
    ensemble only, not with a mesh), mesh_shape, devices.
    """
    from metrotrpl_tpu_torch.config.data_io import make_dir
    from metrotrpl_tpu_torch.io.logging import start_logging, stop_logging
    from metrotrpl_tpu_torch.ops.convolve import load_irf_tables

    mesh_shape = kwargs.get("mesh_shape")
    if mesh_shape:
        from metrotrpl_tpu_torch.parallel.mesh import mesh_devices

        if kwargs.get("draw_source") is not None:
            raise ValueError("draw_source walks one ensemble in this "
                             "process; it does not apply to mesh_shape")
        mesh_devs = mesh_devices(mesh_shape, kwargs.get("devices"), device)
        device = mesh_devs[0]
    else:
        device = resolve_device(device)
    n_ensembles = int(kwargs.get("n_ensembles", 1))
    make_dir(MCMC_fields["output_path"])
    logger, handler = start_logging(
        log_dir=MCMC_fields["output_path"],
        name=kwargs.get("logger_name", "Ensemble0"), verbose=verbose)
    if kwargs.get("trap_signals", True):
        all_signal_handler(kill_from_cl)

    load_ckpt = MCMC_fields.get("load_checkpoint", None)
    num_iters = MCMC_fields["num_iters"]
    starting_iter = 0
    if load_ckpt is None:
        ensembles = [Ensemble(param_info, sim_info, MCMC_fields, num_iters,
                              verbose) for _ in range(n_ensembles)]
        need_initial_state = True
    else:
        ensembles = [
            load_checkpoint(os.path.join(MCMC_fields["output_path"], p))
            for p in _resolve_ckpt_paths(load_ckpt, n_ensembles)]
        starting_iter = _resume_starting_iter(ensembles, MCMC_fields,
                                              num_iters)
        need_initial_state = False
    ensemble = ensembles[0]

    ef = ensemble.ensemble_fields
    irf_tables = {}
    if ef.get("irf_convolution", None) is not None:
        irf_tables = load_irf_tables(ef["irf_convolution"],
                                     kwargs.get("irf_dir", "IRFs"))
    for ens in ensembles:
        ens_f = ens.ensemble_fields
        ens_f["_init_params"] = iniPar
        ens_f["_times"], ens_f["_vals"], ens_f["_uncs"] = e_data
        ens_f["_IRF_tables"] = irf_tables
    for i, unc in enumerate(ef["_uncs"]):
        logger.info(f"{i} exp unc max: {np.amax(unc)} avg: {np.mean(unc)}")

    mcmc_for_plan = dict(MCMC_fields)
    mcmc_for_plan.setdefault("model_uncertainty",
                             ensemble.unique_fields[0].get(
                                 "model_uncertainty"))
    like_plan, move_plan = plans_from_config(
        sim_info, param_info, mcmc_for_plan, e_data, iniPar,
        irf_tables=irf_tables, logger=logger, **kwargs)

    logger.info(f"Sim info: {sim_info}")
    seed = kwargs.get("seed")
    if seed is None:
        seed = ((ef.get("_rng_seed") if load_ckpt is not None else None)
                or 235817049752375780)
    if n_ensembles == 1:
        seeds = [seed]
        export_paths = kwargs.get("export_paths") or [export_path]
    else:
        seeds = kwargs.get("seeds")
        if seeds is None:
            seeds = ([ens.ensemble_fields.get("_rng_seed", seed + e)
                      for e, ens in enumerate(ensembles)]
                     if load_ckpt is not None
                     else [seed + e for e in range(n_ensembles)])
        export_paths = (kwargs.get("export_paths")
                        or [f"CPU{e}-final.pik" for e in range(n_ensembles)])
    dtype = kwargs.get("dtype") or default_walk_dtype(device)
    logger.info(f"Walk dtype: {dtype}, device: {device}, "
                f"{n_ensembles} ensembles")
    if mesh_shape:
        ensembles = _walk_mesh(
            ensembles, like_plan, move_plan, logger, seeds, mesh_shape,
            mesh_devs, export_paths, dtype, starting_iter,
            need_initial_state, kwargs.get("logger_name", "Ensemble0"),
            verbose)
        stop_logging(logger, handler, 0)
        return ensembles if n_ensembles > 1 else ensembles[0]
    draw_source = kwargs.get("draw_source")
    try:
        run_mh_fused(ensembles, like_plan, move_plan, logger, seeds=seeds,
                     export_paths=export_paths, dtype=dtype, device=device,
                     starting_iter=starting_iter,
                     need_initial_state=need_initial_state,
                     draw_sources=None if draw_source is None
                     else [draw_source])
    except KeyboardInterrupt:
        logger.warning(
            f"Interrupted at iteration {ensemble.latest_iter}; truncating "
            "histories and writing the final checkpoints")
        for ens, ep in zip(ensembles, export_paths):
            ens.H.truncate(max(ens.latest_iter, 1))
            ens.checkpoint(os.path.join(ens.ensemble_fields["output_path"],
                                        ep))
        stop_logging(logger, handler, 1)
        return ensembles if n_ensembles > 1 else ensemble
    stop_logging(logger, handler, 0)
    return ensembles if n_ensembles > 1 else ensemble
