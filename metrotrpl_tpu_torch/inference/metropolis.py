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
tiling. ``mesh_shape`` (the sharded multi-device walk) raises
``NotImplementedError``.
"""

import os
import signal
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
from metrotrpl_tpu_torch.inference.mh_core import TorchDraws, make_window_body
from metrotrpl_tpu_torch.inference.moves import build_move_plan, n_tries


class MHKernel(NamedTuple):
    run_window: callable      # (states, ll_T, k0, n_iters, source) ->
                              # (states, ll_T, swap_att, swap_acc, nfail, hist)
    init_ll: callable         # states -> ll_T
    fused_window: callable    # the window over E ensembles both forms run
                              # (mh_core.make_window_body)


def build_mh_kernel(like_plan, move_plan, temps, base_trial_move, temper_freq,
                    do_tempering, dtype=torch.float64, device="cuda"):
    """The MH window function of one ensemble on ``device``: run_window
    takes states (K, P), ll_T (K, K) and one draw source; init_ll takes
    (K, P) states. :func:`vmap_ensembles` gives its form over E ensembles.

    temps : (K,) tempering temperatures (one chain per temperature).
    base_trial_move : (P,) per-parameter move widths (0 = frozen).
    """
    device = resolve_device(device)
    temps_t = torch.as_tensor(np.asarray(temps), dtype=dtype, device=device)
    base_move = torch.as_tensor(np.asarray(base_trial_move), dtype=dtype,
                                device=device)
    widths = torch.sqrt(temps_t)[:, None] * base_move[None, :]   # (K, P)
    eval_logll = make_eval_logll(like_plan, dtype=dtype, device=device)

    def eval_nf(states):
        r = eval_logll(states, temps_t)
        return r["logll_T"], r["fail_states"]

    window = make_window_body(eval_nf, move_plan, widths, temper_freq,
                              do_tempering)

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
    E = len(ensembles)
    if export_paths is None:
        export_paths = [f"CPU{e}-final.pik" for e in range(E)]
    ef0 = ensembles[0].ensemble_fields
    num_iters = ef0["num_iters"]
    checkpoint_freq = ef0.get("checkpoint_freq") or num_iters
    temps = np.asarray(ef0["_T"], dtype=float)
    K = len(temps)
    clock0 = perf_counter()
    for ens, seed in zip(ensembles, seeds):
        ens.ensemble_fields["_rng_seed"] = seed

    states = torch.as_tensor(np.stack(
        [ens.H.states[:, :, max(starting_iter - 1, 0)] for ens in ensembles]),
        dtype=dtype, device=device)
    if need_initial_state:
        logger.info(f"Simulating initial state ({E} ensembles):")
    window = _even_window(num_iters - max(1, starting_iter) + 1,
                          checkpoint_freq)
    kernel = vmap_ensembles(build_mh_kernel(
        like_plan, move_plan, temps, ef0["base_trial_move"],
        ef0.get("temper_freq", 10), ef0["do_parallel_tempering"],
        dtype=dtype, device=device))
    sources = draw_sources or [
        TorchDraws(seed, K, states.shape[2], n_tries(move_plan),
                   move_plan.mu_constraint is not None, dtype, device)
        for seed in seeds]

    carried = (None if need_initial_state
               else _restore_carried_ll(ensembles, K))
    ll = (kernel.init_ll(states) if carried is None
          else torch.as_tensor(carried, dtype=dtype, device=device))
    if need_initial_state:
        ll_diag = torch.diagonal(ll, dim1=1, dim2=2).cpu().numpy()
        for e, ens in enumerate(ensembles):
            ens.H.loglikelihood[:, 0] = ll_diag[e]
        starting_iter = 1

    k = starting_iter
    while k < num_iters:
        n_this = min(window, num_iters - k)
        logger.info(f"Simulating from {k} to {k + n_this} ({E} ensembles)")
        t_win = perf_counter()
        states, ll, swap_att, swap_acc, nfail, hist = kernel.run_window(
            states, ll, k, n_this, sources)
        # one copy to the host per window, for all ensembles
        h_states, h_ll, h_accept = (h.cpu().numpy() for h in hist)
        nfail_h, att_h, acc_h, ll_host = (
            a.cpu().numpy() for a in (nfail, swap_att, swap_acc, ll))
        dt_win = perf_counter() - t_win
        for e in np.nonzero(nfail_h)[0]:
            logger.warning(f"Ensemble {e} window {k}-{k + n_this}: "
                           f"{int(nfail_h[e])} solves failed after "
                           "escalation (rejected as -inf)")
        logger.info(
            f"Window of {n_this} iters x {E} ensembles took {dt_win:.3f} s "
            f"({n_this * K * E / max(dt_win, 1e-9):.1f} walker-steps/s)")
        for e, ens in enumerate(ensembles):
            H = ens.H
            H.states[:, :, k:k + n_this] = h_states[e].transpose(1, 2, 0)
            H.loglikelihood[:, k:k + n_this] = h_ll[e].T
            H.accept[:, k:k + n_this] = h_accept[e].T
            H.swap_attempts += att_h[e]
            H.swap_accept += acc_h[e]
            ens.latest_iter = k + n_this
            ens._carried_ll = ll_host[e]
        k += n_this
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

    logger.info(f"Total walk ({E} ensembles) took {perf_counter() - clock0} s")
    for ens, ep in zip(ensembles, export_paths):
        H = ens.H
        with np.errstate(divide="ignore", invalid="ignore"):
            rate = 100 * H.swap_accept[:-1] / np.maximum(H.swap_attempts[:-1],
                                                         1)
        logger.info(
            f"Swap accept rate: {H.swap_accept} accepted of "
            f"{H.swap_attempts} attempts ({rate} %)")
        ens.checkpoint(os.path.join(ens.ensemble_fields["output_path"], ep))
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
    or a list of per-replica files. ``mesh_shape`` raises
    ``NotImplementedError``: the sharded multi-device walk is not ported.

    kwargs: n_ensembles, seed, seeds, export_paths, dtype (default float32
    on CUDA, float64 on the CPU), irf_dir, refine, hmax, align_outputs,
    scheme, newton_iters, refactor_every, ramp_block, newton_plateau,
    newton_div_tol, escalate, logger_name, trap_signals, draw_source (one
    ensemble only).
    """
    from metrotrpl_tpu_torch.config.data_io import make_dir
    from metrotrpl_tpu_torch.io.logging import start_logging, stop_logging
    from metrotrpl_tpu_torch.ops.convolve import load_irf_tables

    device = resolve_device(device)
    if kwargs.get("mesh_shape"):
        raise NotImplementedError(
            "mesh_shape (the sharded multi-device walk) is not ported yet")
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
