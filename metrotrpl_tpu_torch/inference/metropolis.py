"""Metropolis-Hastings walk with parallel tempering (single ensemble).

Counterpart of ``metrotrpl_tpu/inference/metropolis.py``: :func:`metro`
builds the plans from the parsed config and data, :func:`run_mh` drives
checkpoint windows of :func:`build_mh_kernel`'s window function, copies
each window's states / log-likelihoods / accepts to the host History
once, and writes checkpoints that the reference GUI and both packages'
``io.ensemble.load_checkpoint`` load.

The escalation ladder runs inline in every evaluation. The JAX package
defers it (it re-runs a failing window through an inline-escalation
kernel, because an untaken ``lax.cond`` is costly on a TPU); its re-run
reproduces the inline window exactly (JAX metropolis.py:707-712), so the
walk's semantics are the same.
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
    init_ll: callable         # states -> ll_T (K, K)


def build_mh_kernel(like_plan, move_plan, temps, base_trial_move, temper_freq,
                    do_tempering, dtype=torch.float64, device="cuda"):
    """The MH window function on ``device``.

    temps : (K,) tempering temperatures (one chain per temperature).
    base_trial_move : (P,) per-parameter move widths (0 = frozen).
    """
    device = resolve_device(device)
    K = len(temps)
    temps_t = torch.as_tensor(np.asarray(temps), dtype=dtype, device=device)
    base_move = torch.as_tensor(np.asarray(base_trial_move), dtype=dtype,
                                device=device)
    widths = torch.sqrt(temps_t)[:, None] * base_move[None, :]   # (K, P)
    eval_logll = make_eval_logll(like_plan, dtype=dtype, device=device)

    def eval_nf(states):
        r = eval_logll(states, temps_t)
        return r["logll_T"], r["n_solver_fail"]

    window = make_window_body(eval_nf, move_plan, widths, temper_freq,
                              do_tempering)
    return MHKernel(run_window=window,
                    init_ll=lambda states: eval_nf(states)[0])


def _restore_carried_ll(ensemble, K):
    """The (K, K) ll matrix carried at checkpoint time, or None."""
    m = getattr(ensemble, "_carried_ll", None)
    if m is None or np.shape(m) != (K, K):
        return None
    return np.asarray(m)


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


def run_mh(ensemble, like_plan, move_plan, logger, seed=235817049752375780,
           export_path="", dtype=torch.float64, device="cuda",
           starting_iter=0, need_initial_state=True, draw_source=None):
    """Host loop: checkpoint windows of iterations (reference metro()
    loop structure, metropolis.py:373-463).

    ensemble : metrotrpl_tpu_torch.io.ensemble.Ensemble (mutated in place).
    draw_source : replaces the production :class:`TorchDraws` (tests).
    """
    device = resolve_device(device)
    ef = ensemble.ensemble_fields
    num_iters = ef["num_iters"]
    checkpoint_freq = ef.get("checkpoint_freq") or num_iters
    temps = np.asarray(ef["_T"], dtype=float)
    K = len(temps)
    clock0 = perf_counter()
    ef["_rng_seed"] = seed

    H = ensemble.H
    states = torch.as_tensor(H.states[:, :, max(starting_iter - 1, 0)].copy(),
                             dtype=dtype, device=device)
    if need_initial_state:
        logger.info("Simulating initial state:")
    window = _even_window(num_iters - max(1, starting_iter) + 1,
                          checkpoint_freq)
    kernel = build_mh_kernel(
        like_plan, move_plan, temps, ef["base_trial_move"],
        ef.get("temper_freq", 10), ef["do_parallel_tempering"],
        dtype=dtype, device=device)
    source = draw_source or TorchDraws(
        seed, K, states.shape[1], n_tries(move_plan),
        move_plan.mu_constraint is not None, dtype, device)

    carried = None if need_initial_state else _restore_carried_ll(ensemble, K)
    ll_T = (kernel.init_ll(states) if carried is None
            else torch.as_tensor(carried, dtype=dtype, device=device))
    if need_initial_state:
        H.loglikelihood[:, 0] = torch.diagonal(ll_T).cpu().numpy()
        starting_iter = 1

    k = starting_iter
    while k < num_iters:
        n_this = min(window, num_iters - k)
        logger.info(f"Simulating from {k} to {k + n_this}")
        t_win = perf_counter()
        states, ll_T, swap_att, swap_acc, nfail, hist = kernel.run_window(
            states, ll_T, k, n_this, source)
        h_states, h_ll, h_accept = (h.cpu().numpy() for h in hist)
        n_fail = int(nfail)
        dt_win = perf_counter() - t_win
        if n_fail:
            logger.warning(f"Window {k}-{k + n_this}: {n_fail} solves "
                           "failed after escalation (rejected as -inf)")
        logger.info(
            f"Window of {n_this} iters took {dt_win:.3f} s "
            f"({n_this * K / max(dt_win, 1e-9):.1f} walker-steps/s)")
        H.states[:, :, k:k + n_this] = h_states.transpose(1, 2, 0)
        H.loglikelihood[:, k:k + n_this] = h_ll.T
        H.accept[:, k:k + n_this] = h_accept.T
        H.swap_attempts += swap_att.cpu().numpy()
        H.swap_accept += swap_acc.cpu().numpy()
        k += n_this
        ensemble.latest_iter = k
        ensemble._carried_ll = ll_T.cpu().numpy()
        if k < num_iters:
            logger.info(f"Saving checkpoint at k={k}")
            ensemble.checkpoint(os.path.join(ef["output_path"], export_path))
        if k % MSG_FREQ < window:
            for m in range(K):
                logger.info(
                    f"Iter {k} chain {m} state: {H.states[m, :, k - 1]} "
                    f"logll {H.loglikelihood[m, k - 1]}")

    with np.errstate(divide="ignore", invalid="ignore"):
        rate = 100 * H.swap_accept[:-1] / np.maximum(H.swap_attempts[:-1], 1)
    logger.info(
        f"Swap accept rate: {H.swap_accept} accepted of "
        f"{H.swap_attempts} attempts ({rate} %)")
    logger.info(f"Total walk took {perf_counter() - clock0} s")
    ensemble.checkpoint(os.path.join(ef["output_path"], export_path))
    return ensemble


def _resume_starting_iter(ensemble, MCMC_fields, num_iters):
    """Rewind/extend a loaded checkpoint to continue to ``num_iters``;
    returns the starting iteration (reference metropolis.py:342-353)."""
    latest = ensemble.latest_iter
    if ("starting_iter" in MCMC_fields
            and MCMC_fields["starting_iter"] < latest):
        start = MCMC_fields["starting_iter"]
    else:
        start = min(latest, num_iters)
    if start != ensemble.latest_iter:
        ensemble._carried_ll = None   # belongs to a later state
    ensemble.H.extend(start)
    ensemble.H.extend(num_iters)
    ensemble.ensemble_fields["num_iters"] = num_iters
    ensemble.latest_iter = start
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
    signature), single ensemble. Builds plans from the parsed config and
    data, runs the walk on ``device``, writes GUI-loadable checkpoints.

    kwargs: seed, dtype (default float32 on CUDA, float64 on the CPU),
    irf_dir, refine, hmax, align_outputs, scheme, newton_iters,
    refactor_every, ramp_block, newton_plateau, newton_div_tol,
    escalate, logger_name, trap_signals, draw_source.
    """
    from metrotrpl_tpu_torch.config.data_io import make_dir
    from metrotrpl_tpu_torch.io.logging import start_logging, stop_logging
    from metrotrpl_tpu_torch.ops.convolve import load_irf_tables

    device = resolve_device(device)
    if int(kwargs.get("n_ensembles", 1)) != 1 or kwargs.get("mesh_shape"):
        raise NotImplementedError(
            "n_ensembles > 1 and mesh_shape are not yet ported")
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
        ensemble = Ensemble(param_info, sim_info, MCMC_fields, num_iters,
                            verbose)
        need_initial_state = True
    else:
        ensemble = load_checkpoint(
            os.path.join(MCMC_fields["output_path"], load_ckpt))
        starting_iter = _resume_starting_iter(ensemble, MCMC_fields,
                                              num_iters)
        need_initial_state = False

    ef = ensemble.ensemble_fields
    irf_tables = {}
    if ef.get("irf_convolution", None) is not None:
        irf_tables = load_irf_tables(ef["irf_convolution"],
                                     kwargs.get("irf_dir", "IRFs"))
    ef["_init_params"] = iniPar
    ef["_times"], ef["_vals"], ef["_uncs"] = e_data
    ef["_IRF_tables"] = irf_tables
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
    dtype = kwargs.get("dtype") or default_walk_dtype(device)
    logger.info(f"Walk dtype: {dtype}, device: {device}")
    try:
        run_mh(ensemble, like_plan, move_plan, logger, seed=seed,
               export_path=export_path, dtype=dtype, device=device,
               starting_iter=starting_iter,
               need_initial_state=need_initial_state,
               draw_source=kwargs.get("draw_source"))
    except KeyboardInterrupt:
        logger.warning(
            f"Interrupted at iteration {ensemble.latest_iter}; truncating "
            "history and writing the final checkpoint")
        ensemble.H.truncate(max(ensemble.latest_iter, 1))
        ensemble.checkpoint(os.path.join(ef["output_path"], export_path))
        stop_logging(logger, handler, 1)
        return ensemble
    stop_logging(logger, handler, 0)
    return ensemble
