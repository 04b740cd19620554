"""Dense sampler: likelihood map over a random parameter grid.

Counterpart of ``metrotrpl_tpu/inference/dense.py`` (reference
Dense_Sample/dense_sampling.py): the samples are evaluated in chunks of
``chunk`` states through the same ``make_eval_logll`` as the walk, at
temperature 1. On the card a chunk of 512 states x M measurements is one
launch of the float kernel per measurement group, and its flagged rows
one launch of the float64 rung.
"""

import os

import numpy as np
import torch

from metrotrpl_tpu_torch import default_walk_dtype, resolve_device
from metrotrpl_tpu_torch.inference.likelihood import (
    build_likelihood_plan,
    make_eval_logll,
    resolve_solver_mode,
)
from metrotrpl_tpu_torch.tracing import span


def random_grid(min_x, max_x, do_log, num_samples, rng):
    """Draw num_samples points from the box [min_x, max_x], log-uniform on
    the do_log axes (reference dense_sampling.py:15-31)."""
    num_params = len(min_x)
    grid = np.empty((num_samples, num_params))
    for i in range(num_params):
        if min_x[i] == max_x[i]:
            grid[:, i] = min_x[i]
        elif do_log[i]:
            grid[:, i] = 10 ** rng.uniform(
                np.log10(min_x[i]), np.log10(max_x[i]), num_samples)
        else:
            grid[:, i] = rng.uniform(min_x[i], max_x[i], num_samples)
    return grid


def modify_scale_factors(param_info, sim_flags):
    """Replace the (0, inf) default bounds for scale factors with
    init_guess */ trial move spread (reference dense_sampling.py:198-206)."""
    spread = sim_flags["scale_factor"][0]
    for name in param_info["names"]:
        if name.startswith("_s"):
            g = param_info["init_guess"][name]
            param_info["prior_dist"][name] = (g / spread, g * spread)


def bayes(N, P, init_params, sim_params, e_data, sim_flags, param_info,
          logger=None, chunk=512, seed=0, dtype=None, device="cuda"):
    """Run the dense random sweep on ``device``; returns (N, P, X) like the
    reference driver (dense_sampling.py:209-314). X is the grid the JAX
    package draws for the same seed (numpy's generator).

    N and P exist only for reference signature parity and are ignored
    (reallocated below, as in the reference): pass None.
    dtype : the evaluation dtype (default float32 on CUDA, float64 on the
        CPU).
    """
    device = resolve_device(device)
    dtype = dtype or default_walk_dtype(device)
    rng = np.random.default_rng(seed)
    if sim_flags.get("scale_factor", None) is not None:
        modify_scale_factors(param_info, sim_flags)

    names = param_info["names"]
    min_x = np.array([param_info["prior_dist"][n][0]
                      if param_info["active"][n]
                      else param_info["init_guess"][n] for n in names])
    max_x = np.array([param_info["prior_dist"][n][1]
                      if param_info["active"][n]
                      else param_info["init_guess"][n] for n in names])
    do_log = np.array([param_info["do_log"][n] for n in names])

    num_samples = sim_flags["num_iters"]
    X = random_grid(min_x, max_x, do_log, num_samples, rng)
    N = np.arange(num_samples)
    if logger is not None:
        logger.info(f"Initializing {num_samples} random samples")
        logger.info(f"First three samples: {X[:3]}")

    # dense sampler sigma: likel2move_ratio * max trial move
    # (reference dense_sampling.py:246-253)
    flags = dict(sim_flags)
    if "model_uncertainty" not in flags:
        tm = param_info["trial_move"]
        base = max(tm[n] for n in names)
        l2v = flags["likel2move_ratio"]
        if isinstance(l2v, dict):
            flags["model_uncertainty"] = {
                m: base * l2v[m] for m in sim_params["meas_types"]}
        else:
            flags["model_uncertainty"] = base * l2v

    # `Solver name: sdirk` fast-mode policy; 1.0 = the reference dense
    # sampler's hard-coded Grid hmax
    hm, align = resolve_solver_mode(flags, 1.0)
    plan = build_likelihood_plan(
        sim_params, param_info, flags, e_data, init_params,
        irf_tables=flags.get("_IRF_tables"),
        hmax=hm, align_outputs=align,
        refactor_every=int(flags.get("refactor_every", 1)))
    ev = make_eval_logll(plan, dtype=dtype, device=device)
    temps = torch.ones(1, dtype=dtype, device=device)

    P = np.zeros(num_samples)
    for lo in range(0, num_samples, chunk):
        hi = min(lo + chunk, num_samples)
        with span("metrotrpl.dense.chunk"):
            states = torch.as_tensor(X[lo:hi], dtype=dtype, device=device)
            P[lo:hi] = ev(states, temps)["logll_T"][:, 0].cpu().numpy()
        if logger is not None:
            logger.info(f"Calculated {hi} of {num_samples}")
    return N, P, X


def export(out_filename, P, X, logger=None):
    """Write <out>_P.npy / <out>_X.npy (reference dense_sampling.py:317)."""
    head = os.path.dirname(out_filename)
    base = os.path.basename(out_filename)
    os.makedirs(head, exist_ok=True)
    if logger is not None:
        logger.info(f"Writing to {out_filename}:")
    np.save(os.path.join(head, f"{base}_P.npy"), P)
    np.save(os.path.join(head, f"{base}_X.npy"), X)
