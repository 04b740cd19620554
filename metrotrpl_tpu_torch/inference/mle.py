"""Maximum-likelihood mode: Nelder-Mead over the float64 likelihood.

Counterpart of ``metrotrpl_tpu/inference/mle.py`` (reference
MLE/max_likelihood.py, rebuilt against the port's containers): the cost
is the negative log-likelihood at T=1 of one state, evaluated by the
same ``make_eval_logll`` as the walk, in float64. On the card each call
solves M rows through the float64 instantiation of the solve kernel.
"""

import os

import numpy as np
import torch
from scipy.optimize import minimize

from metrotrpl_tpu_torch import resolve_device
from metrotrpl_tpu_torch.inference.likelihood import (
    build_likelihood_plan,
    make_eval_logll,
    resolve_solver_mode,
)
from metrotrpl_tpu_torch.io.ensemble import Ensemble

DEFAULT_NUM_ITERS = 1000


def mle(e_data, sim_params, param_info, init_params, sim_flags, export_path,
        logger, dtype=torch.float64, method="Nelder-Mead", maxiter=None,
        device="cuda"):
    """Minimize the negative log-likelihood over the active parameters
    (log10 space) on ``device``. Returns the Ensemble holding the
    optimization trace (chain 0: every evaluated state and its logll)."""
    device = resolve_device(device)
    flags = dict(sim_flags)
    if "model_uncertainty" not in flags:
        tm = param_info["trial_move"]
        base = max(tm[n] for n in param_info["names"])
        l2v = flags["likel2move_ratio"]
        if isinstance(l2v, dict):
            flags["model_uncertainty"] = {
                m: base * l2v[m] for m in sim_params["meas_types"]}
        else:
            flags["model_uncertainty"] = base * l2v

    # `Solver name: sdirk` fast-mode policy; 1.0 = the reference MLE's
    # hard-coded Grid hmax
    hm, align = resolve_solver_mode(flags, 1.0)
    plan = build_likelihood_plan(
        sim_params, param_info, flags, e_data, init_params,
        irf_tables=flags.get("_IRF_tables"),
        hmax=hm, align_outputs=align,
        refactor_every=int(flags.get("refactor_every", 1)))
    ev = make_eval_logll(plan, dtype=dtype, device=device)
    temps = torch.ones(1, dtype=dtype, device=device)

    names = param_info["names"]
    active = np.array([bool(param_info["active"][n]) for n in names])
    full0 = np.array([param_info["init_guess"][n] for n in names],
                     dtype=float)
    x0 = np.log10(full0[active])

    ens = Ensemble(param_info, sim_params, dict(sim_flags), DEFAULT_NUM_ITERS)
    H = ens.H
    trace = {"k": 1}

    def cost(x):
        full = full0.copy()
        full[active] = 10.0 ** x
        state = torch.as_tensor(full[None], dtype=dtype, device=device)
        ll = float(ev(state, temps)["logll_T"][0, 0])
        k = trace["k"]
        if k >= H.accept.shape[1]:
            H.extend(2 * H.accept.shape[1])
        H.states[0, :, k] = full
        H.loglikelihood[0, k] = ll
        if logger is not None:
            logger.info(f"Iter {k} Cost: {-ll}")
        trace["k"] = k + 1
        return -ll

    options = {}
    if maxiter is not None:
        options["maxiter"] = maxiter
    opt = minimize(cost, x0, method=method, options=options)
    if logger is not None:
        logger.info(f"MLE result: {10.0 ** opt.x}")
        logger.info(f"final logll {-opt.fun}")
        logger.info(opt.message)

    H.truncate(trace["k"])
    ens.latest_iter = trace["k"]
    if export_path is not None:
        out_dir = ens.ensemble_fields["output_path"]
        os.makedirs(out_dir, exist_ok=True)
        ens.checkpoint(os.path.join(out_dir, export_path))
    return ens
