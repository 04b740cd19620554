"""Batched forward simulation.

Counterpart of ``metrotrpl_tpu/solver/forward.py``. The plan functions
(:func:`refine_for_tols`, :class:`ForwardPlan`, :func:`make_forward_plan`)
are host numpy copies of the JAX module's, which imports jax at its top;
tests hold every plan field equal to the JAX plan's.
:func:`solve_forward_batch` advances a whole batch of simulations through
``integrate_observables_cuda`` — the CUDA kernel for CUDA tensors, its
plain PyTorch version for CPU tensors.
"""

import logging
from typing import NamedTuple

import numpy as np
import torch

from metrotrpl_tpu_torch import resolve_device
from metrotrpl_tpu_torch.physics.grid import (
    make_space_grid,
    pad_time_grid,
    plan_time_grid,
)
from metrotrpl_tpu_torch.physics.models import (
    initial_state,
    make_scaled_params,
    observable_multipliers,
)
from metrotrpl_tpu_torch.solver.solve_kernel import integrate_observables_cuda

# Measured global relative accuracy of the log10 observables at refine=1,
# hmax<=4 on the staub workload (BASELINE.md "Accuracy vs LSODA"): ~2e-6.
# sdirk3 is 3rd order, so `refine` scales this by refine^-3.
BASE_GLOBAL_RERR = 2e-6


def refine_for_tols(rtol, atol=None, n_steps=500, logger=None):
    """Map the config's LSODA-style rtol/atol onto the fixed-step scheme's
    ``refine`` factor, clamped to [1, 4] (see the JAX twin)."""
    if rtol is None:
        return 1
    target = float(rtol) * np.sqrt(max(int(n_steps), 1))
    refine = max(1, int(np.ceil(np.cbrt(BASE_GLOBAL_RERR / target))))
    if refine > 4:
        if logger is not None:
            logger.warning(
                f"Solver rtol={rtol} requests refine={refine}; clamping to "
                "4 (finest validated fixed-step grid). Expected global "
                f"accuracy ~{BASE_GLOBAL_RERR / 64:.1e}.")
        refine = 4
    if logger is not None:
        logger.info(
            f"Solver rtol={rtol} -> fixed-step refine={refine} (measured "
            f"global err {BASE_GLOBAL_RERR:.0e} at refine=1, 3rd-order "
            "scheme). atol is subsumed by the O(1) state rescaling.")
        if atol is not None and float(atol) > float(rtol):
            logger.warning(
                f"Solver atol={atol} > rtol={rtol}: the fixed-step scheme "
                "treats tolerances relatively; atol is ignored.")
    return refine


class ForwardPlan(NamedTuple):
    """Static per-measurement solve plan (host-side numpy); field for
    field the JAX ``ForwardPlan``."""
    nx: int
    n_steps: int
    nt: int
    model: str
    scheme: str
    newton_iters: int
    dx: np.ndarray          # (M,)
    x_centers: np.ndarray   # (M, nx) cell centers [nm]
    dt: np.ndarray          # (M, n_steps) step sizes [ns]
    out_idx: np.ndarray     # (M, nt) knot index per output time
    out_mask: np.ndarray    # (M, nt) True where the output slot is real
    is_trpl: np.ndarray     # (M,) True for TRPL, False for TRTS
    nt_actual: np.ndarray   # (M,) true number of output points
    out_w: np.ndarray = None  # (M, nt) right-knot lerp weight (None when
                              # outputs are knot-aligned)
    n_ramp: int = None      # chord-mode phase boundary
    refactor_every: int = 1  # Newton-matrix refactor period past n_ramp
    ramp_block: int = 1     # refactor period inside the ramp
    newton_plateau: int = None  # Newton iterations per stage past n_ramp
    solve_dtype: str = None     # solve in this dtype whatever the walk's
                                # ("float64" = the escalation rung)


def make_forward_plan(lengths, nxes, meas_types, times_list, hmax=4.0,
                      model="std", scheme="sdirk3", newton_iters=2,
                      h0=1e-3, growth=1.25, refine=1, align_outputs=True,
                      refactor_every=1, tail_growth=1.0, tail_block=1,
                      ramp_block=1, newton_plateau=None):
    """Build a :class:`ForwardPlan` for a measurement set (the JAX twin's
    docstring has the details). All nx must be equal."""
    nxes = list(nxes)
    if len(set(int(n) for n in nxes)) != 1:
        raise NotImplementedError(
            "Batched solver currently requires a common nx across measurements"
        )
    nx = int(nxes[0])
    grids = [plan_time_grid(t, hmax=hmax, h0=h0, growth=growth, refine=refine,
                            align_outputs=align_outputs,
                            tail_growth=tail_growth, tail_block=tail_block,
                            ramp_block=ramp_block)
             for t in times_list]
    n_steps = max(len(g.dt) for g in grids)
    nt = max(len(g.out_idx) for g in grids)

    if newton_plateau is not None and int(newton_plateau) == int(newton_iters):
        newton_plateau = None
    n_ramp = None
    if refactor_every > 1 or ramp_block > 1 or newton_plateau is not None:
        # chord-mode phase boundary: the first step index from which every
        # row's dt is constant (padding repeats the last dt, preserving it)
        dtm = np.stack([np.concatenate(
            [g.dt, np.full(n_steps - len(g.dt), g.dt[-1])]) for g in grids])
        changed = np.abs(np.diff(dtm, axis=1)) > 1e-12 * dtm[:, 1:]
        any_changed = np.any(changed, axis=0)
        n_ramp = (int(np.max(np.nonzero(any_changed)[0])) + 2
                  if any_changed.any() else 0)
        if n_ramp >= n_steps:
            logging.getLogger("MCMC").warning(
                "refactor_every=%d requested but the step grid has no "
                "constant-dt plateau%s; refactorizing every step.",
                int(refactor_every),
                (" (stepped-geometric tail_growth=%g keeps dt changing "
                 "blockwise to t_final)" % tail_growth
                 if tail_growth and tail_growth > 1.0 else ""))
            n_ramp = None
            ramp_block = 1
            newton_plateau = None
        else:
            if ramp_block > 1:
                # every dt change must land on a ramp-block boundary
                R = int(ramp_block)
                starts = np.nonzero(any_changed)[0] + 1
                n_ramp_b = n_ramp + (-n_ramp) % R
                if np.all(starts % R == 0) and n_ramp_b <= n_steps:
                    n_ramp = n_ramp_b
                else:
                    logging.getLogger("MCMC").warning(
                        "ramp_block=%d requested but the step grid's dt "
                        "changes do not align to block boundaries "
                        "(output-aligned grid or truncated ramp); "
                        "refactorizing every ramp step.", R)
                    ramp_block = 1
            # round the plateau up to a multiple of the refactor period
            n_steps += (-(n_steps - n_ramp)) % int(refactor_every)

    padded = [pad_time_grid(g, n_steps, nt) for g in grids]

    space = [make_space_grid(th, nx) for th in lengths]
    nt_actual = np.array([len(t) for t in times_list])
    out_mask = np.arange(nt)[None, :] < nt_actual[:, None]

    return ForwardPlan(
        nx=nx,
        n_steps=n_steps,
        nt=nt,
        model=model,
        scheme=scheme,
        newton_iters=newton_iters,
        dx=np.array([g.dx for g in space]),
        x_centers=np.stack([g.x_centers for g in space]),
        dt=np.stack([g.dt for g in padded]),
        out_idx=np.stack([g.out_idx for g in padded]),
        out_mask=out_mask,
        is_trpl=np.array([m == "TRPL" for m in meas_types]),
        nt_actual=nt_actual,
        out_w=(None if align_outputs
               else np.stack([g.out_w for g in padded])),
        n_ramp=n_ramp,
        refactor_every=int(refactor_every),
        ramp_block=int(ramp_block),
        newton_plateau=(None if newton_plateau is None
                        else int(newton_plateau)),
    )


def _interp_knots(obs, out_idx, w):
    """Interpolate per-knot observables (B, n_steps+1) onto output times:
    log-space between two positive knots (exact for exponential decay),
    linear otherwise."""
    lo = torch.gather(obs, 1, out_idx)
    hi = torch.gather(obs, 1, out_idx + 1)
    lin = lo + w * (hi - lo)
    both_pos = (lo > 0) & (hi > 0)
    safe_lo = torch.where(both_pos, lo, 1.0)
    safe_hi = torch.where(both_pos, hi, 1.0)
    geo = safe_lo * torch.exp(w * torch.log(safe_hi / safe_lo))
    return torch.where(both_pos, geo, lin)


def prepare_batch(init_dN, raw_params, dx, dt, model="std"):
    """Kernel inputs of a batch: (ScaledParams with (B, 1) fields, y0
    (B, C, nx), dts (n_steps, B), ns (B,)), all in init_dN's dtype. The
    per-row density scale ns keeps the state O(1)."""
    dtype = init_dN.dtype
    ns = torch.amax(init_dN, dim=-1) + raw_params["p0"] + raw_params["n0"]
    p = make_scaled_params(raw_params, dx, ns)
    p = type(p)(*(a.to(dtype)[..., None] for a in p))
    y0 = initial_state(init_dN, ns[..., None], model=model, dtype=dtype)
    dts = dt.to(dtype).T.contiguous()             # (n_steps, B)
    return p, y0, dts, ns


def solve_forward_batch(init_dN, raw_params, dx, dt, out_idx, is_trpl,
                        model="std", scheme="sdirk3", newton_iters=2,
                        min_y=None, out_w=None, refactor_every=1, n_ramp=None,
                        ramp_block=1, newton_plateau=None, with_diag=False):
    """Run a batch of forward simulations; return observables in
    measurement units (TRPL or TRTS per row) on the output grid.

    Shapes (B = batch), all tensors on one device:
    init_dN (B, nx) [nm^-3]; raw_params name -> (B,); dx (B,);
    dt (B, n_steps); out_idx (B, nt) int64; is_trpl (B,) bool;
    out_w (B, nt) optional right-knot weights (interpolated outputs).

    Returns sol (B, nt), held at min_y (default: the dtype's tiny) from
    the first point below it on (reference forward_solver.py:190-201).
    with_diag also returns the per-row max |last Newton update| over every
    knot an output sample can read (NaN-propagating).
    """
    p, y0, dts, ns = prepare_batch(init_dN, raw_params, dx, dt, model)
    return solve_prepared(p, y0, dts, dx.to(init_dN.dtype), ns, raw_params,
                          out_idx, is_trpl, model=model, scheme=scheme,
                          newton_iters=newton_iters, min_y=min_y,
                          out_w=out_w, refactor_every=refactor_every,
                          n_ramp=n_ramp, ramp_block=ramp_block,
                          newton_plateau=newton_plateau, with_diag=with_diag)


def solve_prepared(p, y0, dts, dx, ns, raw_params, out_idx, is_trpl,
                   model="std", scheme="sdirk3", newton_iters=2, min_y=None,
                   out_w=None, refactor_every=1, n_ramp=None, ramp_block=1,
                   newton_plateau=None, with_diag=False):
    """:func:`solve_forward_batch` from :func:`prepare_batch`'s kernel
    inputs (p, y0, dts, ns) and dx in their dtype; raw_params, out_idx,
    is_trpl and out_w as there."""
    dtype = y0.dtype
    pl_t, trts_t, resid_t = integrate_observables_cuda(
        p, y0, dts, dx, model=model, scheme_name=scheme,
        newton_iters=newton_iters, refactor_every=refactor_every,
        n_ramp=n_ramp, ramp_block=ramp_block, newton_plateau=newton_plateau)

    if out_w is None:
        pl_out = torch.gather(pl_t.T, 1, out_idx)
        trts_out = torch.gather(trts_t.T, 1, out_idx)
    else:
        w = out_w.to(dtype)
        pl_out = _interp_knots(pl_t.T, out_idx, w)
        trts_out = _interp_knots(trts_t.T, out_idx, w)

    pl_mult, trts_mult = observable_multipliers(raw_params, ns)
    sol = torch.where(is_trpl[:, None], pl_out * pl_mult[:, None],
                      trts_out * trts_mult[:, None])

    if min_y is None:
        min_y = float(torch.finfo(dtype).tiny)
    below = sol < min_y
    # argmax over an integer mask: CUDA argmax does not take bool in every
    # torch version; the first True is the first maximum
    first = torch.argmax(below.to(torch.int32), dim=1)
    do_clamp = torch.gather(below, 1, first[:, None])
    tail = torch.arange(sol.shape[1], device=sol.device)[None, :] \
        >= first[:, None]
    sol = torch.where(tail & do_clamp, min_y, sol)
    if not with_diag:
        return sol
    # padded-tail steps past a row's real window integrate post-decay
    # garbage by design and must not flag the row
    kmax = torch.amax(out_idx, dim=1) + (0 if out_w is None else 1)
    knots = torch.arange(resid_t.shape[0], device=sol.device)[None, :]
    r = torch.where(knots <= kmax[:, None], resid_t.T, 0.0)
    return sol, torch.amax(r, dim=1)


def solve_single(init_dN, raw_params, thickness, nx, t_out, meas="TRPL",
                 model="std", hmax=4.0, scheme="sdirk3", newton_iters=2,
                 dtype=torch.float64, device="cuda", refine=1, h0=1e-3,
                 growth=1.25, align_outputs=True, refactor_every=1,
                 tail_growth=1.0, tail_block=1, ramp_block=1,
                 newton_plateau=None):
    """Convenience single-simulation solve on ``device``; returns a numpy
    curve."""
    device = resolve_device(device)
    plan = make_forward_plan(
        [thickness], [nx], [meas], [np.asarray(t_out)], hmax=hmax,
        model=model, scheme=scheme, newton_iters=newton_iters, refine=refine,
        h0=h0, growth=growth, align_outputs=align_outputs,
        refactor_every=refactor_every,
        tail_growth=tail_growth, tail_block=tail_block,
        ramp_block=ramp_block, newton_plateau=newton_plateau)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    sol = solve_forward_batch(
        t(init_dN)[None],
        {k: t([v]) for k, v in raw_params.items()},
        t(plan.dx), t(plan.dt), t(plan.out_idx, torch.int64),
        t(plan.is_trpl, torch.bool),
        model=model, scheme=scheme, newton_iters=newton_iters,
        out_w=None if plan.out_w is None else t(plan.out_w),
        refactor_every=plan.refactor_every, n_ramp=plan.n_ramp,
        ramp_block=plan.ramp_block, newton_plateau=plan.newton_plateau)
    return sol[0].cpu().numpy()
