"""Trial-move proposal and prior screen (``metrotrpl_tpu/inference/moves.py``).

Log-space uniform displacement, the optional ambipolar-mobility
constraint and the prior screen (bounds, p0 > n0, |log tauN - log tauP|
<= 2). With hard_bounds the reference redraws up to MAX_PROPOSALS times
and keeps the last draw if none passes; here all candidates are drawn at
once and the first approved one is taken (else the last), which is the
same sequence the JAX while loop walks.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from metrotrpl_tpu_torch import pow10
from metrotrpl_tpu_torch.constants import MAX_PROPOSALS


class MovePlan(NamedTuple):
    do_log: np.ndarray       # (P,) bool
    active: np.ndarray       # (P,) bool
    trial_move: np.ndarray   # (P,) base widths, 0 for inactive params
    lb: np.ndarray           # (P,) prior lower bounds (entry units)
    ub: np.ndarray           # (P,)
    p0_idx: int              # -1 if absent
    n0_idx: int
    taun_idx: int
    taup_idx: int
    mu_n_idx: int
    mu_p_idx: int
    mu_constraint: Optional[tuple]   # (center, width) or None
    hard_bounds: bool
    max_proposals: int


def build_move_plan(param_info, MCMC_fields):
    names = list(param_info["names"])
    idx = {n: i for i, n in enumerate(names)}
    active = np.array([bool(param_info["active"][n]) for n in names])
    do_log = np.array([bool(param_info["do_log"][n]) for n in names])
    trial_move = np.array([
        param_info["trial_move"][n] if param_info["active"][n] else 0.0
        for n in names])
    lb = np.array([param_info["prior_dist"][n][0] for n in names])
    ub = np.array([param_info["prior_dist"][n][1] for n in names])
    mu_c = param_info.get("do_mu_constraint",
                          MCMC_fields.get("do_mu_constraint", None))
    if mu_c is not None:
        # the ambipolar substitution works on log10 mobilities
        for mn in ("mu_n", "mu_p"):
            if mn in idx and not do_log[idx[mn]]:
                raise ValueError(
                    f"do_mu_constraint requires do_log[{mn}]=1 (the "
                    "ambipolar substitution operates on log10 mobilities)")
    return MovePlan(
        do_log=do_log,
        active=active,
        trial_move=trial_move,
        lb=lb,
        ub=ub,
        p0_idx=idx.get("p0", -1),
        n0_idx=idx.get("n0", -1),
        taun_idx=idx.get("tauN", -1),
        taup_idx=idx.get("tauP", -1),
        mu_n_idx=idx.get("mu_n", -1),
        mu_p_idx=idx.get("mu_p", -1),
        mu_constraint=tuple(mu_c) if mu_c is not None else None,
        hard_bounds=bool(MCMC_fields.get("hard_bounds", 0)),
        max_proposals=MAX_PROPOSALS,
    )


def n_tries(plan):
    """Candidates drawn per chain and iteration."""
    return plan.max_proposals if plan.hard_bounds else 1


class MoveTensors(NamedTuple):
    """A plan's arrays as tensors on the walk's device, built once by
    :func:`move_tensors`, so that a proposal uploads nothing."""
    do_log: torch.Tensor        # (P,) bool
    active: torch.Tensor        # (P,) bool
    lb: torch.Tensor            # (P,) float64
    ub: torch.Tensor            # (P,) float64
    mu_lo_hi: Optional[tuple]   # the ambipolar mobility's (lo, hi), or None


def move_tensors(plan, dtype, device):
    """The plan's arrays on ``device``; the mu constraint's bounds in the
    walk's ``dtype``."""
    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    mu = None
    if plan.mu_constraint is not None:
        ambi, width = plan.mu_constraint
        mu = (t(ambi - width, dtype), t(ambi + width, dtype))
    return MoveTensors(do_log=t(plan.do_log), active=t(plan.active),
                       lb=t(plan.lb, torch.float64),
                       ub=t(plan.ub, torch.float64), mu_lo_hi=mu)


def approve_move(new_state_t, plan, tensors=None):
    """Prior screen of states in MOVE space (log10 for do_log params),
    vectorized over leading dims: (..., P) -> (...) bool. ``tensors``
    (:func:`move_tensors`) spares the plan's uploads."""
    mt = tensors or move_tensors(plan, new_state_t.dtype, new_state_t.device)
    raw = torch.where(mt.do_log, pow10(new_state_t), new_state_t)
    in_bounds = (mt.lb < raw) & (raw < mt.ub)
    ok = torch.all(torch.where(mt.active, in_bounds, True), dim=-1)

    if plan.p0_idx >= 0 and plan.n0_idx >= 0:
        ok = ok & (new_state_t[..., plan.p0_idx]
                   > new_state_t[..., plan.n0_idx])

    if plan.taun_idx >= 0 and plan.taup_idx >= 0:
        tn = new_state_t[..., plan.taun_idx]
        tp = new_state_t[..., plan.taup_idx]
        logtn = tn if plan.do_log[plan.taun_idx] else torch.log10(tn)
        logtp = tp if plan.do_log[plan.taup_idx] else torch.log10(tp)
        ok = ok & (torch.abs(logtn - logtp) <= 2.0)
    return ok


def make_trial_move(state, move_width, u, u_mu, plan, tensors=None):
    """Propose new states for K chains.

    state (K, P) entry units; move_width (K, P) temperature-scaled
    half-widths; u (T, K, P) and u_mu (T, K) (None without the mu
    constraint) uniform [0, 1) draws for the T = n_tries(plan) candidates.
    ``tensors`` (:func:`move_tensors` on the state's device and dtype)
    spares the plan's uploads.
    Returns (K, P) proposals in entry units; frozen (zero-width)
    parameters keep their exact stored value.
    """
    dev = state.device
    mt = tensors or move_tensors(plan, state.dtype, dev)
    do_log = mt.do_log
    x = torch.where(do_log, torch.log10(state), state)
    new = x[None] + move_width[None] * (2.0 * u - 1.0)          # (T, K, P)
    if plan.mu_constraint is not None:
        lo, hi = mt.mu_lo_hi
        muambi = torch.maximum(lo, u_mu * (hi - lo) + lo)       # (T, K)
        # mu_p from the ambipolar relation 2/mu_ambi = 1/mu_n + 1/mu_p
        mu_p = 1.0 / (2.0 / muambi - 1.0 / pow10(new[..., plan.mu_n_idx]))
        new = new.clone()
        new[..., plan.mu_p_idx] = torch.log10(mu_p)
    ok = approve_move(new, plan, mt)                             # (T, K)
    T = new.shape[0]
    # first approved candidate, else the last one drawn
    first_ok = torch.argmax(ok.to(torch.int32), dim=0)
    pick = torch.where(ok.any(dim=0), first_ok, T - 1)
    chosen = new[pick, torch.arange(new.shape[1], device=dev)]  # (K, P)
    out = torch.where(do_log, pow10(chosen), chosen)
    moved = move_width > 0
    if plan.mu_constraint is not None:
        moved = moved | (torch.arange(len(plan.do_log), device=dev)
                         == plan.mu_p_idx)
    return torch.where(moved, out, state)
