"""Tempered Gaussian log-likelihood of parameter states.

Counterpart of the JAX package's ``inference/likelihood.py``.
:func:`build_likelihood_plan` builds the host numpy plan, field for field
as the JAX one does, for each kind: ``pde`` (the forward solve), ``nn``
(the surrogate of ``surrogate.py``) and ``pa`` (a toy potential).
For the ``pde`` kind :func:`make_eval_logll` expands K states into the
(K * M) simulation batch, solves it, runs the escalation ladder and the
comparison pipeline, and returns the log-likelihood of every state at
every temperature; the ``nn`` kind runs the same comparison pipeline on
the surrogate's curves, and neither it nor ``pa`` launches a kernel.

The ladder runs inline: rows that need repair are solved again on the
escalation plan (on the card: the float64 instantiation of the same CUDA
kernel) and copied back. Rows are independent, so this equals the JAX
"solve every row, then select" (likelihood.py:868-874). Its one host
sync, on the number of rows to repair, splits the evaluation into fixed-
shape parts (:class:`LadderEval`): before it, the rung's inputs are made
for every row with the rows to repair first, so that after it the rung
launches on their prefix.
"""

import copy
import functools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from metrotrpl_tpu_torch import pow10, resolve_device
from metrotrpl_tpu_torch.constants import NEGATIVE_FRAC_TOL
from metrotrpl_tpu_torch.ops.convolve import convolve_moments
from metrotrpl_tpu_torch.ops.interp import interp1d
from metrotrpl_tpu_torch.physics.models import beer_lambert
from metrotrpl_tpu_torch.solver.forward import (
    make_forward_plan,
    prepare_batch,
    solve_forward_batch,
    solve_prepared,
)
from metrotrpl_tpu_torch.solver.sdirk import NEWTON_DAMP
from metrotrpl_tpu_torch.tracing import span

#: coarse-grid Newton-divergence threshold (see the JAX twin's calibration)
NEWTON_DIV_TOL = 0.1

#: mobility escalation trigger, model units (= 40 cm^2/(V s))
ESCALATE_MU_MODEL = 40.0 * 1e5

#: escalation gate: a flagged row is repaired only when its fast solve's
#: mean squared log10 distance to the data is below this [decades^2]
ESCALATE_GATE_SCORE = 0.25

#: the span of building a plan and of making its evaluator's tensors
_BUILD_SPAN = "metrotrpl.likelihood.build"

#: measurement-parameter names the forward model reads, in plan order
_RAW_NAMES = ("n0", "p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Sf", "Sb",
              "tauN", "tauP", "eps", "Tm", "kC", "Nt", "tauE")


def newton_div_tol_default(nx_max):
    """nx-aware default of the Newton-divergence threshold."""
    return 0.5 if nx_max >= 96 else (NEWTON_DIV_TOL if nx_max <= 64
                                     else 0.3)


def search_c_grps(c_grps, i):
    """First member of the constraint group containing i, else i."""
    for grp in c_grps or []:
        if i in grp:
            return grp[0]
    return i


class LikelihoodPlan(NamedTuple):
    """Static data for batched likelihood evaluation (host numpy); field
    for field the JAX ``LikelihoodPlan``."""
    kind: str                   # "pde" | "pa" | "nn"
    fwd: Optional[tuple]        # ((meas idx, ForwardPlan, escalation plan),
                                # ...) for "pde", else None
    n_meas: int
    n_params: int
    param_names: tuple
    units: np.ndarray
    param_idx: dict
    exp_times: np.ndarray
    exp_vals: np.ndarray
    exp_uncs: np.ndarray
    exp_mask: np.ndarray
    sigma: np.ndarray
    scale_idx: np.ndarray
    fluence_idx: np.ndarray
    absp_idx: np.ndarray
    ini_mode: str
    init_profiles: np.ndarray
    has_irf: np.ndarray
    irf_tables: np.ndarray
    res_t: np.ndarray
    n_conv: np.ndarray
    force_min_y: bool
    log_y: bool
    nn: object = None           # the surrogate.NeuralNetwork of "nn"
    thickness: np.ndarray = None
    newton_div_tol: Optional[float] = None
    esc_gate_score: float = ESCALATE_GATE_SCORE


def _resolve_newton_div_tol(v):
    """A user newton_div_tol at or above the damping cap could never flag;
    clamp it to half the cap (None = per-group default, inf = off)."""
    if v is None:
        return None
    v = float(v)
    if np.isinf(v):
        return v
    if v >= NEWTON_DAMP:
        clamped = 0.5 * float(NEWTON_DAMP)
        logging.getLogger("MCMC").warning(
            "newton_div_tol=%g >= the Newton damping cap %g would never "
            "flag a diverged solve (damped residuals pin at the cap); "
            "clamping to %g.", v, float(NEWTON_DAMP), clamped)
        return clamped
    return v


def _fittable_index_map(spec, n_meas, param_idx, base):
    """Per-measurement state index of the shared fittable parameter."""
    out = np.full(n_meas, -1, dtype=np.int64)
    if spec is None:
        return out
    _, inds, c_grps, _ = spec
    for i in inds:
        name = f"{base}{search_c_grps(c_grps, int(i))}"
        out[int(i)] = param_idx[name]
    return out


def resolve_solver_mode(MCMC_fields, default_hmax, hmax=None,
                        align_outputs=None):
    """`Solver name: sdirk` fast-mode policy: returns (hmax,
    align_outputs); see the JAX twin."""
    fast = (MCMC_fields.get("solver") or ("solveivp",))[0] == "sdirk"
    if align_outputs is None:
        align_outputs = not fast
    if hmax is None:
        hmax = MCMC_fields.get("hmax", 16.0 if fast else default_hmax)
    if hmax == 0:
        logging.getLogger("MCMC").warning(
            "Solver hmax=0 (adaptive 'no step limit' sentinel) is not "
            "representable in the fixed-step scheme; using hmax=%s.",
            16.0 if fast else default_hmax)
        hmax = 16.0 if fast else default_hmax
    return hmax, align_outputs


def _build_span(fn):
    """fn inside a ``metrotrpl.likelihood.build`` span, recorded with or
    without a profiler."""
    @functools.wraps(fn)
    def build(*args, **kwargs):
        with span(_BUILD_SPAN, always=True):
            return fn(*args, **kwargs)
    return build


@_build_span
def build_likelihood_plan(sim_info, param_info, MCMC_fields, e_data, iniPar,
                          irf_tables=None, hmax=None, scheme="sdirk3",
                          newton_iters=2, refine=1, escalate=True,
                          align_outputs=True, refactor_every=1,
                          h0=1e-3, growth=1.25, ramp_block=1,
                          newton_plateau=None, newton_div_tol=None,
                          allow_f64=True):
    """Assemble the static likelihood plan from parsed config + data.

    allow_f64 : whether the float64 escalation rung is available (the JAX
        twin reads ``jax_enable_x64`` here); the port always has it.
    """
    n_meas = sim_info["num_meas"]
    meas_types = sim_info["meas_types"]
    names = list(param_info["names"])
    n_params = len(names)
    param_idx = {n: i for i, n in enumerate(names)}
    units = np.array(
        [param_info["unit_conversions"].get(n, 1) for n in names], dtype=float)

    times, vals, uncs = e_data
    solver_spec = MCMC_fields.get("solver", ("solveivp",))
    if any(m == "pa" for m in meas_types):
        if not all(m == "pa" for m in meas_types):
            raise NotImplementedError("Mixed pa + PDE measurements unsupported")
        kind = "pa"
    elif solver_spec and solver_spec[0] == "NN":
        if any(m != "TRPL" for m in meas_types):
            raise NotImplementedError("NN surrogate supports TRPL only")
        kind = "nn"
    else:
        kind = "pde"

    nt_exp = max(len(t) for t in times)
    exp_times = np.zeros((n_meas, nt_exp))
    exp_vals = np.zeros((n_meas, nt_exp))
    exp_uncs = np.ones((n_meas, nt_exp))
    exp_mask = np.zeros((n_meas, nt_exp), dtype=bool)
    for m in range(n_meas):
        k = len(times[m])
        exp_times[m, :k] = times[m]
        if k < nt_exp:
            last = times[m][-1] if k else 0.0
            exp_times[m, k:] = last + 1.0 + np.arange(nt_exp - k)
        exp_vals[m, :k] = vals[m]
        exp_uncs[m, :k] = uncs[m]
        exp_mask[m, :k] = True

    sigma_spec = MCMC_fields.get("model_uncertainty")
    if sigma_spec is None:
        tm = param_info["trial_move"]
        base_move = max(
            tm[n] if param_info["active"][n] else 0 for n in names)
        l2v = MCMC_fields["likel2move_ratio"]
        if not isinstance(l2v, dict):
            l2v = {m: l2v for m in set(meas_types)}
        missing = set(meas_types) - set(l2v)
        if missing:
            raise ValueError(
                "likel2move_ratio missing measurement type(s) "
                f"{sorted(missing)}: provide one value per type in "
                f"{sorted(set(meas_types))}")
        sigma_spec = {m: base_move * l2v[m] for m in set(meas_types)}
    if isinstance(sigma_spec, dict):
        missing = set(meas_types) - set(sigma_spec)
        if missing:
            raise ValueError(
                "model_uncertainty missing measurement type(s) "
                f"{sorted(missing)}: provide one value per type in "
                f"{sorted(set(meas_types))}")
        sigma = np.array([sigma_spec[m] for m in meas_types], dtype=float)
    else:
        sigma = np.full(n_meas, float(sigma_spec))

    scale_idx = _fittable_index_map(
        MCMC_fields.get("scale_factor"), n_meas, param_idx, "_s")
    fluence_idx = _fittable_index_map(
        MCMC_fields.get("fittable_fluences"), n_meas, param_idx, "_f")
    absp_idx = _fittable_index_map(
        MCMC_fields.get("fittable_absps"), n_meas, param_idx, "_a")

    fwd = None
    has_irf = np.zeros(n_meas, dtype=bool)
    irf_mats = np.zeros((n_meas, 1, 3))
    res_t = np.zeros((n_meas, 3))
    n_conv = np.zeros(n_meas, dtype=np.int64)

    if kind == "pde":
        # forward-solve groups: measurements sharing an nx batch together
        nx_list = [int(n) for n in sim_info["nx"]]
        if MCMC_fields["ini_mode"] == "density" and len(set(nx_list)) > 1:
            raise NotImplementedError(
                "density-mode initial profiles require a uniform nx")
        hm = hmax if hmax is not None else MCMC_fields.get("hmax", 4.0)
        if hm == 0:
            hm = 4.0
        fwd = []
        for nx_val in sorted(set(nx_list)):
            idx = np.array([m for m in range(n_meas)
                            if nx_list[m] == nx_val])

            def _mk(r, chord=True, hm_x=None):
                return make_forward_plan(
                    [sim_info["lengths"][m] for m in idx],
                    [nx_val] * len(idx),
                    [meas_types[m] for m in idx],
                    [times[m] for m in idx],
                    hmax=(hm if hm_x is None else hm_x),
                    model=MCMC_fields["model"], scheme=scheme,
                    newton_iters=newton_iters, refine=r,
                    align_outputs=align_outputs,
                    refactor_every=(refactor_every if chord else 1),
                    h0=h0, growth=growth,
                    ramp_block=(ramp_block if chord else 1),
                    newton_plateau=(newton_plateau if chord else None))
            # escalation plan (the JAX twin documents its calibration):
            # the chord-free h<=16 float64 rung at nx >= 96, otherwise a
            # chord-free f32 plan at h<=4 (h<=16 at nx > 64), refined 2x
            # when the base plan is already chord-free at that step
            esc_hm = min(hm, 4.0 if nx_val <= 64 else 16.0)
            esc_refine = (refine if (hm > esc_hm or refactor_every > 1
                                     or ramp_block > 1 or newton_plateau)
                          else refine * 2)
            fp_hi = None
            if escalate:
                if nx_val >= 96 and allow_f64:
                    fp_hi = _mk(refine, chord=False,
                                hm_x=min(hm, 16.0))._replace(
                                    solve_dtype="float64")
                else:
                    if nx_val >= 96:
                        logging.getLogger("MCMC").warning(
                            "float64 is unavailable: the nx>=96 escalation "
                            "rung falls back to float32 h<=16, which cannot "
                            "repair the stiff high-mobility rows.")
                    fp_hi = _mk(esc_refine, chord=False, hm_x=esc_hm)
            fwd.append((idx, _mk(refine), fp_hi))
        fwd = tuple(fwd)

    # the IRF machinery is solver-independent: the reference convolves
    # every solver's output, the NN surrogate's included
    irf_spec = MCMC_fields.get("irf_convolution", None)
    if kind in ("pde", "nn") and irf_spec is not None:
        irf_tables = irf_tables or {}
        nk_irf = max(
            (len(irf_tables[int(w)][0]) for w in irf_spec if w > 0),
            default=1)
        res_list = []
        for m in range(n_meas):
            w = int(irf_spec[m])
            if w > 0:
                table, t_irf = irf_tables[w]
                dt_irf = float(np.mean(np.diff(t_irf)))
                r = np.arange(0, times[m][-1] + dt_irf / 4, dt_irf / 2)
                if r[-1] > times[m][-1]:
                    r[-1] = times[m][-1]
                if len(r) % 2 == 0:  # need 2*nk + 1 points
                    r = r[:-1]
                res_list.append(r)
                has_irf[m] = True
            else:
                res_list.append(np.array([0.0, 1.0, 2.0]))
        R = max(len(r) for r in res_list)
        if R % 2 == 0:
            R += 1
        res_t = np.zeros((n_meas, R))
        irf_mats = np.zeros((n_meas, nk_irf, 3))
        for m in range(n_meas):
            r = res_list[m]
            res_t[m, :len(r)] = r
            if len(r) < R:
                step = r[-1] - r[-2] if len(r) > 1 else 1.0
                res_t[m, len(r):] = r[-1] + step * np.arange(
                    1, R - len(r) + 1)
            n_conv[m] = (len(r) - 1) // 2 + 1
            w = int(irf_spec[m])
            if w > 0:
                table = irf_tables[w][0]
                irf_mats[m, :len(table)] = table

    init_profiles = np.asarray(iniPar, dtype=float)
    if MCMC_fields["ini_mode"] == "fluence" and init_profiles.shape[1] < 3:
        pad = np.ones((n_meas, 3 - init_profiles.shape[1]))
        init_profiles = np.concatenate([init_profiles, pad], axis=1)

    nn = None
    if kind == "nn":
        from metrotrpl_tpu_torch.surrogate import NeuralNetwork
        nn = NeuralNetwork()
        nn.load_model(solver_spec[1], solver_spec[2])

    return LikelihoodPlan(
        kind=kind,
        fwd=fwd,
        n_meas=n_meas,
        n_params=n_params,
        param_names=tuple(names),
        units=units,
        param_idx=param_idx,
        exp_times=exp_times,
        exp_vals=exp_vals,
        exp_uncs=exp_uncs,
        exp_mask=exp_mask,
        sigma=sigma,
        scale_idx=scale_idx,
        fluence_idx=fluence_idx,
        absp_idx=absp_idx,
        ini_mode=MCMC_fields["ini_mode"],
        init_profiles=init_profiles,
        has_irf=has_irf,
        irf_tables=irf_mats,
        res_t=res_t,
        n_conv=n_conv,
        force_min_y=bool(MCMC_fields.get("force_min_y", 0)),
        log_y=bool(MCMC_fields["log_y"]),
        nn=nn,
        thickness=np.asarray(sim_info["lengths"], dtype=float),
        newton_div_tol=_resolve_newton_div_tol(
            newton_div_tol if newton_div_tol is not None
            else MCMC_fields.get("newton_div_tol")),
        esc_gate_score=float(
            MCMC_fields.get("escalate_gate_score", ESCALATE_GATE_SCORE)),
    )


def _gather_or_one(states, idx):
    """states (K, P), idx (M,) long with -1 = 'no parameter' -> (K, M)."""
    vals = states[:, torch.clamp(idx, min=0)]
    return torch.where(idx >= 0, vals, torch.ones_like(vals))


def expand_states(plan, g_idx, x_centers, states, init_profiles, units,
                  fluence_idx=None, absp_idx=None):
    """The (K * Mg) simulation batch of measurement group ``g_idx`` for K
    entry-unit states: (init_dN (K*Mg, nx) [nm^-3], raw model-unit
    parameters name -> (K*Mg,)). Row k*Mg + m is state k, measurement
    g_idx[m]. init_profiles, units and x_centers (Mg, nx) are tensors on
    the states' device; so are fluence_idx and absp_idx, the plan's
    arrays, where given (else they are uploaded here)."""
    K = states.shape[0]
    Mg = len(g_idx)
    model_states = states * units[None, :]
    raw = {n: torch.repeat_interleave(model_states[:, plan.param_idx[n]], Mg)
           for n in _RAW_NAMES if n in plan.param_idx}
    if plan.ini_mode == "fluence":
        dev = states.device
        if fluence_idx is None:
            fluence_idx = torch.as_tensor(plan.fluence_idx, device=dev)
        if absp_idx is None:
            absp_idx = torch.as_tensor(plan.absp_idx, device=dev)
        f_mult = _gather_or_one(states, fluence_idx)[:, g_idx]
        a_mult = _gather_or_one(states, absp_idx)[:, g_idx]
        fl = (init_profiles[None, g_idx, 0] * 1e-14) * f_mult
        al = (init_profiles[None, g_idx, 1] * 1e-7) * a_mult
        dr = init_profiles[None, g_idx, 2].repeat(K, 1)
        init_dN = beer_lambert(
            fl.reshape(K * Mg, 1), al.reshape(K * Mg, 1),
            x_centers.repeat(K, 1), dr.reshape(K * Mg, 1))
    else:
        init_dN = (init_profiles[g_idx] * 1e-21).repeat(K, 1)
    return init_dN, raw


def _tile_rows(a, K):
    """(M, ...) -> (K*M, ...): the plan's per-measurement rows for K
    states, state-major."""
    return a.repeat((K,) + (1,) * (a.dim() - 1))


def _make_irf_stage(plan, dtype, device):
    """The IRF branch of the compare pipeline (reference laplace.py
    do_irf_convolution with the time max-shift, then post_conv_trim).

    Returns irf(sol (K*M, nt_exp)) -> (sol_irf (K*M, nt_exp) on the
    experiment grid, irf_valid (K*M, nt_exp) the points inside the
    convolved span, conv_fail (K*M,) the rows whose peak is at the end).
    Rows of measurements without an IRF come out too, and are discarded
    by the caller."""
    M = plan.n_meas

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    exp_times = t(plan.exp_times)
    irf_tables = t(plan.irf_tables)
    res_t = t(plan.res_t)
    n_conv = t(plan.n_conv, torch.int64)
    R = plan.res_t.shape[1]
    n_conv_pts = (R - 1) // 2 + 1
    conv_t_base = res_t[:, ::2]                               # (M, ncp)
    conv_pts = torch.arange(n_conv_pts, device=device)[None, :]

    def irf(sol):
        with span("metrotrpl.likelihood.irf"):
            K = sol.shape[0] // M
            b_exp_t = _tile_rows(exp_times, K)
            resampled = interp1d(_tile_rows(res_t, K), b_exp_t, sol)
            resampled = torch.nan_to_num(resampled, nan=0.0)
            conv = convolve_moments(resampled, _tile_rows(irf_tables, K))
            b_n_conv = _tile_rows(n_conv, K)
            conv_valid = conv_pts < b_n_conv[:, None]
            conv_masked = torch.where(conv_valid, conv, -torch.inf)
            shift_i = torch.argmax(conv_masked, dim=1)
            b_conv_t = _tile_rows(conv_t_base, K)
            t_shift = torch.gather(b_conv_t, 1, shift_i[:, None])
            conv_t_shifted = b_conv_t - t_shift
            # rows without an IRF have n_conv = 0: index -1 wraps to the last
            # point, as numpy-style indexing does in the JAX twin
            t_last = torch.gather(b_conv_t, 1, torch.remainder(
                b_n_conv - 1, n_conv_pts)[:, None])
            conv_fail = (t_last - t_shift)[:, 0] <= 0.0  # peak at the end
            sol_irf = interp1d(b_exp_t, conv_t_shifted, conv)
            irf_valid = b_exp_t < (t_last - t_shift)
            return sol_irf, irf_valid, conv_fail

    return irf


class _Compare(NamedTuple):
    """The post-solve comparison in its two parts: ``irf`` (the IRF stage,
    evaluated for every row) and ``finish`` (the rest, on its output)."""
    irf: callable       # sol -> (sol_irf, irf_valid, conv_fail)
    finish: callable    # (sol, irf's output, scale_shift, temps) -> ll

    def __call__(self, sol, scale_shift, temps):
        return self.finish(sol, self.irf(sol), scale_shift, temps)


def _make_compare_pipeline(plan, dtype, device):
    """Post-solve comparison: IRF convolution (evaluated for every row,
    selected where configured), negative-value tolerance, force_min_y and
    the tempered Gaussian log-likelihood.

    Returns compare(sol (K*M, nt_exp), scale_shift (K*M,), temps (Kt,))
    -> ll (K*M, Kt), -inf for failed rows, a :class:`_Compare`."""
    M = plan.n_meas

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    exp_vals = t(plan.exp_vals)
    exp_uncs2 = 2.0 * t(plan.exp_uncs) ** 2
    exp_mask = t(plan.exp_mask, torch.bool)
    sigma2 = t(plan.sigma) ** 2
    has_irf = t(plan.has_irf, torch.bool)
    irf = _make_irf_stage(plan, dtype, device)

    def finish(sol, irf_out, scale_shift, temps):
        K = sol.shape[0] // M

        def tile_m(a):  # (M, ...) -> (K*M, ...)
            return _tile_rows(a, K)

        b_exp_mask = tile_m(exp_mask)

        # ---- IRF convolution path (computed for every row, selected) ----
        sol_irf, irf_valid, conv_fail = irf_out

        b_has_irf = tile_m(has_irf)
        sol_cmp = torch.where(b_has_irf[:, None], sol_irf, sol)
        valid = torch.where(b_has_irf[:, None], irf_valid & b_exp_mask,
                            b_exp_mask)
        fail = b_has_irf & conv_fail

        # ---- negative-value tolerance (reference NEGATIVE_FRAC_TOL) ----
        n_valid = torch.sum(valid, dim=1)
        n_neg = torch.sum((sol_cmp < 0) & valid, dim=1)
        fail = fail | (n_neg >= NEGATIVE_FRAC_TOL * n_valid) | (n_valid == 0)
        sol_cmp = torch.abs(sol_cmp)

        b_vals = tile_m(exp_vals)
        b_uncs2 = tile_m(exp_uncs2)

        # ---- force_min_y (reference utils.set_min_y), deterministic tail
        # clamp as in the JAX twin ----
        if plan.force_min_y:
            vals_min = torch.amin(
                torch.where(valid, b_vals, torch.inf), dim=1)
            min_y = pow10(vals_min - scale_shift)
            i_final = torch.sum((sol_cmp > min_y[:, None]) & valid, dim=1)
            pos = torch.cumsum(valid.to(torch.int64), dim=1) - 1
            clamp = valid & (pos >= i_final[:, None])
            sol_cmp = torch.where(clamp, min_y[:, None], sol_cmp)

        # ---- tempered Gaussian log-likelihood ----
        log_sol = torch.log10(sol_cmp)
        err2 = (log_sol + scale_shift[:, None] - b_vals) ** 2
        err2 = torch.where(valid, err2, 0.0)
        b_sigma2 = tile_m(sigma2)
        # ll(T) = -sum err^2 / (sigma^2 T + 2 u^2)
        denom = (b_sigma2[:, None, None] * temps[None, None, :]
                 + b_uncs2[:, :, None])                       # (K*M, nt, Kt)
        ll = -torch.sum(err2[:, :, None] / denom, dim=1)      # (K*M, Kt)
        ll = torch.where(torch.isnan(ll), -torch.inf, ll)
        ll = torch.where(fail[:, None], -torch.inf, ll)
        return ll

    return _Compare(irf, finish)


_SOLVE_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _eval_span(fn):
    """An eval_logll that runs fn inside a ``metrotrpl.likelihood.eval``
    span."""
    def eval_logll(states, temps):
        with span("metrotrpl.likelihood.eval"):
            return fn(states, temps)
    return eval_logll


class LadderEval(NamedTuple):
    """The pde kind's eval_logll in the parts around the escalation
    ladder's one data-dependent step. Calling it runs them back to back;
    the walk on a card replays ``before``, ``mid`` and ``after`` as CUDA
    graphs around an eager ``rung``.

    before : states (K, P) -> pre, the ladder up to its sync (fixed shapes)
    rung : pre -> None, the sync and the rung's rows, copied into pre
    mid : pre -> the assembled curves and the IRF stage on them
    after : (pre, mid's output, temps) -> eval_logll's dict
    """
    before: callable
    rung: callable
    mid: callable
    after: callable

    def __call__(self, states, temps):
        with span("metrotrpl.likelihood.eval"):
            pre = self.before(states)
            self.rung(pre)
            return self.after(pre, self.mid(pre), temps)


def make_eval_logll(plan, dtype=torch.float64, device="cuda"):
    """Build eval_logll(states (K, P), temps (Kt,)) -> dict with
    'logll_T' (K, Kt), 'per_meas' (K, M, Kt), 'n_solver_fail' (),
    'fail_states' (K,), 'resid' (K, M), 'esc_score' (K, M) — the
    post-repair values of the JAX twin's "inline" escalation mode — and
    'repair_states' (K,), the rows per state the ladder solved again.
    States are in entry units; every tensor lives on ``device``. For the
    pde kind it is a :class:`LadderEval`."""
    device = resolve_device(device)
    if plan.kind == "pa":
        return _make_eval_pa(plan, dtype, device)
    if plan.kind == "nn":
        return _make_eval_nn(plan, dtype, device)
    M = plan.n_meas

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    with span(_BUILD_SPAN, always=True):
        units = t(plan.units)
        scale_idx = t(plan.scale_idx, torch.int64)
        fluence_idx = t(plan.fluence_idx, torch.int64)
        absp_idx = t(plan.absp_idx, torch.int64)
        init_profiles = t(plan.init_profiles)
        nt_exp = plan.exp_times.shape[1]
        compare = _make_compare_pipeline(plan, dtype, device)
        plan_tol = plan.newton_div_tol
        esc_gate = float(plan.esc_gate_score)
        tiny4 = 4 * float(torch.finfo(dtype).tiny)
        damp_pin = 0.97 * float(NEWTON_DAMP)

        groups = []
        for g_idx, fp, fp_hi in plan.fwd:
            Mg = len(g_idx)
            gi = torch.as_tensor(g_idx, dtype=torch.int64, device=device)
            nt_g = fp.nt
            g = {
                "idx": gi, "Mg": Mg, "fp": fp, "fp_hi": fp_hi,
                "x": t(fp.x_centers),
                "tol": (float(plan_tol) if plan_tol is not None
                        else newton_div_tol_default(fp.nx)),
                "hi_is_f64": (fp_hi is not None
                              and fp_hi.solve_dtype == "float64"),
                "vals": t(plan.exp_vals[g_idx][:, :nt_g]),
                "mask": t(plan.exp_mask[g_idx][:, :nt_g], torch.bool),
                "has_irf": t(plan.has_irf[g_idx], torch.bool),
            }
            groups.append(g)

        def plan_tensors(fp_x, cdt):
            """The per-measurement arrays of a forward plan on the device."""
            return {"dx": t(fp_x.dx, cdt), "dt": t(fp_x.dt, cdt),
                    "out_idx": t(fp_x.out_idx, torch.int64),
                    "is_trpl": t(fp_x.is_trpl, torch.bool),
                    "out_w": (None if fp_x.out_w is None
                              else t(fp_x.out_w, cdt))}

        for g in groups:
            g["fp_t"] = plan_tensors(g["fp"], dtype)
            if g["fp_hi"] is not None:
                sd = g["fp_hi"].solve_dtype
                g["hi_t"] = plan_tensors(
                    g["fp_hi"], dtype if sd is None else _SOLVE_DTYPES[sd])

    def plan_args(fp_x):
        return dict(model=fp_x.model, scheme=fp_x.scheme,
                    newton_iters=fp_x.newton_iters,
                    refactor_every=fp_x.refactor_every, n_ramp=fp_x.n_ramp,
                    ramp_block=fp_x.ramp_block,
                    newton_plateau=fp_x.newton_plateau, with_diag=True)

    def take(fp_x, order, init_dN, raw, Mg):
        """The batch's rows in ``order`` (None: as they are) in plan fp_x's
        solve dtype (the float64 rung overrides the walk dtype), and each
        row's measurement."""
        sd = fp_x.solve_dtype
        cdt = dtype if sd is None else _SOLVE_DTYPES[sd]
        meas = torch.arange(init_dN.shape[0], device=device) % Mg
        if order is not None:
            meas = meas[order]
            init_dN = init_dN[order]
            raw = {k: v[order] for k, v in raw.items()}
        return init_dN.to(cdt), {k: v.to(cdt) for k, v in raw.items()}, meas

    def run_solve(fp_x, pt, init_dN, raw, Mg):
        """Solve every row of the batch on plan fp_x; results in the walk
        dtype."""
        init_dN, raw, meas = take(fp_x, None, init_dN, raw, Mg)
        sol_x, resid_x = solve_forward_batch(
            init_dN, raw, pt["dx"][meas], pt["dt"][meas],
            pt["out_idx"][meas], pt["is_trpl"][meas],
            out_w=None if pt["out_w"] is None else pt["out_w"][meas],
            **plan_args(fp_x))
        return sol_x.to(dtype), resid_x.to(dtype)

    def rung_batch(g, repair, init_dN, raw):
        """The escalation plan's kernel inputs for every row of the batch,
        the rows to repair first, in row order: fixed shapes, so that after
        the sync the rung launches on a prefix of them, gathering
        nothing."""
        fp_x, pt = g["fp_hi"], g["hi_t"]
        idx = torch.arange(repair.shape[0], device=device)
        upto = torch.cumsum(repair.to(torch.int64), 0)  # repair rows <= i
        dest = torch.where(repair, upto - 1, upto[-1] + idx - upto)
        order = torch.empty_like(idx).scatter_(0, dest, idx)
        init_o, raw_o, meas = take(fp_x, order, init_dN, raw, g["Mg"])
        p, y0, dts, ns = prepare_batch(init_o, raw_o, pt["dx"][meas],
                                       pt["dt"][meas], fp_x.model)
        return {"p": p, "y0": y0, "dts": dts, "dx": pt["dx"][meas],
                "ns": ns, "raw": raw_o, "out_idx": pt["out_idx"][meas],
                "is_trpl": pt["is_trpl"][meas],
                "out_w": None if pt["out_w"] is None else pt["out_w"][meas]}

    def run_rung(g, hi, n):
        """Solve the first n rows of rung_batch's inputs on the escalation
        plan; results in the walk dtype."""
        sol_x, resid_x = solve_prepared(
            type(hi["p"])(*(f[:n] for f in hi["p"])), hi["y0"][:n],
            hi["dts"][:, :n], hi["dx"][:n], hi["ns"][:n],
            {k: v[:n] for k, v in hi["raw"].items()}, hi["out_idx"][:n],
            hi["is_trpl"][:n],
            out_w=None if hi["out_w"] is None else hi["out_w"][:n],
            **plan_args(g["fp_hi"]))
        return sol_x.to(dtype), resid_x.to(dtype)

    def fail_static(sol):
        # non-finite output, or pinned at the underflow clamp
        return (~torch.all(torch.isfinite(sol), dim=-1)
                | torch.any(sol <= tiny4, dim=-1))

    def fail_resid(g, resid):
        # ~(x < tol): a NaN residual flags too
        return ~(resid < g["tol"])

    def before(states):
        """The ladder up to its sync: per group the batch, the fast solve,
        the gate and the rows to repair. Fixed shapes, no host sync."""
        K = states.shape[0]
        s_fact = _gather_or_one(states, scale_idx)
        pre = {"K": K, "scale_shift": torch.log10(s_fact).reshape(K * M),
               "score": torch.zeros((K, M), dtype=dtype, device=device),
               "repair_states": torch.zeros((K,), dtype=torch.int64,
                                            device=device),
               "groups": []}
        for g in groups:
            gi, Mg = g["idx"], g["Mg"]

            def tile_g(a):  # (Mg, ...) -> (K*Mg, ...)
                return a.repeat((K,) + (1,) * (a.dim() - 1))

            init_dN, raw = expand_states(plan, gi, g["x"], states,
                                         init_profiles, units, fluence_idx,
                                         absp_idx)
            sol_g, resid_g = run_solve(g["fp"], g["fp_t"], init_dN, raw, Mg)

            # deterministic escalation gate: mean squared log10 distance of
            # the fast solve to the data over valid, non-collapsed points
            if plan.log_y:
                v = tile_g(g["vals"])
                mk = tile_g(g["mask"])
                ok_pt = mk & torch.isfinite(sol_g) & (sol_g > 10 * tiny4)
                ls = torch.log10(torch.clamp(torch.abs(sol_g), min=tiny4))
                ss_g = torch.log10(s_fact[:, gi]).reshape(K * Mg)
                err2g = torch.where(ok_pt, (ls + ss_g[:, None] - v) ** 2,
                                    0.0)
                score = (torch.sum(err2g, dim=-1)
                         / torch.clamp(torch.sum(ok_pt, dim=-1), min=1))
                gate = (score < esc_gate) | tile_g(g["has_irf"])
            else:
                score = torch.zeros(K * Mg, dtype=dtype, device=device)
                gate = torch.ones(K * Mg, dtype=torch.bool, device=device)
            pre["score"][:, gi] = score.reshape(K, Mg)

            if g["hi_is_f64"]:
                # static and cap-pinned rows repair ungated; sub-cap
                # residual flags and the high-mobility trigger are gated
                pinned_g = ~(resid_g < damp_pin)
                mu_row = raw["mu_n"]
                if "mu_p" in raw:
                    mu_row = torch.maximum(mu_row, raw["mu_p"])
                mu_trig = mu_row > ESCALATE_MU_MODEL
                repair = (fail_static(sol_g) | pinned_g
                          | ((fail_resid(g, resid_g) | mu_trig) & gate))
            else:
                repair = (fail_static(sol_g) | fail_resid(g, resid_g)) & gate
            pre["groups"].append({
                "sol": sol_g, "resid": resid_g, "gate": gate,
                "repair": repair,
                "hi": (None if g["fp_hi"] is None
                       else rung_batch(g, repair, init_dN, raw))})
        return pre

    def rung(pre):
        """The ladder's one data-dependent step: per group the host sync
        on the rows to repair, and their solve on the escalation plan,
        copied over the fast solve's rows in place."""
        K = pre["K"]
        for g, pg in zip(groups, pre["groups"]):
            if g["fp_hi"] is None:
                continue
            with span("metrotrpl.ladder.sync"):
                rows = torch.nonzero(pg["repair"]).flatten()
                n_rows = rows.numel()  # one host sync per group and eval
            if n_rows:   # rows = the prefix of rung_batch's order
                sol_hi, resid_hi = run_rung(g, pg["hi"], n_rows)
                pg["sol"].index_copy_(0, rows, sol_hi)
                pg["resid"].index_copy_(0, rows, resid_hi)
                pre["repair_states"].add_(torch.sum(
                    pg["repair"].reshape(K, g["Mg"]), dim=1))

    def assemble(pre):
        """The concessions (-inf) on the post-repair outputs and the
        (K*M, nt_exp) curves: (sol, n_solver_fail, fail_states, resid)."""
        K = pre["K"]
        sol_full = torch.zeros((K, M, nt_exp), dtype=dtype, device=device)
        resid_full = torch.zeros((K, M), dtype=dtype, device=device)
        n_solver_fail = torch.zeros((), dtype=torch.int64, device=device)
        fail_states = torch.zeros((K,), dtype=torch.int64, device=device)
        for g, pg in zip(groups, pre["groups"]):
            gi, Mg = g["idx"], g["Mg"]
            sol_g, resid_g, gate = pg["sol"], pg["resid"], pg["gate"]
            if g["hi_is_f64"]:
                concede = (fail_static(sol_g) | ~(resid_g < damp_pin)
                           | (fail_resid(g, resid_g) & gate))
            else:
                concede = (fail_static(sol_g)
                           | (fail_resid(g, resid_g) & gate))
            sol_g = torch.where(concede[:, None], torch.nan, sol_g)
            nfail_g = concede & gate
            n_solver_fail = n_solver_fail + torch.sum(nfail_g)
            fail_states = fail_states + torch.sum(
                nfail_g.reshape(K, Mg), dim=1)
            sol_g = sol_g.reshape(K, Mg, -1)[..., :nt_exp]
            sol_full[:, gi, :sol_g.shape[-1]] = sol_g
            resid_full[:, gi] = resid_g.reshape(K, Mg)
        return (sol_full.reshape(K * M, nt_exp), n_solver_fail, fail_states,
                resid_full)

    def mid(pre):
        """After the rung: the assembled curves and the IRF stage on them."""
        asm = assemble(pre)
        return asm, compare.irf(asm[0])

    def after(pre, mid_out, temps):
        """The rest of the comparison, into eval_logll's dict."""
        (sol, n_solver_fail, fail_states, resid_full), irf_out = mid_out
        K = pre["K"]
        ll = compare.finish(sol, irf_out, pre["scale_shift"], temps)
        per_meas = ll.reshape(K, M, -1)
        return {"logll_T": torch.sum(per_meas, dim=1), "per_meas": per_meas,
                "n_solver_fail": n_solver_fail, "fail_states": fail_states,
                "resid": resid_full, "esc_score": pre["score"],
                "repair_states": pre["repair_states"]}

    return LadderEval(before, rung, mid, after)


def u_potential(x):
    """Toy multi-well 1D potential for the 'pa' measurement type
    (reference utils.py:41-57)."""
    base = 1 + torch.sin(2 * torch.pi * x)
    u = torch.where(x < -1.25, 1 * base,
        torch.where(x < -0.25, 2 * base,
        torch.where(x < 0.75, 3 * base,
        torch.where(x < 1.75, 4 * base, 5 * base))))
    return torch.where((x < -2) | (x > 2), torch.inf, u)


def _no_solve_outputs(ll, K, M):
    """The diagnostics of a kind that runs no solve: all zero."""
    dev = ll.device
    zeros_k = torch.zeros((K,), dtype=torch.int64, device=dev)
    return {"n_solver_fail": torch.zeros((), dtype=torch.int64, device=dev),
            "fail_states": zeros_k, "repair_states": zeros_k,
            "resid": torch.zeros((K, M), dtype=ll.dtype, device=dev),
            "esc_score": torch.zeros((K, M), dtype=ll.dtype, device=dev)}


def _make_eval_pa(plan, dtype, device):
    """The 'pa' toy likelihood: -U(x0) / T for every state and
    temperature (JAX likelihood.py:678-687)."""
    def eval_pa(states, temps):
        u = u_potential(states[:, 0])                         # (K,)
        ll = -u[:, None] / temps[None, :]                     # (K, Kt)
        return {"logll_T": ll, "per_meas": ll[:, None, :],
                **_no_solve_outputs(ll, states.shape[0], 1)}
    return _eval_span(eval_pa)


#: the NN surrogate's state features, in the reference's order, before
#: 1/eps, fluence, absorption and thickness (forward_solver.py:213-219)
_NN_FEATURES = ("p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Sf", "Sb", "tauN",
                "tauP")


def _make_eval_nn(plan, dtype, device):
    """Likelihood evaluation with the NN-surrogate forward model (JAX
    likelihood.py:959-1017): features [p0, mu_n, mu_p, ks, Cn, Cp, Sf, Sb,
    tauN, tauP, 1/eps, fluence, absp, thickness] in entry units (the
    reference skips unit conversion for the NN), TRPL only, through the
    same compare pipeline as the PDE solver's curve, IRF included."""
    from metrotrpl_tpu_torch.surrogate import multiexp

    M = plan.n_meas
    net = copy.deepcopy(plan.nn).to(device=device, dtype=dtype)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    exp_times = t(plan.exp_times)
    thick = t(plan.thickness)
    init_profiles = t(plan.init_profiles)
    scale_idx = t(plan.scale_idx, torch.int64)
    fluence_idx = t(plan.fluence_idx, torch.int64)
    absp_idx = t(plan.absp_idx, torch.int64)
    feat_idx = t([plan.param_idx[n] for n in _NN_FEATURES], torch.int64)
    eps_idx = plan.param_idx["eps"]
    compare = _make_compare_pipeline(plan, dtype, device)

    def eval_nn(states, temps):
        K = states.shape[0]
        # fittable _f/_a multipliers apply before feature assembly, as the
        # reference multiplies iniPar[0]/iniPar[1]
        # (trial_move_evaluation.py:39-51)
        f_mult = _gather_or_one(states, fluence_idx)          # (K, M)
        a_mult = _gather_or_one(states, absp_idx)
        feats = torch.cat([
            torch.repeat_interleave(states[:, feat_idx], M, dim=0),
            torch.repeat_interleave(1.0 / states[:, eps_idx], M)[:, None],
            (init_profiles[None, :, 0] * f_mult).reshape(K * M, 1),
            (init_profiles[None, :, 1] * a_mult).reshape(K * M, 1),
            thick.repeat(K)[:, None]], dim=1)                 # (K*M, 14)
        coefs = net.postprocess(net(net.preprocess(feats)))
        sol = multiexp(exp_times.repeat(K, 1), coefs)         # (K*M, nt)
        s_fact = _gather_or_one(states, scale_idx)            # (K, M)
        scale_shift = torch.log10(s_fact).reshape(K * M)
        ll = compare(sol, scale_shift, temps)
        per_meas = ll.reshape(K, M, -1)
        return {"logll_T": torch.sum(per_meas, dim=1), "per_meas": per_meas,
                **_no_solve_outputs(ll, K, M)}

    return _eval_span(eval_nn)
