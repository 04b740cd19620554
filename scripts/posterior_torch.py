#!/usr/bin/env python3
"""The port's posterior on the two committed fast-vs-gold workloads.

The PyTorch port's walk (metrotrpl_tpu_torch) samples the posteriors of
docs/POSTERIOR_r08_gold.md and docs/POSTERIOR_r10_traps.md, and each
active parameter of each of its legs is compared with the committed JAX
gold column of the matching artifact:

* **std** (r08_gold): the ``full`` preset of scripts/posterior_compare.py
  (6 TRPL curves, 3 fluences x 311/2000 nm, nx=32, t <= 1000 ns, 10
  active parameters from seeded off-truth starts), 32 untempered chains x
  20000 iterations, burn-in 6666.
* **traps** (r10_traps): scripts/traps_posterior.py (2 TRPL curves
  311/2000 nm, nx=32, the shallow-trap model, 13 active parameters,
  sigma 0.05, chains start at the truth), 32 x 12000, burn-in 4000.

Each model walks two legs, both float32 with the escalation ladder
inline: **fast** (hmax 48, chord refactor_every 4) and **gold** (hmax 4,
refine 2, chord-free). Every dataset is made by the port's float64 LSODA
oracle from the workload's seed. The constants, starts, dataset maker
and ``ess_log10`` are copies of the JAX scripts' (posterior_compare.py
:56-97, :740-746, :912-933; traps_posterior.py; probe_traps_ll.py); this
script imports nothing of them, nor jax.

The port's draws are not the JAX walk's (explicit torch generators), so
agreement is statistical: |z| = |mean_port - mean_gold| / hypot(sigma_port,
sigma_gold) in log10, and |z_mc| with each mean's standard error
sigma / sqrt(ESS) added to the denominator. The fast leg draws from the
stream seeded --draw-seed (default: the workload's seed) and the gold leg
from the next seed; --shared-stream gives both legs the fast leg's
stream, as the JAX scripts did (their two columns are then correlated).
On the card each leg's float kernel is then held to its plain version at
the leg's last states, on the leg's plan and its ladder's.

Usage:
    python scripts/posterior_torch.py [--device cuda|cpu]
        [--models std,traps] [--draw-seed N] [--shared-stream]
        [--out docs/POSTERIOR_torch_h100.md]
    python scripts/posterior_torch.py --ll-error [--device cuda|cpu]
        [--models std,traps]
    python scripts/posterior_torch.py --acceptance-check N [--models ...]

It walks both legs of each model named in --models on the card (the
default) and writes their report to --out. With --ll-error it walks
nothing: it prints each leg's float32 log-likelihood error (the ladder
inline) against float64 on the same plan, per curve, at 32 states drawn
around the committed gold column. With --acceptance-check N it walks
only the fast leg, N iterations in float32 and again in float64, and
prints each one's acceptance.
"""

import argparse
import os
import re
import sys
import time
from typing import NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from metrotrpl_tpu_torch import resolve_device  # noqa: E402
from metrotrpl_tpu_torch.oracle import solve_reference  # noqa: E402
from metrotrpl_tpu_torch.oracle.scipy_reference import beer_lambert  # noqa: E402
from metrotrpl_tpu_torch.workloads import (  # noqa: E402
    STAUB_INACTIVE,
    STAUB_NAMES,
    STAUB_PRIOR,
    STAUB_TRUE,
    STAUB_UC,
)

#: the two legs: the production fast mode and the escalation-target mode
LEGS = {"fast": {"hmax": 48.0, "refactor": 4, "refine": 1},
        "gold": {"hmax": 4.0, "refactor": 1, "refine": 2}}
WINDOW = 500
N_CHAINS = 32
#: the limit every active parameter's |z| against committed gold is held to
Z_LIMIT = 0.3


class Workload(NamedTuple):
    """One posterior workload: geometry, truth, sampler settings and the
    committed artifact whose gold column it is compared with."""
    model: str
    names: list
    true: dict          # entry units
    uc: dict            # entry -> model unit conversions
    active: tuple
    start: dict         # initial state of every chain (entry units)
    prior: dict         # name -> (lo, hi) hard bounds
    width: float        # log10 proposal half-width
    sigma: float        # model uncertainty
    unc: float          # data uncertainty (log10)
    nx: int
    nt: int
    t_end: float
    lengths: list
    flu: list           # per curve (fluence [cm^-2], alpha [cm^-1])
    seed: int
    n_iters: int
    artifact: str       # repo path of the committed JAX artifact


def std_workload():
    """posterior_compare.py under ``apply_preset("full")``: the staub
    shape at nx=32, all 10 active parameters, seeded off-truth starts."""
    seed = 20260816
    flu = np.loadtxt(os.path.join(
        REPO, "Inputs", "staub_MAPI_threepower_twothick_fluences.csv"),
        delimiter=",")
    active = tuple(n for n in STAUB_NAMES if n not in STAUB_INACTIVE)
    # mild off-truth starts (seeded): +/- 0.15 decades on every active param
    rng = np.random.default_rng(seed + 7)
    start = {n: float(STAUB_TRUE[n] * 10 ** rng.uniform(-0.15, 0.15))
             for n in active}
    return Workload(
        model="std", names=list(STAUB_NAMES), true=dict(STAUB_TRUE),
        uc=dict(STAUB_UC), active=active, start={**STAUB_TRUE, **start},
        prior={n: STAUB_PRIOR[n] if n in active else (1e-32, 1e32)
               for n in STAUB_NAMES},
        width=0.01, sigma=0.05, unc=0.05, nx=32, nt=101, t_end=1000.0,
        lengths=[311.0, 2000.0] * 3,
        flu=[(row[0], row[1]) for row in flu], seed=seed, n_iters=20000,
        artifact="docs/POSTERIOR_r08_gold.md")


def traps_workload():
    """traps_posterior.py (probe_traps_ll.py's constants): the
    shallow-trap model on 2 curves, chains starting at the truth."""
    traps_true = {"kC": 5.0, "Nt": 1e15 * 1e-21, "tauE": 300.0}
    names = list(STAUB_NAMES) + list(traps_true)
    true = {**STAUB_TRUE, **traps_true}
    return Workload(
        model="traps", names=names, true=true, uc=dict(STAUB_UC),
        active=tuple(n for n in names if n not in ("n0", "eps", "Tm")),
        start=dict(true),
        prior={n: (true[n] * 1e-3, true[n] * 1e3) for n in names},
        width=0.01, sigma=0.05, unc=0.05, nx=32, nt=101, t_end=1000.0,
        lengths=[311.0, 2000.0], flu=[(2.12e11, 6e4)] * 2, seed=20260820,
        n_iters=12000, artifact="docs/POSTERIOR_r10_traps.md")


WORKLOADS = {"std": std_workload, "traps": traps_workload}


def _ic(w, m):
    L = w.lengths[m]
    dx = L / w.nx
    x = np.linspace(dx / 2, L - dx / 2, w.nx)
    f, a = w.flu[m]
    return beer_lambert(f * 1e-14, a * 1e-7, x)


def make_dataset(w):
    """The workload's noisy synthetic data: the float64 LSODA oracle at
    the truth plus seeded Gaussian noise in log10. Returns (t, vals)."""
    pm = {k: v * w.uc.get(k, 1) for k, v in w.true.items()}
    t = np.linspace(0, w.t_end, w.nt)
    rng = np.random.default_rng(w.seed)
    vals = []
    for m, L in enumerate(w.lengths):
        pl = solve_reference(_ic(w, m), L, w.nx, t, pm, model=w.model)
        vals.append(np.log10(pl) + rng.normal(0, w.unc, w.nt))
    return t, vals


def build_plans(w, t, vals, hmax, refactor, refine, escalate=True):
    """(likelihood plan, move plan) of one leg; escalate=False builds the
    likelihood plan without the escalation ladder (every row as the fast
    solve leaves it, never solved again)."""
    from metrotrpl_tpu_torch.inference.likelihood import build_likelihood_plan
    from metrotrpl_tpu_torch.inference.moves import build_move_plan

    param_info = {
        "names": w.names,
        "unit_conversions": w.uc,
        "do_log": {n: 1 for n in w.names},
        "active": {n: int(n in w.active) for n in w.names},
        "init_guess": dict(w.start),
        "prior_dist": dict(w.prior),
        "trial_move": {n: w.width for n in w.names},
    }
    M = len(w.lengths)
    sim_info = {"lengths": w.lengths, "nx": [w.nx] * M,
                "meas_types": ["TRPL"] * M, "num_meas": M}
    mcmc = {"ini_mode": "fluence", "model": w.model, "log_y": 1,
            "model_uncertainty": w.sigma, "hard_bounds": 1}
    iniPar = np.array([[f, a, 1] for f, a in w.flu])
    e_data = ([t] * M, vals, [np.full(w.nt, w.unc)] * M)
    plan = build_likelihood_plan(sim_info, param_info, mcmc, e_data, iniPar,
                                 hmax=hmax, align_outputs=False,
                                 refactor_every=refactor, refine=refine,
                                 escalate=escalate)
    return plan, build_move_plan(param_info, mcmc)


def run_leg(w, t, vals, leg, n_iters, n_chains=N_CHAINS, device="cuda",
            log=print, draw_seed=None, dtype=torch.float32, n_temps=1):
    """Walk n_chains untempered chains (float32 unless dtype says
    otherwise) for n_iters iterations (windows of 500) through the port's
    build_mh_kernel with the ladder inline, drawing from the stream seeded
    draw_seed (default: the workload's seed). With n_temps > 1 it walks
    n_chains independent tempered ensembles instead, each of n_temps
    chains at T = 2^0 ... 2^(n_temps - 1) with a swap round every 10
    iterations, fused into one solve batch (vmap_ensembles); ensemble e
    draws from the stream seeded draw_seed + e, and only each ensemble's
    T=1 chain enters the samples (posterior_compare.py's
    run_tpu_mh(temper=n_temps)).

    Returns a dict: the leg's plan, its draw seed, samples (active name
    -> (n_iters, n_chains)), the cold chains' acceptance, the last states
    of every chain and their own log-likelihoods, walker-steps/s and ms
    per iteration of the windows (past the initial evaluation, which
    builds the kernel library at its first use), and the leg's kernel
    launches and repaired rows per iteration (None off the card, where
    the wrapper counts nothing)."""
    from metrotrpl_tpu_torch.inference.metropolis import (
        build_mh_kernel,
        vmap_ensembles,
    )
    from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
    from metrotrpl_tpu_torch.inference.moves import n_tries
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    device = resolve_device(device)
    f32, f64 = torch.float32, torch.float64
    cfg = LEGS[leg]
    plan, move = build_plans(w, t, vals, cfg["hmax"], cfg["refactor"],
                             cfg["refine"])
    P, M = len(w.names), len(w.lengths)
    tempered = n_temps > 1
    E, K = (n_chains, n_temps) if tempered else (1, n_chains)
    temps = 2.0 ** np.arange(n_temps) if tempered else np.ones(K)
    base_move = np.array([w.width if n in w.active else 0.0
                          for n in w.names])
    kern = vmap_ensembles(build_mh_kernel(
        plan, move, temps, base_move, temper_freq=10,
        do_tempering=tempered, dtype=dtype, device=device))
    draw_seed = w.seed if draw_seed is None else draw_seed
    sources = [TorchDraws(draw_seed + e, K, P, n_tries(move),
                          move.mu_constraint is not None, dtype, device)
               for e in range(E)]
    init = np.array([w.start[n] for n in w.names])
    states = torch.as_tensor(np.tile(init, (E, K, 1)), dtype=dtype,
                             device=device)
    sk.reset_launch_counts()
    t_start = time.perf_counter()
    ll = kern.init_ll(states)
    ll.cpu()                         # waits for the initial evaluation
    clock = time.perf_counter()
    h_states, h_accept = [], []
    k = 0
    while k < n_iters:
        n = min(WINDOW, n_iters - k)
        states, ll, _, _, _, hist = kern.run_window(states, ll, k, n,
                                                    sources)
        h_st, h_acc = hist[0], hist[2]          # (E, n, K, P), (E, n, K)
        if tempered:                            # the cold chains
            h_st, h_acc = h_st[:, :, 0], h_acc[:, :, 0]
        else:
            h_st, h_acc = h_st[0], h_acc[0]
        h_states.append(h_st.cpu().numpy())     # waits for the window
        h_accept.append(h_acc.cpu().numpy())
        k += n
        log(f"  {w.model} {leg} {k}/{n_iters}")
    t_end = time.perf_counter()
    # the kernel counts launches and rows on the card only; every
    # evaluation (the initial one included) solves all E * K * M rows
    launches, rows = dict(sk.LAUNCHES), dict(sk.ROWS)
    on_card = device.type == "cuda"
    base_rows = (n_iters + 1) * E * K * M
    axis = 1 if tempered else 0                 # the window's steps
    h = np.concatenate(h_states, axis=axis)
    acc = np.concatenate(h_accept, axis=axis)
    if tempered:                                # -> (iters, E, ...)
        h, acc = h.swapaxes(0, 1), acc.swapaxes(0, 1)
    return {
        "plan": plan, "draw_seed": draw_seed,
        "samples": {p: h[:, :, w.names.index(p)] for p in w.active},
        "acceptance": float(acc.mean()), "accept": acc,
        "states": states.reshape(E * K, P).double().cpu().numpy(),
        "ll": torch.diagonal(ll, dim1=1, dim2=2).reshape(-1)
        .double().cpu().numpy(),
        "walker_steps_per_s": E * K * n_iters / (t_end - clock),
        "ms_per_iteration": 1e3 * (t_end - clock) / n_iters,
        "seconds": t_end - t_start,
        "launches_per_iteration": {
            f"{m}_{d}": launches[(m, dt)] / n_iters
            for m in ("std", "traps") for d, dt in (("f32", f32),
                                                    ("f64", f64))},
        "launches": launches, "rows": rows,
        "repaired_rows_per_iteration":
            ((sum(rows.values()) - base_rows) / n_iters if on_card
             else None),
        "rows_per_iteration": E * K * M,
        "n_iters": n_iters, "n_chains": n_chains, "n_temps": n_temps,
    }


def kernel_checks(r, card, device):
    """The leg's float kernel against its plain version at the leg's last
    states on its plan and on its ladder's plan
    (kernel_times.kernel_vs_plain, which raises on a difference)."""
    from metrotrpl_tpu_torch.solver.kernel_times import kernel_vs_plain

    plan = r["plan"]
    _, fp, fp_hi = plan.fwd[0]
    out = []
    for label, fp_x in (("leg's plan", fp), ("ladder's plan", fp_hi)):
        c = kernel_vs_plain(card, device, plan, fp_x, torch.float32,
                            r["states"], label)
        print(f"{fp_x.model} {label}: {c.pop('line')}", flush=True)
        out.append(dict(plan=label, **c))
    return out


def gold_column_states(w, n, seed=7):
    """n states around the committed JAX gold column: every active
    parameter log10-normal with its mean and sigma (seeded), the others
    at the workload's start."""
    gold = read_committed_gold(os.path.join(REPO, w.artifact))
    rng = np.random.default_rng(seed)
    states = np.tile([w.start[n_] for n_ in w.names], (n, 1))
    for i, p in enumerate(w.names):
        if p in w.active:
            states[:, i] = 10.0 ** rng.normal(gold[p][0], gold[p][1], n)
    return states


def ll_error(w, t, vals, device, n=32):
    """The float32 walk's log-likelihood error at n gold-column states,
    per leg: each curve's float32 value (the ladder inline) against the
    same plan evaluated in float64. Returns {leg: dict}."""
    from metrotrpl_tpu_torch.inference.likelihood import make_eval_logll

    states = gold_column_states(w, n)
    out = {}
    for leg, c in LEGS.items():
        plan = build_plans(w, t, vals, c["hmax"], c["refactor"],
                           c["refine"])[0]
        ll, rep = {}, None
        for dt in (torch.float32, torch.float64):
            r = make_eval_logll(plan, dtype=dt, device=device)(
                torch.as_tensor(states, dtype=dt, device=device),
                torch.ones(1, dtype=dt, device=device))
            ll[dt] = r["per_meas"][..., 0].double().cpu().numpy()
            if dt == torch.float32:
                rep = int(r["repair_states"].sum())
        d = np.abs(ll[torch.float32] - ll[torch.float64])
        out[leg] = {"max": float(d.max()), "median": float(np.median(d)),
                    "p90": float(np.quantile(d, 0.9)),
                    "repaired_rows": rep, "rows": d.size,
                    "finite": bool(np.isfinite(d).all())}
    return out


def acceptance_check(w, t, vals, device, n_iters):
    """The fast leg walked n_iters iterations in float32 and in float64
    from the same starts and draw seed. Returns {dtype name: (acceptance
    past the first third, repaired rows per iteration)}: float64 keeps
    the fast plan and drops its float32 rounding."""
    out = {}
    for dt in (torch.float32, torch.float64):
        r = run_leg(w, t, vals, "fast", n_iters, N_CHAINS, device,
                    log=lambda line: None, dtype=dt)
        acc = float(r["accept"][n_iters // 3:].mean())
        out[str(dt).split(".")[-1]] = (acc, r["repaired_rows_per_iteration"])
    return out


def ess_log10(x):
    """Effective sample size of a (possibly multi-chain) sample set in
    log10 space: per-chain integrated-autocorrelation-time ESS (initial
    positive sequence truncated at acf < 0.05), summed over independent
    chains. x : (n,) one chain or (n, K) K chains."""
    x = np.log10(np.atleast_2d(x.T if x.ndim > 1 else x[None, :]))
    total = 0.0
    for row in x:
        r = row - row.mean()
        n = len(r)
        v = r.var()
        if v == 0:
            continue
        acf = np.correlate(r, r, "full")[n - 1:] / (
            np.arange(n, 0, -1) * v)
        tau = 1.0
        for k in range(1, n // 2):
            if acf[k] < 0.05:
                break
            tau += 2 * acf[k]
        total += n / tau
    return max(total, 1.0)


def z_scores(m_ref, s_ref, ess_ref, m, s, ess):
    """(|z|, |z_mc|) of two log10 means: the difference over the combined
    posterior sigma, and over that plus each mean's standard error
    sigma / sqrt(ESS) (posterior_compare.py:740-746)."""
    z = abs(m_ref - m) / max(np.hypot(s_ref, s), 1e-12)
    z_mc = abs(m_ref - m) / max(np.sqrt(
        s_ref ** 2 + s ** 2 + s_ref ** 2 / ess_ref + s ** 2 / ess), 1e-12)
    return float(z), float(z_mc)


def summarize(samples, burn):
    """(log10 mean, log10 sigma, ESS) of each active parameter's chains
    past burn-in."""
    out = {}
    for p, s in samples.items():
        post = s[burn:]
        lg = np.log10(post.ravel())
        out[p] = (float(lg.mean()), float(lg.std()), float(ess_log10(post)))
    return out


_GOLD_ROW = re.compile(
    r"^\| (\w+) \| [^|]+ \| 10\^\(([-\d.]+) \+/- ([\d.]+)\) \((\d+)\) \|")


def read_committed_gold(path):
    """name -> (log10 mean, log10 sigma, ESS) of the gold column of a
    committed fast-vs-gold artifact's table."""
    gold = {}
    with open(path) as f:
        for line in f:
            m = _GOLD_ROW.match(line)
            if m:
                gold[m.group(1)] = (float(m.group(2)), float(m.group(3)),
                                    float(m.group(4)))
    return gold


def _fmt(mse):
    m, s, e = mse
    return f"10^({m:.4f} +/- {s:.4f}) ({e:.0f})"


def model_section(w, legs, gold, card):
    """Markdown lines of one model's z-table and leg rows, and its worst
    |z| per leg."""
    r0 = next(iter(legs.values()))
    burn = r0["n_iters"] // 3
    stats = {leg: summarize(r["samples"], burn) for leg, r in legs.items()}
    seeds = ", ".join(f"{leg} {r['draw_seed']}" for leg, r in legs.items())
    lines = [
        f"## {w.model} ({os.path.basename(w.artifact)[:-3]}), draw seeds "
        f"{seeds}",
        "",
        f"{len(w.lengths)} TRPL curves, nx={w.nx}, t <= {w.t_end:.0f} ns, "
        f"{len(w.active)} active parameters, {r0['n_chains']} untempered "
        f"chains x {r0['n_iters']} iterations, burn-in {burn}, float32 walk "
        f"with the escalation ladder inline, on {card}.",
        "",
    ]
    for leg, r in legs.items():
        c = LEGS[leg]
        lpi = ", ".join(f"{k} {v:.2f}" for k, v in
                        r["launches_per_iteration"].items() if v)
        rep = r["repaired_rows_per_iteration"]
        sps = r["walker_steps_per_s"]
        lines.append(
            f"* **{leg}** (hmax {c['hmax']:g}, refactor_every "
            f"{c['refactor']}, refine {c['refine']}): acceptance "
            f"{r['acceptance']:.3f}; {sps:.1f} walker-steps/s past the "
            f"initial evaluation ({r['seconds']:.1f} s in all); "
            + (f"kernel launches per iteration {lpi}; repaired rows per "
               f"iteration {rep:.3f} of {r['rows_per_iteration']}"
               if rep is not None else "no kernel launched (the CPU)")
            + "".join(f"; the float kernel against its plain version at "
                      f"the leg's last {r['n_chains']} states on the "
                      f"{c['plan']} ({c['shape']}): max |dlog10 obs| "
                      f"{c['max_abs_err']:.3e} on the rows under the "
                      f"Newton threshold, {c['flagged']} rows over it in "
                      f"both" for c in r.get("checks", ()))
            + f"; on {card}.")
    head = "| param | truth | committed JAX gold mean +/- sigma (ESS) |"
    rule = "|---|---|---|"
    for leg in legs:
        head += f" port {leg} mean +/- sigma (ESS) | \\|z\\| | \\|z_mc\\| |"
        rule += "---|---|---|"
    lines += ["", head, rule]
    worst = {leg: (0.0, 0.0) for leg in legs}
    for p in w.active:
        row = f"| {p} | {w.true[p]:g} | {_fmt(gold[p])} |"
        for leg in legs:
            z, z_mc = z_scores(*gold[p], *stats[leg][p])
            worst[leg] = (max(worst[leg][0], z), max(worst[leg][1], z_mc))
            row += f" {_fmt(stats[leg][p])} | {z:.2f} | {z_mc:.2f} |"
        lines.append(row)
    lines.append("")
    for leg, (z, z_mc) in worst.items():
        verdict = "within" if z <= Z_LIMIT else "OVER"
        lines.append(f"Port {leg} leg: largest |z| **{z:.2f}** ({verdict} "
                     f"the {Z_LIMIT} limit), largest |z_mc| {z_mc:.2f}.")
    lines.append("")
    return lines, worst


def main(argv=None):
    from metrotrpl_tpu_torch.solver.kernel_times import nvidia_smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--models", default="std,traps")
    ap.add_argument("--draw-seed", type=int, default=None,
                    help="seed of the fast leg's draw stream; the gold "
                    "leg's is one more (default: the workload's seed)")
    ap.add_argument("--shared-stream", action="store_true",
                    help="both legs draw from the fast leg's stream")
    ap.add_argument("--acceptance-check", type=int, default=0,
                    metavar="N", help="instead of walking both legs, walk "
                    "the fast leg N iterations in float32 and in float64 "
                    "and print each one's acceptance")
    ap.add_argument("--ll-error", action="store_true",
                    help="instead of walking, print each leg's float32 "
                    "log-likelihood error against float64 at 32 states "
                    "around the committed gold column")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "POSTERIOR_torch_h100.md"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = (nvidia_smi_line() if device.type == "cuda"
            else "the CPU (plain PyTorch path, no card)")
    print(f"card: {card}", flush=True)
    models = args.models.split(",")
    if args.acceptance_check:
        for model in models:
            w = WORKLOADS[model]()
            t, vals = make_dataset(w)
            n = args.acceptance_check
            for dt, (acc, rep) in acceptance_check(w, t, vals, device,
                                                   n).items():
                print(f"{model} fast leg in {dt}, {N_CHAINS} x {n} "
                      f"iterations: acceptance past iteration {n // 3} "
                      f"{acc:.4f}; repaired rows per iteration {rep}; on "
                      f"{card}", flush=True)
        return
    if args.ll_error:
        for model in models:
            w = WORKLOADS[model]()
            t, vals = make_dataset(w)
            for leg, e in ll_error(w, t, vals, device).items():
                print(f"{model} {leg}: float32 - float64 |ll| per curve "
                      f"over {e['rows']} rows: median {e['median']:.3e}, "
                      f"p90 {e['p90']:.3e}, max {e['max']:.3e}; float32 "
                      f"repaired rows {e['repaired_rows']}; finite "
                      f"{e['finite']}; on {card}", flush=True)
        return
    sections, worst_all = [], {}
    for model in models:
        w = WORKLOADS[model]()
        t0 = time.perf_counter()
        t, vals = make_dataset(w)
        print(f"{model}: dataset in {time.perf_counter() - t0:.1f} s",
              flush=True)
        results = {}
        seed0 = w.seed if args.draw_seed is None else args.draw_seed
        for i, leg in enumerate(LEGS):
            r = run_leg(w, t, vals, leg, w.n_iters, N_CHAINS, device,
                        log=lambda s: print(s, flush=True),
                        draw_seed=seed0 + (0 if args.shared_stream else i))
            if device.type == "cuda":
                r["checks"] = kernel_checks(r, card, device)
            results[leg] = r
            print(f"{model} {leg}: acceptance {r['acceptance']:.3f}, "
                  f"walker-steps/s {r['walker_steps_per_s']}, launches per "
                  f"iteration {r['launches_per_iteration']}, repaired rows "
                  f"per iteration {r['repaired_rows_per_iteration']}",
                  flush=True)
        gold = read_committed_gold(os.path.join(REPO, w.artifact))
        lines, worst = model_section(w, results, gold, card)
        sections += lines
        worst_all[model] = worst
        print("\n".join(lines), flush=True)
    reproduce = " ".join(["python scripts/posterior_torch.py"]
                         + (argv if argv is not None else sys.argv[1:]))
    doc = [
        "# The port's posterior against the committed JAX gold columns",
        "",
        "The PyTorch port (metrotrpl_tpu_torch) walks the workloads of",
        "docs/POSTERIOR_r08_gold.md (std) and docs/POSTERIOR_r10_traps.md",
        "(traps) on the card; each leg's posterior mean of every active",
        "parameter (log10) is compared with the committed JAX gold column",
        "(the JAX package's gold leg on a TPU). The port's draws are its own",
        "(torch generators), so agreement is statistical. |z| divides the",
        "mean difference by the two posterior sigmas combined; |z_mc| adds",
        "each mean's standard error sigma/sqrt(ESS). Every number below was",
        f"measured by scripts/posterior_torch.py on {card}; the committed",
        "columns' own throughput was a TPU's and is not quoted.",
        "",
        *sections,
        "Worst |z| per model and leg: " + "; ".join(
            f"{m} {leg} {z:.2f}" for m, ws in worst_all.items()
            for leg, (z, _) in ws.items()) + f" (limit {Z_LIMIT}).",
        "",
        f"Reproduce: `{reproduce}`.",
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(doc) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
