#!/usr/bin/env python3
"""The flagship posterior on the card, against the committed reference-math
chain.

The workload is scripts/posterior_compare.py under
``apply_preset("flagship")``: the staub shape at the reference's own
fidelity (6 TRPL curves, 3 fluences x 311/2000 nm, nx=128, 501 points to
2000 ns, 10 active parameters from seeded off-truth starts, proposal
half-width 0.01 decades, sigma = unc = 0.05). Its dataset is made by the
port's float64 LSODA oracle and must be, bit for bit, the one the
committed oracle chain was sampled against (``DATASET_SHA256``).

Each leg is the production tempered walk (posterior_compare.py's
run_tpu_mh(temper=4)): 8 independent ensembles of 4 chains at T = 1, 2,
4, 8, a swap round every 10 iterations, fused into one solve batch
(posterior_torch.run_leg), the fast plan (hmax 48, chord blocks of 4)
with the escalation ladder inline and its float64 rung (nx >= 96). Only
the T=1 chains enter the samples. Two legs walk the same draw streams:

* **f32**: the fidelity mode, the walk in float32;
* **f64**: the control, the whole walk in float64 (the fast plan in
  double), which says whether float32 rounding on the fast path moves
  the posterior.

The comparison is scripts/assemble_r09.py's (:26-140): per active
parameter and for mu_ambi, Sf+Sb and Cn+Cp, the log10 mean +/- sigma and
per-chain ESS of the oracle chain and of each leg past n/3 burn-in, |z|
and |z_mc|, its pass rule, and the ridge lines (post-burn max mu_n and the
share of draws above mu_n = 50).

Usage:
    python scripts/flagship_torch.py [--device cuda|cpu] [--legs f32,f64]
        [--save-chains DIR] [--oracle PATH]
        [--out docs/POSTERIOR_torch_flagship_h100.md]
    python scripts/flagship_torch.py --assemble DIR [--oracle PATH]
        [--out ...]
    python scripts/flagship_torch.py --assemble DIR --oracle PATH
        --ll-check N [--workers W] [--ll-states PATH] [--device cuda|cpu]
        [--out docs/LL_AGREEMENT_torch_flagship_h100.md]

The first form walks each leg in --legs on the card (the default),
saving each one's cold chains and numbers to DIR/flagship_<leg>.npz when
--save-chains is given (scripts/esc_validation_torch.py reads the f32
leg's), and writes the report to --out. The second walks nothing: it
writes the report from the legs saved in DIR. Both compare with the
chain --oracle (default the committed one; the extended chain of
scripts/extend_oracle_torch.py is read to its n_done).

The third is the flagship form of posterior_compare.run_ll_check: N
states, a third each from the committed chain past its burn-in, the
extended chain PATH past the committed chain's 3200 iterations, and the
f32 leg saved in DIR (its flattened post-burn draws), thinned as
run_ll_check thins; at each the float64 LSODA oracle's ll (over W
spawned processes) against the leg's own evaluation on the card
(float32 with the float64 rung, T=1, in chunks of 64 states x 6 rows).
It reports run_ll_check's |dll| table, the same percentiles by mu_n
band, and per chunk the rows repaired, the std kernels' launches and
their ms by CUDA events; and writes 16 of the states (8 above mu_n 50, 8
below) with their oracle ll and the card's |dll| to --ll-states, the
file chip_smoke.py's phase 22 reads.
"""

import argparse
import contextlib
import hashlib
import json
import os
import re
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import posterior_torch as pt  # noqa: E402
from metrotrpl_tpu_torch import resolve_device  # noqa: E402
from metrotrpl_tpu_torch.workloads import (  # noqa: E402
    STAUB_INACTIVE,
    STAUB_NAMES,
    STAUB_PRIOR,
    STAUB_TRUE,
    STAUB_UC,
)

#: SHA-256 of the flagship dataset (dataset_sha256) that the committed
#: oracle chain was sampled against: posterior_compare.make_dataset()
#: under apply_preset("flagship"), through the JAX package's oracle
DATASET_SHA256 = ("cdffc360a97452b5d58140ad2f661c0a4a996692d1821221"
                  "cb163e4891e02001")
#: the committed reference-math chain (3200 iterations of a serial LSODA
#: Metropolis walk on that dataset) and 8 of its ridge states with their
#: oracle log-likelihoods
ORACLE_CHAIN = os.path.join(HERE, ".oracle_tmh_3200_20260816_9879b0941d.npz")
RIDGE_STATES = os.path.join(HERE, ".probe_r14_ridge_states.npz")
N_ENSEMBLES = 8
N_TEMPS = 4
N_ITERS = 20000
#: the two legs' walk dtypes, and what each leg is
LEG_DTYPES = {"f32": torch.float32, "f64": torch.float64}
LEG_ROLE = {"f32": "float32, the fidelity mode", "f64": "float64, the control"}
#: derived parameters the posteriors identify (assemble_r09.py:41-46)
DERIVED = {
    "mu_ambi": lambda s: 2 * s["mu_n"] * s["mu_p"] / (s["mu_n"] + s["mu_p"]),
    "Sf+Sb": lambda s: s["Sf"] + s["Sb"],
    "Cn+Cp": lambda s: s["Cn"] + s["Cp"],
}
#: the ridge lines' threshold on mu_n [cm^2/Vs]
RIDGE_MU = 50
#: the ll check: states per card evaluation (x 6 rows), the committed
#: chain's length (the extended chain's burn-in), and the file of the
#: states chip_smoke.py holds the card to (N_FILE_STATES // 2 above
#: RIDGE_MU and as many below)
LL_CHECK_CHUNK = 64
N_COMMITTED = 3200
LL_CHECK_STATES = os.path.join(HERE, ".ll_check_states_torch.npz")
N_FILE_STATES = 16


def flagship_workload():
    """posterior_compare.py under ``apply_preset("flagship")``."""
    seed = 20260816
    flu = np.loadtxt(os.path.join(
        REPO, "Inputs", "staub_MAPI_threepower_twothick_fluences.csv"),
        delimiter=",")
    active = tuple(n for n in STAUB_NAMES if n not in STAUB_INACTIVE)
    # mild off-truth starts (seeded): +/- 0.15 decades on every active param
    rng = np.random.default_rng(seed + 7)
    start = {n: float(STAUB_TRUE[n] * 10 ** rng.uniform(-0.15, 0.15))
             for n in active}
    return pt.Workload(
        model="std", names=list(STAUB_NAMES), true=dict(STAUB_TRUE),
        uc=dict(STAUB_UC), active=active, start={**STAUB_TRUE, **start},
        prior={n: STAUB_PRIOR[n] if n in active else (1e-32, 1e32)
               for n in STAUB_NAMES},
        width=0.01, sigma=0.05, unc=0.05, nx=128, nt=501, t_end=2000.0,
        lengths=[311.0, 2000.0] * 3,
        flu=[(row[0], row[1]) for row in flu], seed=seed, n_iters=N_ITERS,
        artifact=os.path.relpath(ORACLE_CHAIN, REPO))


def dataset_sha256(t, vals):
    """SHA-256 of t and then each curve's values, as float64 bytes."""
    h = hashlib.sha256()
    for a in (t, *vals):
        h.update(np.ascontiguousarray(a, dtype=np.float64).tobytes())
    return h.hexdigest()


def checked_dataset(w):
    """The flagship data (t, vals) by the port's float64 LSODA oracle
    (posterior_torch.make_dataset), which must be the oracle chain's
    dataset, and its digest."""
    t, vals = pt.make_dataset(w)
    digest = dataset_sha256(t, vals)
    if digest != DATASET_SHA256:
        raise RuntimeError(f"the flagship dataset's SHA-256 {digest} is not "
                           f"the oracle chain's {DATASET_SHA256}")
    return t, vals, digest


def read_chain(path, active):
    """(samples: name -> array, acceptance, iterations) of a saved chain:
    the first n_done iterations if the file says how many were done."""
    z = np.load(path)
    n = int(z["n_done"]) if "n_done" in z.files else len(z[active[0]])
    return {k: np.asarray(z[k])[:n] for k in active}, float(z["acc"]), n


def comparison_rows(w, oracle, legs):
    """assemble_r09.py's table: one row per active parameter and derived
    quantity, {"param", "truth", "oracle": (mean, sigma, ESS), leg name:
    (mean, sigma, ESS, |z|, |z_mc|)}, every statistic in log10 past each
    chain's n/3 burn-in. oracle: name -> (n,) or (n, chains); legs: leg
    name -> the same."""
    stats = {}
    for name, smp in {"oracle": oracle, **legs}.items():
        post = {k: s[len(s) // 3:] for k, s in smp.items()}
        post.update({d: fn(post) for d, fn in DERIVED.items()})
        stats[name] = pt.summarize(post, 0)
    true = dict(w.true)
    true.update({d: float(fn({k: np.asarray(w.true[k]) for k in w.active}))
                 for d, fn in DERIVED.items()})
    rows = []
    for p in (*w.active, *DERIVED):
        row = {"param": p, "truth": true[p], "oracle": stats["oracle"][p]}
        for name in legs:
            row[name] = (*stats[name][p],
                         *pt.z_scores(*row["oracle"], *stats[name][p]))
        rows.append(row)
    return rows


def ridge_lines(samples):
    """(post-burn max mu_n, share of post-burn draws above RIDGE_MU)."""
    mu = np.asarray(samples["mu_n"][len(samples["mu_n"]) // 3:])
    return float(mu.max()), float((mu > RIDGE_MU).mean())


def verdict(worst, worst_mc):
    """assemble_r09.py's pass rule on the largest |z| and |z_mc|."""
    if worst < 1:
        return "PASS (z < 1)"
    if worst_mc < 1:
        return "PASS once Monte-Carlo error is counted (z_mc < 1; raw z " \
               "exceeded)"
    return "EXCEEDED"


def walk_leg(w, t, vals, leg, n_iters, device, log=print):
    """One tempered flagship leg (posterior_torch.run_leg with N_TEMPS
    temperatures per ensemble) in the leg's dtype."""
    return pt.run_leg(w, t, vals, "fast", n_iters, N_ENSEMBLES, device,
                      log=log, dtype=LEG_DTYPES[leg], n_temps=N_TEMPS)


def leg_summary(r, card, digest):
    """The numbers of a walked leg that the report prints."""
    return {
        "card": card, "dataset_sha256": digest, "n_iters": r["n_iters"],
        "n_ensembles": r["n_chains"], "n_temps": r["n_temps"],
        "draw_seed": r["draw_seed"], "acceptance": r["acceptance"],
        "walker_steps_per_s": r["walker_steps_per_s"],
        "ms_per_iteration": r["ms_per_iteration"], "seconds": r["seconds"],
        "launches_per_iteration": r["launches_per_iteration"],
        "repaired_rows_per_iteration": r["repaired_rows_per_iteration"],
        "rows_per_iteration": r["rows_per_iteration"],
    }


def save_leg(path, samples, summary):
    """The leg's cold chains in assemble_r09.py's input form (acc and one
    (n_iters, ensembles) array per active parameter), with its summary."""
    np.savez(path, acc=summary["acceptance"], n_done=summary["n_iters"],
             summary=json.dumps(summary), **samples)


def load_leg(path, active):
    """(samples, summary) of a leg saved by save_leg."""
    samples, _, _ = read_chain(path, active)
    return samples, json.loads(str(np.load(path)["summary"]))


def _fmt(m, s, e):
    return f"10^({m:.4f} +/- {s:.4f}) ({e:.0f})"


def chain_runs(path):
    """A line on how an extended chain was walked (extend_oracle_torch.py
    records each run's first iteration, s per iteration and workers), or
    "" for a chain without that record."""
    z = np.load(path)
    if "resumed_at" not in z.files:
        return ""
    runs = "; ".join(
        f"from {int(a)}: {s:.3f} s an iteration on {int(n)} worker(s)"
        for a, s, n in zip(z["resumed_at"], z["s_per_iter"], z["workers"]))
    m = re.search(r"_ext_torch_(\d+)_", os.path.basename(path))
    target = int(m.group(1)) if m else None
    n = int(z["n_done"])
    moved = np.any([np.diff(z[k][N_COMMITTED - 1:n]) != 0 for k in z.files
                    if k in STAUB_NAMES], axis=0)
    short = (f" The extension's target was {target} iterations: it stopped "
             f"at {int(z['n_done'])}, short of it."
             if target and n < target else "")
    return (f"  Extended from the committed chain's {N_COMMITTED} iterations "
            f"by scripts/extend_oracle_torch.py (a fixed Gaussian proposal, "
            f"the committed chain's post-burn covariance x 2.38^2/10), in "
            f"runs resumed on fresh substreams: {runs}; acceptance past "
            f"{N_COMMITTED} {moved.mean():.3f}.{short}")


def report(w, legs, oracle_path=ORACLE_CHAIN, reproduce=""):
    """Markdown lines of the report. legs: leg name -> (samples,
    summary)."""
    oracle, acc_o, n_o = read_chain(oracle_path, w.active)
    runs = chain_runs(oracle_path)
    rows = comparison_rows(w, oracle, {n: s for n, (s, _) in legs.items()})
    cards = {s["card"] for _, s in legs.values()}
    card = "; ".join(sorted(cards))
    lines = [
        "# The flagship posterior on the card against the reference-math "
        "chain",
        "",
        "The PyTorch port (metrotrpl_tpu_torch) walks the flagship workload",
        "of scripts/posterior_compare.py (`apply_preset(\"flagship\")`: 6 "
        f"TRPL curves, nx={w.nx}, nt={w.nt}, t <= {w.t_end:.0f} ns,",
        f"noise sigma {w.unc} in log10, model uncertainty {w.sigma}, "
        f"{len(w.active)} active parameters from",
        "seeded off-truth starts) in the production tempered sampler, and "
        "compares its",
        "T=1 chains with the committed reference-math chain, as",
        "scripts/assemble_r09.py does. Every number of the port's legs was "
        "measured by",
        f"scripts/flagship_torch.py on {card}.",
        "",
        f"* **oracle**: {os.path.relpath(oracle_path, REPO)}, a serial "
        "float64 LSODA Metropolis chain",
        f"  (fixed Gaussian ridge proposal), {n_o} iterations (burn-in "
        f"{n_o // 3}), acceptance {acc_o:.3f}.",
        *([runs] if runs else []),
    ]
    for name, (_, s) in legs.items():
        lpi = ", ".join(f"{k} {v:.3f}" for k, v in
                        s["launches_per_iteration"].items() if v)
        rep = s["repaired_rows_per_iteration"]
        lines.append(
            f"* **port {name}** ({LEG_ROLE[name]}): {s['n_ensembles']} "
            f"ensembles x {s['n_temps']} temperatures (1, 2, 4, 8; a swap "
            f"round every 10) x {s['n_iters']} "
            f"iterations (burn-in {s['n_iters'] // 3}), hmax 48, chord "
            "blocks of 4, the escalation ladder inline with its float64 "
            f"rung; draw seeds {s['draw_seed']} + e; "
            f"cold-chain acceptance {s['acceptance']:.3f}; "
            f"{s['walker_steps_per_s']:.1f} walker-steps/s, "
            f"{s['ms_per_iteration']:.3f} ms an iteration past the initial "
            f"evaluation ({s['seconds']:.1f} s in all); "
            + (f"kernel launches per iteration {lpi}; rows repaired per "
               f"iteration {rep:.3f} of {s['rows_per_iteration']}"
               if rep is not None else "no kernel launched (the CPU)")
            + f"; dataset SHA-256 {s['dataset_sha256']}; on {s['card']}.")
    head = "| param | truth | oracle mean +/- sigma (ESS) |"
    rule = "|---|---|---|"
    for name in legs:
        head += (f" port {name} mean +/- sigma (ESS) | \\|z\\| {name} | "
                 f"\\|z_mc\\| {name} |")
        rule += "---|---|---|"
    lines += ["", head, rule]
    worst = {name: (0.0, 0.0) for name in legs}
    for r in rows:
        line = (f"| {r['param']} | {r['truth']:.4g} | "
                f"{_fmt(*r['oracle'])} |")
        for name in legs:
            m, s, e, z, z_mc = r[name]
            worst[name] = (max(worst[name][0], z), max(worst[name][1], z_mc))
            line += f" {_fmt(m, s, e)} | {z:.2f} | {z_mc:.2f} |"
        lines.append(line)
    lines.append("")
    for name, (z, z_mc) in worst.items():
        lines.append(f"Port {name}: largest |z| **{z:.2f}**, largest "
                     f"|z_mc| **{z_mc:.2f}**: {verdict(z, z_mc)}.")
    if {"f32", "f64"} <= set(legs):
        # the control: does float32 rounding move the posterior?
        zz = {r["param"]: pt.z_scores(*r["f64"][:3], *r["f32"][:3])
              for r in rows}
        p_z = max(zz, key=lambda p: zz[p][0])
        p_mc = max(zz, key=lambda p: zz[p][1])
        lines.append(f"Port f32 against the f64 control: largest |z| "
                     f"**{zz[p_z][0]:.2f}** ({p_z}), largest |z_mc| "
                     f"**{zz[p_mc][1]:.2f}** ({p_mc}).")
    mx_o, hi_o = ridge_lines(oracle)
    lines += ["", f"Ridge (post-burn): oracle max mu_n {mx_o:.2f}, share "
              f"above mu_n = {RIDGE_MU} {hi_o:.3f}."]
    for name, (smp, _) in legs.items():
        mx, hi = ridge_lines(smp)
        lines.append(f"Port {name}: max mu_n {mx:.2f}, share above mu_n = "
                     f"{RIDGE_MU} {hi:.3f}.")
    lines += ["", f"Reproduce: `{reproduce}`." if reproduce else ""]
    return lines


def ll_check_states(w, sources, n_states):
    """(n_states // len(sources) per source, P) states for the ll check:
    from each source (samples: active name -> (n,) draws, n, burn) the
    draws at np.linspace(burn, n - 1, n_states // len(sources)) as int
    (posterior_compare.run_ll_check's thinning); the inactive parameters
    at the truth."""
    parts = []
    for samples, n, burn in sources:
        idx = np.linspace(burn, n - 1, n_states // len(sources)).astype(int)
        parts.append({k: np.asarray(samples[k])[idx] for k in w.active})
    chosen = {k: np.concatenate([p[k] for p in parts]) for k in w.active}
    S = len(chosen[w.active[0]])
    return np.stack([chosen[k] if k in chosen else np.full(S, w.true[k])
                     for k in w.names], axis=1)


@contextlib.contextmanager
def kernel_events():
    """CUDA events around every launch of the solve kernel inside the
    block: yields a list that gets (dtype, start, end) per launch."""
    from metrotrpl_tpu_torch.solver import forward

    launch = forward.integrate_observables_cuda
    spans = []

    def timed(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = launch(*args, **kw)
        e1.record()
        spans.append((args[1].dtype, e0, e1))
        return out

    forward.integrate_observables_cuda = timed
    try:
        yield spans
    finally:
        forward.integrate_observables_cuda = launch


def card_ll(plan, states, device, chunk=LL_CHECK_CHUNK):
    """The leg's evaluation (make_eval_logll on its plan, a float32 walk
    with the float64 rung, T=1) of states (S, P), in chunks of `chunk`
    states. Returns (ll (S,), rows repaired per state (S,), one dict per
    chunk, each row's ll (S, M)). A chunk's dict: states, rows repaired,
    the std kernels' launches and rows by dtype, and on the card the
    evaluation's and each dtype's kernel ms by CUDA events; there the
    first chunk is evaluated once before, untimed, so that no time
    includes the kernel library's build."""
    from metrotrpl_tpu_torch.inference.likelihood import make_eval_logll
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    f32, f64 = torch.float32, torch.float64
    on_card = device.type == "cuda"
    ev = make_eval_logll(plan, dtype=f32, device=device)
    temps = torch.ones(1, dtype=f32, device=device)

    def run(block):
        o = ev(torch.as_tensor(block, dtype=f32, device=device), temps)
        return (o["logll_T"][:, 0].double().cpu().numpy(),
                o["repair_states"].cpu().numpy(),
                o["per_meas"][..., 0].double().cpu().numpy())

    if on_card:
        run(states[:chunk])
    lls, reps, rows, chunks = [], [], [], []
    for c0 in range(0, len(states), chunk):
        block = states[c0:c0 + chunk]
        sk.reset_launch_counts()
        c = {"states": len(block)}
        if on_card:
            torch.cuda.synchronize(device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with kernel_events() as spans:
                e0.record()
                ll, rep, row = run(block)
                e1.record()
                torch.cuda.synchronize(device)
            c["eval_ms"] = e0.elapsed_time(e1)
            c["kernel_ms"] = {
                str(d).split(".")[-1]: sum(a.elapsed_time(b)
                                           for dt, a, b in spans if dt == d)
                for d in (f32, f64)}
        else:
            ll, rep, row = run(block)
        c["repaired"] = int(rep.sum())
        for dl, d in (("f32", f32), ("f64", f64)):
            c[f"launches_{dl}"] = sk.LAUNCHES[("std", d)]
            c[f"rows_{dl}"] = sk.ROWS[("std", d)]
        lls.append(ll)
        reps.append(rep)
        rows.append(row)
        chunks.append(c)
    return (np.concatenate(lls), np.concatenate(reps), chunks,
            np.concatenate(rows))


def ll_table(ll_t, ll_o):
    """posterior_compare.run_ll_check's summary of d = ll_t - ll_o:
    {"q": |d| p50, p90, p99, max over the states finite in both,
    "scale": median |ll_o| there, "finite", "n", "over1", "over20",
    "suppress": states of the > 1 tail with ll_t < ll_o - 1}."""
    with np.errstate(invalid="ignore"):     # -inf - -inf: not finite
        d = ll_t - ll_o
    fin = np.isfinite(d)
    ad = np.abs(d[fin])
    return {"q": np.percentile(ad, [50, 90, 99, 100]),
            "scale": float(np.median(np.abs(ll_o[fin]))),
            "finite": int(fin.sum()), "n": len(d),
            "over1": int((ad > 1).sum()), "over20": int((ad > 20).sum()),
            "suppress": int((d[fin] < -1).sum())}


def ll_table_lines(tab):
    """run_ll_check's table row and its finite and tail sentences."""
    q, S = tab["q"], tab["n"]
    return [
        "| \\|dll\\| median | p90 | p99 | max | ll scale (median |ll|) |",
        "|---|---|---|---|---|",
        f"| {q[0]:.3f} | {q[1]:.3f} | {q[2]:.3f} | {q[3]:.3f} | "
        f"{tab['scale']:.0f} |",
        "",
        f"{tab['finite']}/{S} states finite in both"
        f" ({S - tab['finite']} -inf/diverged mismatches).",
        f"Tail: {tab['over1']}/{S} states exceed |dll| 1, "
        f"{tab['over20']}/{S} exceed 20"
        + (f"; of the >1 tail, {tab['suppress']}/{tab['over1']} SUPPRESS "
           "density (ll_tpu < ll_oracle), thinning the tpu walk there "
           "rather than attracting it" if tab["over1"] else "") + ".",
    ]


def file_states(mu_n, n=N_FILE_STATES):
    """Indices of n // 2 states above RIDGE_MU and n // 2 at or below it,
    each half evenly spaced through its states in the check's order."""
    idx = []
    for sel in (mu_n > RIDGE_MU, ~(mu_n > RIDGE_MU)):
        where = np.nonzero(sel)[0]
        if len(where) < n // 2:
            raise RuntimeError(f"{len(where)} states on one side of mu_n "
                               f"{RIDGE_MU}, want {n // 2}")
        idx += where[np.linspace(0, len(where) - 1, n // 2)
                     .astype(int)].tolist()
    return np.array(idx)


def ll_check(w, oracle_path, legs_dir, n_states, workers, device, card,
             states_out=LL_CHECK_STATES):
    """The flagship ll check: n_states states, a third each from the
    committed chain past its burn-in, the extended chain at oracle_path
    past the committed chain's length, and the saved f32 leg's flattened
    post-burn draws; each through the LSODA oracle (oracle_logll_states,
    `workers` spawned processes) and the leg's evaluation (card_ll).
    Writes the N_FILE_STATES states chip_smoke.py checks to states_out,
    with every state's source, ll and rows on both sides.
    Returns (the report's lines, whether the file was written)."""
    from esc_validation_torch import dll_percentiles, mu_band_masks

    committed, _, n_c = read_chain(ORACLE_CHAIN, w.active)
    ext, _, n_e = read_chain(oracle_path, w.active)
    if n_e <= N_COMMITTED:
        raise ValueError(f"{oracle_path} holds {n_e} iterations: the ll "
                         f"check wants a chain extended past {N_COMMITTED}")
    leg, _ = load_leg(os.path.join(legs_dir, "flagship_f32.npz"),
                         w.active)
    flat = {k: np.asarray(v)[len(v) // 3:].ravel() for k, v in leg.items()}
    n_f = len(flat[w.active[0]])
    sources = [(committed, n_c, n_c // 3), (ext, n_e, N_COMMITTED),
               (flat, n_f, 0)]
    labels = [f"the committed chain ({n_c} iterations, past {n_c // 3})",
              f"the extended chain ({os.path.relpath(oracle_path, REPO)}, "
              f"iterations {N_COMMITTED} to {n_e - 1})",
              f"the float32 leg's cold chains (post-burn, flattened: "
              f"{n_f} draws)"]
    states = ll_check_states(w, sources, n_states)
    S = len(states)
    per = S // len(sources)
    mu_n = states[:, w.names.index("mu_n")]
    t, vals, digest = checked_dataset(w)
    t0 = time.perf_counter()
    with pt.oracle_pool(workers) as pool:
        ll_o, rows_o = pt.oracle_logll_states(
            w, t, vals, [dict(zip(w.names, map(float, s))) for s in states],
            pool)
    oracle_s = time.perf_counter() - t0
    print(f"ll check: {S} oracle states in {oracle_s:.1f} s on {workers} "
          "worker(s)", flush=True)
    plan = pt.build_plans(w, t, vals, **{k: pt.LEGS["fast"][k] for k in (
        "hmax", "refactor", "refine")})[0]
    ll_t, rep, chunks, rows_t = card_ll(plan, states, device)
    with np.errstate(invalid="ignore"):
        d = ll_t - ll_o
    tab = ll_table(ll_t, ll_o)
    on_card = device.type == "cuda"
    lines = [
        "# Log-likelihood agreement on the flagship ridge, on the card",
        "",
        f"Pointwise |ll_card - ll_oracle| at {S} states ({per} from each "
        "source, thinned as posterior_compare.run_ll_check thins:",
        "`np.linspace(burn, n - 1, N // 3).astype(int)`), "
        f"{int((mu_n > RIDGE_MU).sum())} of them above mu_n = {RIDGE_MU} "
        "cm^2/Vs:",
        "",
        *[f"{i + 1}. {lb}: mu_n {mu_n[i * per:(i + 1) * per].min():.1f} to "
          f"{mu_n[i * per:(i + 1) * per].max():.1f}, "
          f"{int((mu_n[i * per:(i + 1) * per] > RIDGE_MU).sum())} above "
          f"{RIDGE_MU}" for i, lb in enumerate(labels)],
        "",
        "Card side: the float32 leg's own evaluation (make_eval_logll on the "
        "fast plan, hmax 48, chord",
        "blocks of 4, the escalation ladder inline with its float64 rung; "
        f"T=1) in chunks of {LL_CHECK_CHUNK} states x 6 rows,",
        f"on {card}. Oracle side: float64 LSODA reference math (the "
        f"compiled RHS), {workers} worker processes",
        f"on the host ({oracle_s:.1f} s). Flagship dataset SHA-256 "
        f"{digest}. sup |dll| = eps bounds the",
        "posterior density ratio by e^(2 eps) at these states, with no "
        "Monte-Carlo mixing error.",
        "",
        *ll_table_lines(tab),
        "",
        "By the state's mu_n band [cm^2/Vs] (esc_validation_torch.MU_BANDS):",
        "",
        "| mu_n band | states | rows repaired | p50 \\|dll\\| | p90 | p99 | "
        "max | finite |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for lb, sel in mu_band_masks(mu_n).items():
        q = dll_percentiles(d[sel])
        cell = ("- | - | - | - | 0" if q is None else
                " | ".join(f"{v:.3f}" for v in q[:4]) + f" | {q[4]}")
        lines.append(f"| {lb} | {int(sel.sum())} | {int(rep[sel].sum())} | "
                     f"{cell} |")
    lines += ["", "Per chunk of the card side ("
              + (f"CUDA events on {card}: the evaluation, and "
                 "the solve kernel's launches summed per dtype"
                 if on_card else "the plain PyTorch path, no card: no "
                 "launch, no time") + "):", "",
              "| chunk | states | mu_n | rows repaired | std f32 launches "
              "(rows) | std f64 launches (rows) | evaluation ms | kernel ms "
              "f32 | kernel ms f64 |", "|---|---|---|---|---|---|---|---|---|"]
    for i, c in enumerate(chunks):
        m = mu_n[i * LL_CHECK_CHUNK:i * LL_CHECK_CHUNK + c["states"]]
        ms = ([f"{c['eval_ms']:.3f}", f"{c['kernel_ms']['float32']:.3f}",
               f"{c['kernel_ms']['float64']:.3f}"] if on_card
              else ["not measured"] * 3)
        lines.append(f"| {i} | {c['states']} | {m.min():.1f}-{m.max():.1f} "
                     f"| {c['repaired']} | {c['launches_f32']} "
                     f"({c['rows_f32']}) | {c['launches_f64']} "
                     f"({c['rows_f64']}) | " + " | ".join(ms) + " |")
    tail = np.nonzero(~(np.abs(d) <= 1))[0]
    src = np.repeat(np.arange(len(sources)), per)
    lines += ["", f"The states with |dll| > 1 or not finite ({len(tail)}; "
              "source as numbered above; per-row dll = card - oracle of each "
              "curve, 311 / 2000 nm at the three fluences in turn):", "",
              "| state | source | mu_n | mu_p | oracle ll | card ll | dll | "
              "rows repaired | per-row dll |", "|---|---|---|---|---|---|---|"
              "---|---|"]
    for i in tail:
        with np.errstate(invalid="ignore"):
            dr = rows_t[i] - rows_o[i]
        lines.append(
            f"| {i} | {src[i] + 1} | {mu_n[i]:.2f} | "
            f"{states[i, w.names.index('mu_p')]:.2f} | {ll_o[i]:.3f} | "
            f"{ll_t[i]:.3f} | {d[i]:.3f} | {rep[i]} | "
            + ", ".join(f"{v:.3f}" for v in dr) + " |")
    try:
        pick = file_states(mu_n)
    except RuntimeError as e:       # the report stands; the file does not
        return lines + ["", f"No states file written: {e}."], False
    np.savez(states_out, names=np.array(w.names), states=states[pick],
             ll_o=ll_o[pick], mu_n=mu_n[pick], ll_card=ll_t[pick],
             dll=np.abs(d[pick]), repaired=rep[pick], picked=pick,
             all_states=states, all_source=src, all_ll_o=ll_o,
             all_rows_o=rows_o, all_ll_card=ll_t, all_rows_card=rows_t,
             all_repaired=rep)
    lines += ["", f"The {len(pick)} states chip_smoke.py phase 22 holds the "
              f"card to ({os.path.relpath(states_out, REPO)}): mu_n "
              + ", ".join(f"{v:.1f}" for v in mu_n[pick]) + "; |dll| "
              + ", ".join(f"{v:.4f}" for v in np.abs(d[pick])) + "."]
    return lines, True


def main(argv=None):
    from metrotrpl_tpu_torch.solver.kernel_times import nvidia_smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--legs", default="f32,f64")
    ap.add_argument("--save-chains", default=None, metavar="DIR",
                    help="save each leg to DIR/flagship_<leg>.npz")
    ap.add_argument("--assemble", default=None, metavar="DIR",
                    help="walk nothing: report the legs saved in DIR")
    ap.add_argument("--oracle", default=ORACLE_CHAIN, metavar="PATH",
                    help="the reference-math chain to compare with (its "
                         "draws to n_done); --ll-check takes its states past "
                         f"{N_COMMITTED} from it")
    ap.add_argument("--ll-check", type=int, default=0, metavar="N",
                    help="walk nothing: the ll check at N states, the f32 "
                         "leg's from --assemble DIR")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="oracle processes of --ll-check")
    ap.add_argument("--ll-states", default=LL_CHECK_STATES, metavar="PATH",
                    help=f"where --ll-check writes its {N_FILE_STATES} "
                         "states for chip_smoke.py")
    ap.add_argument("--out", default=None, help="the report (default: "
                    "docs/POSTERIOR_torch_flagship_h100.md, with --ll-check "
                    "docs/LL_AGREEMENT_torch_flagship_h100.md)")
    args = ap.parse_args(argv)
    w = flagship_workload()
    cmd = " ".join(["python scripts/flagship_torch.py"]
                   + (argv if argv is not None else sys.argv[1:]))
    if args.ll_check:
        if not args.assemble:
            ap.error("--ll-check takes the f32 leg saved by --save-chains "
                     "DIR: give --assemble DIR")
        device = resolve_device(args.device)
        card = (nvidia_smi_line() if device.type == "cuda"
                else "the CPU (plain PyTorch path, no card)")
        print(f"card: {card}", flush=True)
        lines, wrote = ll_check(w, args.oracle, args.assemble, args.ll_check,
                                args.workers, device, card, args.ll_states)
        lines += ["", f"Reproduce: `{cmd}`."]
        write_doc(lines, args.out or os.path.join(
            REPO, "docs", "LL_AGREEMENT_torch_flagship_h100.md"))
        if not wrote:
            sys.exit("the ll check wrote no states file")
        return
    legs = {}
    if args.assemble:
        for name in args.legs.split(","):
            legs[name] = load_leg(os.path.join(
                args.assemble, f"flagship_{name}.npz"), w.active)
    else:
        device = resolve_device(args.device)
        card = (nvidia_smi_line() if device.type == "cuda"
                else "the CPU (plain PyTorch path, no card)")
        print(f"card: {card}", flush=True)
        t0 = time.perf_counter()
        t, vals, digest = checked_dataset(w)
        print(f"dataset in {time.perf_counter() - t0:.1f} s, SHA-256 "
              f"{digest} (the oracle chain's)", flush=True)
        for name in args.legs.split(","):
            r = walk_leg(w, t, vals, name, N_ITERS, device,
                         log=lambda s: print(s, flush=True))
            summary = leg_summary(r, card, digest)
            print(f"flagship {name}: {json.dumps(summary)}", flush=True)
            legs[name] = (r["samples"], summary)
            if args.save_chains:
                os.makedirs(args.save_chains, exist_ok=True)
                save_leg(os.path.join(args.save_chains,
                                      f"flagship_{name}.npz"),
                         r["samples"], summary)
    reproduce = cmd
    if args.assemble:
        reproduce = (f"python scripts/flagship_torch.py --legs {args.legs} "
                     f"--save-chains {args.assemble}` on the card, then `"
                     + reproduce)
    write_doc(report(w, legs, args.oracle, reproduce=reproduce),
              args.out or os.path.join(
                  REPO, "docs", "POSTERIOR_torch_flagship_h100.md"))


def write_doc(lines, path):
    print("\n".join(lines), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
