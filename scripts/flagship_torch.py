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
        [--save-chains DIR]
        [--out docs/POSTERIOR_torch_flagship_h100.md]
    python scripts/flagship_torch.py --assemble DIR [--out ...]

The first form walks each leg in --legs on the card (the default),
saving each one's cold chains and numbers to DIR/flagship_<leg>.npz when
--save-chains is given (scripts/esc_validation_torch.py reads the f32
leg's), and writes the report to --out. The second walks nothing: it
writes the report from the legs saved in DIR.
"""

import argparse
import hashlib
import json
import os
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


def report(w, legs, oracle_path=ORACLE_CHAIN, reproduce=""):
    """Markdown lines of the report. legs: leg name -> (samples,
    summary)."""
    oracle, acc_o, n_o = read_chain(oracle_path, w.active)
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


def main(argv=None):
    from metrotrpl_tpu_torch.solver.kernel_times import nvidia_smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--legs", default="f32,f64")
    ap.add_argument("--save-chains", default=None, metavar="DIR",
                    help="save each leg to DIR/flagship_<leg>.npz")
    ap.add_argument("--assemble", default=None, metavar="DIR",
                    help="walk nothing: report the legs saved in DIR")
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "POSTERIOR_torch_flagship_h100.md"))
    args = ap.parse_args(argv)
    w = flagship_workload()
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
    reproduce = " ".join(["python scripts/flagship_torch.py"]
                         + (argv if argv is not None else sys.argv[1:]))
    if args.assemble:
        reproduce = (f"python scripts/flagship_torch.py --legs {args.legs} "
                     f"--save-chains {args.assemble}` on the card, then `"
                     + reproduce)
    lines = report(w, legs, reproduce=reproduce)
    print("\n".join(lines), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
