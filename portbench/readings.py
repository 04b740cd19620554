#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's numbers and
the control's, at the cell's own size, on several seeds in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3
        [--seconds 10] [--out DIR] [--evidence-only] [--fault NAME]
    python3 portbench/readings.py --workload <cell> --judge DIR
        [--device cpu] [--block 64] [--no-control]

For each seed: the cell's set-up and a measured window of ``--seconds``
(a short one: long enough to compare as many states as a run does), then
what a run's check draws from the window (check.walk_evidence /
dense_samples), judged by the reference and by the control: the
reference computed in the nearest precision below the configuration's
(its float64 rung in float32), put in the program's place at the same
states and proposals. Prints one JSON line per seed and writes the
evidence and both log-likelihoods to ``DIR/<cell>_<seed>[_<fault>].npz``.

``--evidence-only`` runs the program and writes its evidence without
judging it; ``--judge DIR`` judges every evidence file of the cell in
DIR on ``--device``, so that the reference's time is spent off the card
(a file judged before keeps its reference's and control's ll).
``--fault`` plants one of FAULTS in a walk cell's program once set-up is
done. Walking needs the card; the benchmark's runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path
from time import perf_counter

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common  # noqa: E402

#: faults a walk cell can have, planted in the program after set-up
FAULTS = ("reject-all", "no-swap")


def plant(fault):
    """Break the walk's timed path underneath; returns the switch that
    turns the fault on (after set-up).

    reject-all: every proposal's log-likelihood comes back 1e4 too low,
    so the walk rejects every proposal; no-swap: every swap round leaves
    the ensemble as it is."""
    from metrotrpl_tpu_torch.inference import metropolis, mh_core

    on = {"v": False}
    if fault == "reject-all":
        make = metropolis.make_eval_logll

        def broken(plan, **kw):
            ev = make(plan, **kw)

            def f(states, temps):
                r = ev(states, temps)
                if on["v"]:
                    r = dict(r, logll_T=r["logll_T"] - 1e4)
                return r
            return f
        metropolis.make_eval_logll = broken
    elif fault == "no-swap":
        swap = mh_core.swap_perm_round

        def broken_swap(st, ll, swap_i, swap_u):
            out = swap(st, ll, swap_i, swap_u)
            return (st, ll) + tuple(out[2:]) if on["v"] else out
        mh_core.swap_perm_round = broken_swap
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    return on


def walk_evidence(cell, inputs, setup, seed, seconds, dev, on=None):
    import torch

    from portbench.harness import check
    from portbench.harness.walk import Walk

    w = Walk(cell, inputs, seed, dev)
    w.warm_up()
    if on is not None:
        on["v"] = True
    iters, dt = w.measure(seconds)
    rate = w.rate(iters, dt)
    hist = w.history()
    seeds, dtype = w.seeds, w.dtype
    w.free()
    del w
    torch.cuda.empty_cache()
    ev = check.walk_evidence(setup, hist, seeds, dtype, dev, seed)
    if on is not None:
        on["v"] = False
    return ev, rate


def walk_readings(ev, L, C, temps):
    """The program's numbers (reference ll L) and the control's (its ll
    C, where given) from a walk's evidence; both (N, K) at walk_batch's
    states."""
    from portbench.harness import check

    rec = check.walk_numbers(ev, L, temps)
    rec["moves_wrong"] = check.moves_wrong(ev)
    if C is None:
        return rec
    ctl = check.walk_numbers(
        ev, L, temps, acc=check.accepts(ev["u_acc"], check.prop_lls(ev, C),
                                        ev["prev_ll"].astype(np.float64)))
    n_s = len(ev["s_c"])
    idx = (np.arange(n_s), ev["s_c"])
    g = check.gaps(C[idx], L[idx], temps[ev["s_c"]])
    fin = np.isfinite(C[idx])
    rec["ctl_ll_off_share"] = float(np.mean(g > 1))
    rec["ctl_ll_off_share_finite"] = float(np.mean(g[fin] > 1)) \
        if fin.any() else None
    rec["ctl_accepts_missed"] = ctl.get("accepts_missed")
    off = g > 1
    rec["ctl_off_neginf"] = int(np.sum(off & ~fin))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=str(common.CACHE_DIR / "readings"))
    ap.add_argument("--evidence-only", action="store_true")
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--judge")
    ap.add_argument("--device")
    ap.add_argument("--no-control", action="store_true",
                    help="judge by the reference alone")
    ap.add_argument("--block", type=int, default=256,
                    help="states the reference takes at a time (its IRF "
                         "stage's conv1d on a CPU wants a few)")
    ap.add_argument("--root", default=str(common.REPO_DIR),
                    help="the checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args(argv)
    common.pin_cache_dirs()
    import torch

    from portbench.harness import check, outcome

    cell = common.Cell(args.workload, root=args.root)
    dev = args.device or outcome.DEVICE
    setup, ref_mod = cell.setup(), cell.reference
    temps = np.asarray(setup.temps, dtype=float)
    f32 = torch.float32
    ctl_prec = dict(fast_dtype=f32, rung_dtype=f32, cmp_dtype=f32)
    out = Path(args.out)
    walk = cell.traffic["mode"] == "walk"

    if args.judge:
        for f in sorted(Path(args.judge).glob(f"{args.workload}_*.npz")):
            if f.stem.endswith("_judged"):
                continue
            d = dict(np.load(f))
            t0 = perf_counter()
            rec = {"workload": args.workload, "file": f.name}
            judged = f.with_name(f.stem + "_judged.npz")
            if judged.is_file():
                # judged before: the reference's and the control's ll
                j = np.load(judged)
                L, C = j["L"], j["C"] if "C" in j else None
            else:
                states, _ = check.walk_batch(d)
                L = check.reference_lls(ref_mod, setup, states, dev,
                                        block=args.block)
                C = None if args.no_control else check.reference_lls(
                    ref_mod, setup, states, dev, block=args.block,
                    **ctl_prec)
                np.savez(judged, L=L, **({} if C is None else {"C": C}),
                         **d)
            rec.update(walk_readings(d, L, C, temps))
            rec["judge_s"] = perf_counter() - t0
            print(json.dumps(rec), flush=True)
        return

    on = plant(args.fault) if args.fault else None
    outcome.load_library()
    inputs = common.program_inputs(cell)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"_{args.fault}" if args.fault else ""
    for seed in [int(s) for s in args.seeds.split(",")]:
        rec = {"workload": args.workload, "seed": seed, "fault": args.fault}
        if walk:
            ev, rec["rate"] = walk_evidence(cell, inputs, setup, seed,
                                            args.seconds, dev, on)
            if args.evidence_only:
                np.savez(out / f"{args.workload}_{seed}{tag}.npz", **ev)
                print(json.dumps(rec), flush=True)
                continue
            t_ref = perf_counter()
            states, _ = check.walk_batch(ev)
            L = check.reference_lls(ref_mod, setup, states, dev)
            C = check.reference_lls(ref_mod, setup, states, dev, **ctl_prec)
            rec.update(walk_readings(ev, L, C, temps))
            np.savez(out / f"{args.workload}_{seed}{tag}_judged.npz", L=L,
                     C=C, **ev)
        else:
            from portbench.harness.dense import Dense

            d = Dense(cell, inputs, seed, dev)
            d.warm_up()
            n, dt = d.measure(args.seconds)
            rec["rate"] = n / dt
            X, P = d.samples()
            del d
            torch.cuda.empty_cache()
            states, prog = check.dense_samples(X, P, check.N_TOP)
            t_ref = perf_counter()
            ref = check.reference_lls(ref_mod, setup, states, dev)[:, 0]
            ctl = check.reference_lls(ref_mod, setup, states, dev,
                                      **ctl_prec)[:, 0]
            g, g_ctl = check.gaps(prog, ref), check.gaps(ctl, ref)
            rec["ll_off_share"] = float(np.mean(g > 1))
            rec["ctl_ll_off_share"] = float(np.mean(g_ctl > 1))
            fin = np.isfinite(ctl)
            rec["ctl_ll_off_share_finite"] = float(np.mean(g_ctl[fin] > 1)) \
                if fin.any() else None
            np.savez(out / f"{args.workload}_{seed}.npz", states=states,
                     prog=prog, ref=ref, ctl=ctl)
        rec["check_s"] = perf_counter() - t_ref
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
