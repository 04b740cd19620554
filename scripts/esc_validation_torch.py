#!/usr/bin/env python3
"""The escalation ladder's rows against the float64 LSODA oracle, on the
card (the port of scripts/esc_validation.py).

Post-burn states are thinned from a production walk's own chains, and
each (state, curve) row is evaluated three ways, all in a float32 walk on
the fast plan (hmax 48, chord blocks of 4):

* **escalate-free**: the plan without the escalation ladder, so every row
  is the fast solve's as it comes: its Newton residual, gate score and ll
  (JAX's escalate="off"; at nx >= 96 that mode also concedes a cap-pinned
  row outside the gate as -inf, where this one keeps its ll, and such a
  row is flagged by its residual either way);
* **inline**: the ladder inline, the ll the walk samples;
* **oracle**: the float64 LSODA reference math per row
  (``solve_reference(rhs="native")``), the rows spread over worker
  processes.

Rows fall into esc_validation.py's classes: flagged = ~(resid < tol) |
~isfinite(escalate-free ll), with tol the ladder's Newton threshold at the
plan's nx; repaired = flagged rows whose inline ll is finite; conceded =
flagged rows whose inline ll is -inf; unflagged = the rest. For each class
it reports the |dll| = |inline - oracle| percentiles p50/p90/p99/max, and
for the unflagged and repaired rows the same by the state's mu_n band.

Two shapes:

* **nx32**: scripts/posterior_torch.py's std workload (the ``full``
  preset, docs/ESC_VALIDATION_r11.md's shape), states from its fast leg,
  32 untempered chains x 20000 iterations, walked here;
* **nx128**: the flagship workload (scripts/flagship_torch.py), states from
  its float32 leg's cold chains, read from DIR/flagship_f32.npz, the file
  flagship_torch.py --save-chains DIR writes.

Usage:
    python scripts/esc_validation_torch.py --chains DIR [--workers N]
        [--device cuda|cpu] [--out docs/ESC_VALIDATION_torch_h100.md]
"""

import argparse
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

import flagship_torch as ft  # noqa: E402
import posterior_torch as pt  # noqa: E402
from metrotrpl_tpu_torch import resolve_device  # noqa: E402
from metrotrpl_tpu_torch.inference.likelihood import (  # noqa: E402
    ESCALATE_GATE_SCORE,
)

#: the mu_n bands [cm^2/Vs] of the unflagged and repaired rows: (label,
#: lower bound exclusive, upper bound inclusive)
MU_BANDS = (("<= 30", -np.inf, 30.0), ("30-40", 30.0, 40.0),
            ("40-50", 40.0, 50.0), ("> 50", 50.0, np.inf))
N_STATES = 192
SHAPES = ("nx32", "nx128")
CLASSES = ("unflagged", "repaired", "conceded")


def oracle_rows(w, t, vals, states, workers):
    """(n, M) oracle rows of each row of states (n, P)
    (posterior_torch.oracle_logll_states over `workers` spawned
    processes)."""
    with pt.oracle_pool(workers) as pool:
        return pt.oracle_logll_states(
            w, t, vals, [dict(zip(w.names, map(float, s))) for s in states],
            pool)[1]


def thin_states(w, samples, n_states):
    """(n_states, P) states evenly spaced through the post-burn (n/3)
    draws of every chain, flattened iteration-major
    (esc_validation.py:75-83); the inactive parameters at the truth."""
    flat = {k: np.asarray(s)[len(s) // 3:].ravel()
            for k, s in samples.items()}
    n = len(flat[w.active[0]])
    idx = np.linspace(0, n - 1, n_states).astype(int)
    return np.stack([[flat[k][i] if k in flat else w.true[k]
                      for k in w.names] for i in idx])


def evaluate_rows(w, t, vals, states, device):
    """The escalate-free and inline evaluations of states (n, P) in a
    float32 walk on the fast plan. Returns a dict of (n, M) arrays
    resid, score and ll_off (escalate-free), ll_in (inline) and the
    ladder's threshold tol."""
    from metrotrpl_tpu_torch.inference.likelihood import (
        make_eval_logll,
        newton_div_tol_default,
    )

    f32 = torch.float32
    c = pt.LEGS["fast"]
    x = torch.as_tensor(states, dtype=f32, device=device)
    temps = torch.ones(1, dtype=f32, device=device)
    out = {}
    for key, escalate in (("off", False), ("in", True)):
        plan = pt.build_plans(w, t, vals, c["hmax"], c["refactor"],
                              c["refine"], escalate=escalate)[0]
        r = make_eval_logll(plan, dtype=f32, device=device)(x, temps)
        out[f"ll_{key}"] = r["per_meas"][..., 0].double().cpu().numpy()
        if key == "off":
            out["resid"] = r["resid"].double().cpu().numpy()
            out["score"] = r["esc_score"].double().cpu().numpy()
        else:
            out["repair_rows"] = int(r["repair_states"].sum())
    out["tol"] = (plan.newton_div_tol if plan.newton_div_tol is not None
                  else newton_div_tol_default(w.nx))
    return out


def row_classes(resid, ll_off, ll_in, tol):
    """esc_validation.py's row classes: boolean (n, M) masks flagged,
    unflagged, repaired and conceded."""
    flagged = ~(resid < tol) | ~np.isfinite(ll_off)
    return {"flagged": flagged, "unflagged": ~flagged,
            "repaired": flagged & np.isfinite(ll_in),
            "conceded": flagged & ~np.isfinite(ll_in)}


def dll_percentiles(d):
    """(p50, p90, p99, max, n) of |d| over its finite entries, or None if
    there are none (esc_validation.py's q)."""
    d = d[np.isfinite(d)]
    if not len(d):
        return None
    p = np.percentile(np.abs(d), [50, 90, 99, 100])
    return (*map(float, p), len(d))


def mu_band_masks(mu_n):
    """label -> (n,) mask of the states in each mu_n band."""
    return {lb: (mu_n > lo) & (mu_n <= hi) for lb, lo, hi in MU_BANDS}


def _cell(q):
    return ("- | - | - | - | 0" if q is None else
            " | ".join(f"{v:.3f}" for v in q[:4]) + f" | {q[4]}")


def ll_level(label, w, states, ll_o):
    """A line on the reference-math ll of each state (its rows summed)."""
    ll = ll_o.sum(axis=1)
    mu_n = states[:, w.names.index("mu_n")]
    return (f"* {label}: {len(ll)} states, mu_n {mu_n.min():.1f} to "
            f"{mu_n.max():.1f}: oracle ll of a state median "
            f"{np.median(ll):.2f}, min {ll.min():.2f}, max {ll.max():.2f}")


def shape_section(label, w, source, states, ev, ll_o, card, ref=None):
    """Markdown lines of one shape's tables; ref = (label, states, their
    (n, M) oracle rows) of another chain's states, whose ll beside the
    walk's says whether the likelihood favours either region."""
    cls = row_classes(ev["resid"], ev["ll_off"], ev["ll_in"], ev["tol"])
    with np.errstate(invalid="ignore"):     # -inf - -inf: not a finite d
        d = ev["ll_in"] - ll_o
    n_states, M = ll_o.shape
    n_rows = ll_o.size
    mu_n = states[:, w.names.index("mu_n")]
    fin = np.isfinite(ll_o)
    gate = ev["score"] < ESCALATE_GATE_SCORE
    lines = [
        f"## {label}: nx={w.nx}, {M} TRPL curves, t <= {w.t_end:.0f} ns",
        "",
        f"{n_states} post-burn states thinned from {source}; each of the "
        f"{n_rows} rows evaluated escalate-free,",
        f"inline (float32 walk, the escalation ladder inline) on {card},",
        "and by the float64 LSODA oracle on the host's CPU.",
        "",
        f"* Newton threshold tol {ev['tol']:g}; flagged rows "
        f"**{int(cls['flagged'].sum())}** of {n_rows} "
        f"({cls['flagged'].mean():.3f}); "
        f"{int(cls['flagged'].any(axis=1).sum())} of {n_states} states "
        "carry at least one",
        f"* repaired {int(cls['repaired'].sum())}, conceded (-inf) "
        f"{int(cls['conceded'].sum())}, unflagged "
        f"{int(cls['unflagged'].sum())}; the ladder solved "
        f"{ev['repair_rows']} rows again; flagged rows outside the gate "
        f"(escalate-free score >= {ESCALATE_GATE_SCORE}: kept as the fast "
        f"solve left them) {int((cls['flagged'] & ~gate).sum())}",
        f"* oracle rows finite {int(fin.sum())} of {n_rows}; median "
        f"|oracle ll| a row "
        f"{np.median(np.abs(ll_o[fin])) if fin.any() else np.nan:.1f}",
        ll_level("the walk's states", w, states, ll_o),
        *([ll_level(ref[0], w, ref[1], ref[2])] if ref else []),
        "",
        "| rows | p50 \\|dll\\| | p90 | p99 | max | n |",
        "|---|---|---|---|---|---|",
    ]
    for c in CLASSES:
        lines.append(f"| {c} | {_cell(dll_percentiles(d[cls[c]]))} |")
    # a row the ladder solved again comes back with other bits (at nx >=
    # 96 the mobility trigger re-solves unflagged rows too)
    again = ev["ll_in"] != ev["ll_off"]
    lines += ["", "By the state's mu_n band [cm^2/Vs] (states in the band; "
              "rows of the class the ladder solved again):", "",
              "| rows | mu_n band (states) | solved again | p50 \\|dll\\| "
              "| p90 | p99 | max | n |", "|---|---|---|---|---|---|---|---|"]
    for c in ("unflagged", "repaired"):
        for lb, sel in mu_band_masks(mu_n).items():
            rows = cls[c] & sel[:, None]
            lines.append(f"| {c} | {lb} ({int(sel.sum())}) | "
                         f"{int((rows & again).sum())} | "
                         f"{_cell(dll_percentiles(d[rows]))} |")
    lines.append("")
    return lines


def shape_states(shape, chains, device, log):
    """A shape's workload w, dataset t and vals, thinned states, the text
    naming their source, and ref: None, or (label, samples) of the
    committed oracle chain of the flagship workload."""
    if shape == "nx32":
        w = pt.std_workload()
        t, vals = pt.make_dataset(w)
        r = pt.run_leg(w, t, vals, "fast", w.n_iters, pt.N_CHAINS, device,
                       log=log)
        src = (f"posterior_torch.py's std fast leg ({pt.N_CHAINS} "
               f"untempered chains x {w.n_iters} iterations, acceptance "
               f"{r['acceptance']:.3f})")
        return dict(w=w, t=t, vals=vals, source=src, ref=None,
                    states=thin_states(w, r["samples"], N_STATES))
    w = ft.flagship_workload()
    samples, s = ft.load_leg(os.path.join(chains, "flagship_f32.npz"),
                             w.active)
    t, vals, _ = ft.checked_dataset(w)
    src = (f"the flagship float32 leg's cold chains ({ft.N_ENSEMBLES} "
           f"ensembles x {ft.N_TEMPS} temperatures x {s['n_iters']} "
           f"iterations, cold-chain acceptance {s['acceptance']:.3f})")
    oracle = ft.read_chain(ft.ORACLE_CHAIN, w.active)[0]
    return dict(w=w, t=t, vals=vals, source=src,
                states=thin_states(w, samples, N_STATES),
                ref=("states thinned from the committed oracle chain's "
                     "post-burn draws", oracle))


def main(argv=None):
    from metrotrpl_tpu_torch.solver.kernel_times import nvidia_smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", required=True, metavar="DIR",
                    help="read the nx128 states from DIR/flagship_f32.npz "
                         "(flagship_torch.py --save-chains DIR)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "ESC_VALIDATION_torch_h100.md"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = (nvidia_smi_line() if device.type == "cuda"
            else "the CPU (plain PyTorch path, no card)")
    print(f"card: {card}", flush=True)
    sections = []
    for shape in SHAPES:
        t0 = time.perf_counter()
        sh = shape_states(shape, args.chains, device,
                          lambda s: print(s, flush=True))
        w, t, vals, states = sh["w"], sh["t"], sh["vals"], sh["states"]
        print(f"{shape}: states in {time.perf_counter() - t0:.1f} s",
              flush=True)
        ev = evaluate_rows(w, t, vals, states, device)
        t0 = time.perf_counter()
        ll_o = oracle_rows(w, t, vals, states, args.workers)
        ref = None
        if sh["ref"]:
            label, samples = sh["ref"]
            ref_states = thin_states(w, samples, N_STATES // 4)
            ref = (label, ref_states,
                   oracle_rows(w, t, vals, ref_states, args.workers))
        print(f"{shape}: {ll_o.size} oracle rows and those of the oracle "
              f"chain's states in {time.perf_counter() - t0:.1f} s on "
              f"{args.workers} worker(s)", flush=True)
        lines = shape_section(shape, w, sh["source"], states, ev, ll_o,
                              card, ref)
        print("\n".join(lines), flush=True)
        sections += lines
    reproduce = " ".join(["python scripts/esc_validation_torch.py"]
                         + (argv if argv is not None else sys.argv[1:]))
    doc = [
        "# The escalation ladder's rows against the float64 oracle, on the "
        "card",
        "",
        "The port of scripts/esc_validation.py: each (state, curve) row of",
        "the port's float32 walk, escalate-free and with the ladder inline,",
        "against the float64 LSODA oracle (reference math). Classes as in",
        "docs/ESC_VALIDATION_r11.md: flagged = ~(resid < tol) | the",
        "escalate-free ll not finite; repaired = flagged and the inline ll",
        "finite; conceded = flagged and the inline ll -inf. |dll| = |inline",
        "ll - oracle ll| of a row, in log-likelihood units. Every number",
        f"below was measured by scripts/esc_validation_torch.py on {card}",
        "(the oracle on the host's CPU).",
        "",
        *sections,
        f"Reproduce: `{reproduce}`.",
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(doc) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
