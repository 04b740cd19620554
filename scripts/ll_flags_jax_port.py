"""The flagship ll check's states through the JAX package's float32
evaluation and the port's, on the CPU: which rows each escalation ladder
flags, and how far each side's rows are from the float64 LSODA oracle.

    JAX_PLATFORMS=cpu python scripts/ll_flags_jax_port.py
        [--states scripts/.ll_check_states_torch.npz]
        [--out docs/LL_FLAGS_jax_port_flagship_cpu.md]

The states are every state of the ll check's file (`flagship_torch.py
--ll-check N --ll-states FILE`, which also holds each state's oracle rows
and the card's rows). Each goes through the fast plan (hmax 48, chord blocks of 4, the float64 rung) of
the flagship workload, float32 walk, four ways:

* the port's `make_eval_logll`, plain PyTorch path: without the ladder
  (its Newton residual and gate score per row) and with it (its rung's
  row mask, the argument of the ladder's `torch.nonzero`, and each row's
  ll);
* the JAX package's `make_eval_logll`, XLA path: `escalate="off"` (its
  residual, gate score, `fail_states` and conceded rows) and
  `escalate="inline"` (each row's ll). Its row mask is the ladder's
  predicate read from the "off" outputs, as scripts/rung_real_data.py
  reads it, and is checked against its own `fail_states`.

The port's fast plan in float64 (same ladder) stands beside them: a row
that is right there and wrong in float32 is a float32 failure of the
fast solve. Writes the counts over every row, and a table of the states
and one of the rows that are more than 1 from the oracle on any side.
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

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import flagship_torch as ft  # noqa: E402
import posterior_torch as pt  # noqa: E402
from metrotrpl_tpu.inference import likelihood as jl  # noqa: E402
from metrotrpl_tpu_torch.inference import likelihood as tl  # noqa: E402
from rung_real_data import _NonzeroSpy  # noqa: E402

#: the ll check's curves in row order
CURVES = [f"{L:g} nm / fluence {i // 2 + 1}"
          for i, L in enumerate([311.0, 2000.0] * 3)]


def port_rows(plan_off, plan_in, states, dtype):
    """The port's plain evaluation of states (K, P) in a `dtype` walk:
    {"resid", "score" (escalate-free), "mask" (the rung's rows), "ll"
    (with the ladder)}, each (K, M)."""
    x = torch.as_tensor(states, dtype=dtype)
    one = torch.ones(1, dtype=dtype)
    off = tl.make_eval_logll(plan_off, dtype=dtype, device="cpu")(x, one)
    spy = _NonzeroSpy()
    tl.torch = spy
    try:
        inl = tl.make_eval_logll(plan_in, dtype=dtype, device="cpu")(x, one)
    finally:
        tl.torch = torch
    K, M = inl["per_meas"].shape[:2]
    mask = (spy.masks[0].reshape(K, M).numpy() if spy.masks
            else np.zeros((K, M), bool))
    return {"resid": off["resid"].double().numpy(),
            "score": off["esc_score"].double().numpy(), "mask": mask,
            "ll": inl["per_meas"][..., 0].double().numpy(),
            "repair_states": inl["repair_states"].numpy()}


def jax_rows(jplan, states, mu):
    """The JAX package's XLA evaluation of states (K, P), float32 walk:
    the "off" outputs, its ladder's row mask (conceded there, or over the
    mobility trigger inside the score gate) and the "inline" rows' ll."""
    res = {}
    for mode in ("off", "inline"):
        ev = jax.jit(jl.make_eval_logll(jplan, dtype=jnp.float32,
                                        escalate=mode))
        res[mode] = jax.tree.map(np.asarray, ev(
            jnp.asarray(states, jnp.float32), jnp.ones(1, jnp.float32)))
    off = res["off"]
    score = off["esc_score"].astype(float)
    gate = score < float(jplan.esc_gate_score)
    conceded = ~np.isfinite(off["per_meas"][..., 0])
    mask = conceded | ((mu > jl.ESCALATE_MU_MODEL)[:, None] & gate)
    return {"resid": off["resid"].astype(float), "score": score,
            "mask": mask, "conceded": conceded,
            "fail_states": off["fail_states"].astype(int),
            "ll": res["inline"]["per_meas"][..., 0].astype(float)}


def _curves(mask):
    return ", ".join(str(m + 1) for m in np.nonzero(mask)[0]) or "none"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--states", default=ft.LL_CHECK_STATES)
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "LL_FLAGS_jax_port_flagship_cpu.md"))
    args = ap.parse_args(argv)

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    z = np.load(args.states)
    names = [str(n) for n in z["names"]]
    states = z["all_states"]
    rows_o, rows_c = z["all_rows_o"], z["all_rows_card"]
    source = z["all_source"]
    S, M = rows_o.shape

    w = ft.flagship_workload()
    assert names == w.names, "the states file is not the flagship's"
    t, vals, digest = ft.checked_dataset(w)
    fast = {k: pt.LEGS["fast"][k] for k in ("hmax", "refactor", "refine")}
    plan_in = pt.build_plans(w, t, vals, **fast)[0]
    plan_off = pt.build_plans(w, t, vals, **fast, escalate=False)[0]
    jplan = jl.build_likelihood_plan(
        *pt.plan_inputs(w, t, vals), hmax=fast["hmax"], align_outputs=False,
        refactor_every=fast["refactor"], refine=fast["refine"])
    tol = (plan_in.newton_div_tol if plan_in.newton_div_tol is not None
           else tl.newton_div_tol_default(w.nx))
    gate = float(jplan.esc_gate_score)
    mu_n = states[:, names.index("mu_n")]
    mu_si = np.maximum(mu_n * w.uc["mu_n"],
                       states[:, names.index("mu_p")] * w.uc["mu_p"])

    t0 = time.perf_counter()
    port = port_rows(plan_off, plan_in, states, torch.float32)
    port64 = port_rows(plan_off, plan_in, states, torch.float64)
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jx = jax_rows(jplan, states, mu_si)
    jax_s = time.perf_counter() - t0
    agree = bool((jx["mask"].sum(axis=1) == jx["fail_states"]).all())
    sides = {"card": rows_c, "port": port["ll"], "jax": jx["ll"],
             "port64": port64["ll"]}
    with np.errstate(invalid="ignore"):
        dd = {k: v - rows_o for k, v in sides.items()}
    dll = {k: np.sum(v, axis=1) for k, v in dd.items()}
    far = {k: ~(np.abs(v) <= 1) for k, v in dd.items()}
    any_far = np.logical_or.reduce(list(far.values()))
    below = mu_n <= 40

    def count(mask):
        return f"{int(mask.sum())} ({int((mask & below[:, None]).sum())})"

    lines = [
        "# The ll check's states: the JAX ladder and the port's, on the "
        "CPU",
        "",
        "`JAX_PLATFORMS=cpu python scripts/ll_flags_jax_port.py` (the "
        f"host's CPU, no card; port {port_s:.1f} s, JAX {jax_s:.1f} s with "
        f"its compiles). The {S} states of "
        f"`{os.path.relpath(args.states, REPO)}` ({int(below.sum())} at mu_n"
        " <= 40; sources: 1 the committed chain, 2 the extended chain, 3 the"
        " float32 leg), through the flagship fast plan (hmax 48, chord "
        "blocks of 4, the float64 rung) in a float32 walk: the port's plain"
        " PyTorch path and the JAX package's XLA path, both on the host, "
        "with the card's rows (from the states file) and the port's fast "
        "plan in float64 beside them. dll = side - float64 LSODA oracle. A "
        "row is flagged when the ladder solves it again. Newton tolerance "
        f"{tol:g}, gate score < {gate:g}; dataset SHA-256 {digest}. JAX's "
        "row mask (conceded by \"off\", or over the mobility trigger inside"
        " the gate) " + ("equals" if agree else "does NOT equal")
        + " its own `fail_states` at every state.",
        "",
        f"Rows of {S * M} (in brackets: of the {int(below.sum()) * M} at mu_n"
        " <= 40):",
        "",
        "| side | more than 1 from the oracle | flagged | flagged and more "
        "than 1 off | escalate-free residual over the tolerance | of those "
        "outside the gate |",
        "|---|---|---|---|---|---|",
    ]
    for k, lb in (("card", "the card (port, float32)"),
                  ("port", "the port on the host (float32)"),
                  ("jax", "JAX on the host (float32)"),
                  ("port64", "the port on the host (float64)")):
        flags = {"card": None, "port": port, "jax": jx,
                 "port64": port64}[k]
        if flags is None:     # the states file keeps rows repaired a state
            rep = z["all_repaired"]
            cells = [f"{int(rep.sum())} ({int(rep[below].sum())})"]
            cells += ["not recorded"] * 3
        else:
            over = ~(flags["resid"] < tol)
            cells = [count(flags["mask"]), count(flags["mask"] & far[k]),
                     count(over), count(over & ~(flags["score"] < gate))]
        lines.append(f"| {lb} | {count(far[k])} | " + " | ".join(cells)
                     + " |")
    lines += [
        "",
        "Rows flagged by both the port and JAX on the host: "
        f"{count(port['mask'] & jx['mask'])}.",
        "",
        "The states with a row more than 1 from the oracle on any side:",
        "",
        "| state | source | mu_n | rows flagged: port | JAX | dll card | "
        "dll port (host) | dll JAX (host) | dll port float64 |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for i in np.nonzero(any_far.any(axis=1))[0]:
        lines.append(
            f"| {i} | {source[i] + 1} | {mu_n[i]:.2f} | "
            f"{_curves(port['mask'][i])} | {_curves(jx['mask'][i])} | "
            + " | ".join(f"{dll[k][i]:.3f}"
                         for k in ("card", "port", "jax", "port64")) + " |")
    lines += [
        "",
        "Their rows more than 1 from the oracle on any side (curves 1-6: "
        + ", ".join(f"{m + 1} = {c}" for m, c in enumerate(CURVES))
        + "; residual and gate score of the escalate-free solve):",
        "",
        "| state | curve | dll card | port | JAX | port float64 | resid "
        "port | resid JAX | score port | score JAX | flagged port / JAX |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for i, m in zip(*np.nonzero(any_far)):
        lines.append(
            f"| {i} | {m + 1} | "
            + " | ".join(f"{dd[k][i, m]:.3f}"
                         for k in ("card", "port", "jax", "port64"))
            + f" | {port['resid'][i, m]:.3g} | {jx['resid'][i, m]:.3g} | "
            f"{port['score'][i, m]:.3g} | {jx['score'][i, m]:.3g} | "
            f"{'yes' if port['mask'][i, m] else 'no'} / "
            f"{'yes' if jx['mask'][i, m] else 'no'} |")
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
