"""The float64 escalation rung on the real staub data: which rows the port
repairs, against the JAX package's ladder, and how right the repaired
rows are.

    JAX_PLATFORMS=cpu python scripts/rung_real_data.py [--states 8]
        [--seed 0] [--spread 0.1]

On the CPU: the `write-real-example --fast` config (the measured MAPI
decays in Inputs/, density-mode profiles, 3 curves of 141 points to
4248 ns, nx=128, the float64 rung on), its plan built by the JAX package
and carried to the port (`convert.from_reference_plan`), and N states
+-spread dex around the config's guess on the active parameters (seeded
numpy). A float32 walk's evaluation of those states, both ways:

* the port's `make_eval_logll` (float32, plain PyTorch path): its rung's
  row mask (the argument of the ladder's `torch.nonzero`), its
  `repair_states` and `esc_score`, its post-repair per-curve ll;
* the JAX package's `make_eval_logll` (float32, XLA path) with
  `escalate="off"`, whose `fail_states` counts the rows its inline ladder
  repairs and whose `esc_score` is the same gate score, and with
  `escalate="inline"` for its post-repair per-curve ll. JAX's row mask
  is the ladder's predicate read from the "off" outputs: a row is
  repaired iff it is conceded there (non-finite ll: static, cap-pinned or
  gated residual failures) or it trips the high-mobility trigger inside
  the score gate.

Then every row is solved by the port's float64 LSODA oracle
(`solve_reference(..., rhs="native")`) and put through the port's own
compare pipeline; each side's final ll (and the port's fast plan in
float64) is held against it. Prints one line per row and a summary.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from metrotrpl_tpu.inference import likelihood as jl  # noqa: E402
from metrotrpl_tpu_torch.cli import main as tcli  # noqa: E402
from metrotrpl_tpu_torch.config import (  # noqa: E402
    get_data,
    get_initpoints,
    read_config,
)
from metrotrpl_tpu_torch.convert import from_reference_plan  # noqa: E402
from metrotrpl_tpu_torch.inference import likelihood as tl  # noqa: E402
from metrotrpl_tpu_torch.oracle import solve_reference  # noqa: E402


class _NonzeroSpy:
    """Stands in for ``torch`` inside the port's likelihood module and
    keeps the argument of every ``torch.nonzero`` (the ladder's row
    mask)."""

    def __init__(self):
        self.masks = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def nonzero(self, x, *a, **k):
        self.masks.append(x.clone())
        return torch.nonzero(x, *a, **k)


def real_config(work):
    """The write-real-example --fast config, its data and profiles."""
    cfg = os.path.join(work, "real.txt")
    tcli(["write-real-example", cfg, "--fast", "--init-cond",
          os.path.join(REPO, "Inputs", "real_staub_input.csv"),
          "--measurement",
          os.path.join(REPO, "Inputs", "real_staub_aug_corr_renoised.csv"),
          "--output", os.path.join(work, "out")])
    sim_info, pi, flags, mcmc = read_config(cfg)
    e_data = get_data(mcmc["measurement_path"], flags, mcmc)
    ini = get_initpoints(mcmc["init_cond_path"], flags)
    return sim_info, pi, mcmc, e_data, ini


def oracle_ll(tplan, states, rows, compare):
    """The port's compare-pipeline ll (T = 1) of the float64 LSODA
    oracle's curve for each (state, measurement) row in rows."""
    M = tplan.n_meas
    g_idx, fp, _ = tplan.fwd[0]
    init_dN, raw = tl.expand_states(
        tplan, g_idx, torch.as_tensor(fp.x_centers), torch.as_tensor(states),
        torch.as_tensor(tplan.init_profiles), torch.as_tensor(tplan.units))
    one = torch.ones(1, dtype=torch.float64)
    out = []
    for k, m in rows:
        r = k * M + m
        ok = np.asarray(tplan.exp_mask[m], dtype=bool)
        t = np.asarray(tplan.exp_times[m], dtype=float)[ok]
        t_out = np.concatenate([[0.0], t]) if t[0] > 0 else t
        pl = solve_reference(init_dN[r].numpy(), fp.dx[m] * fp.nx, fp.nx,
                             t_out, {n: float(v[r]) for n, v in raw.items()},
                             rhs="native")[-len(t):]
        # the pipeline is row-wise over a (states x M) layout: one state
        # whose measurement m holds the oracle's curve
        sol = torch.ones((M, tplan.exp_times.shape[1]), dtype=torch.float64)
        sol[m, np.nonzero(ok)[0]] = torch.as_tensor(pl)
        out.append(float(compare(sol, torch.zeros(M, dtype=torch.float64),
                                 one)[m, 0]))
    return np.array(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--states", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spread", type=float, default=0.1)
    args = ap.parse_args(argv)

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with tempfile.TemporaryDirectory() as work:
        sim_info, pi, mcmc, e_data, ini = real_config(work)
    hm, align = jl.resolve_solver_mode(mcmc, 4.0)
    jplan = jl.build_likelihood_plan(
        sim_info, pi, mcmc, e_data, ini, hmax=hm, align_outputs=align,
        refactor_every=mcmc["refactor_every"])
    tplan = from_reference_plan(jplan)
    g_idx, fp, fp_hi = tplan.fwd[0]
    assert fp.nx == 128 and fp_hi.solve_dtype == "float64", "not the rung"
    M = tplan.n_meas
    names = list(tplan.param_names)
    base = np.array([pi["init_guess"][n] for n in names], dtype=float)
    active = np.array([bool(pi["active"][n]) for n in names])
    rng = np.random.default_rng(args.seed)
    states = base[None] * 10.0 ** (
        rng.uniform(-args.spread, args.spread, (args.states, len(names)))
        * active[None])
    K = len(states)
    print(f"real staub plan: {M} curves, nx={fp.nx}, fast {fp.n_steps} "
          f"steps, rung {fp_hi.n_steps} steps (float64); {K} states "
          f"+-{args.spread} dex (seed {args.seed}); float32 walk")

    # the port, plain PyTorch path on the CPU
    f32 = torch.float32
    spy = _NonzeroSpy()
    tl.torch = spy
    try:
        t0 = time.perf_counter()
        ev = tl.make_eval_logll(tplan, dtype=f32, device="cpu")
        out_t = ev(torch.as_tensor(states, dtype=f32),
                   torch.ones(1, dtype=f32))
        port_s = time.perf_counter() - t0
    finally:
        tl.torch = torch
    mask_t = (spy.masks[0].reshape(K, M).numpy() if spy.masks
              else np.zeros((K, M), bool))
    ll_t = out_t["per_meas"][..., 0].double().numpy()
    score_t = out_t["esc_score"].double().numpy()

    # JAX, XLA path: "off" for the gate and the counts, "inline" for ll
    t0 = time.perf_counter()
    res = {}
    for mode in ("off", "inline"):
        ev_j = jax.jit(jl.make_eval_logll(jplan, dtype=jnp.float32,
                                          escalate=mode))
        res[mode] = jax.tree.map(np.asarray, ev_j(
            jnp.asarray(states, jnp.float32), jnp.ones(1, jnp.float32)))
    jax_s = time.perf_counter() - t0
    off, inl = res["off"], res["inline"]
    score_j = off["esc_score"].astype(float)
    units = np.asarray(tplan.units)
    mu = states[:, names.index("mu_n")] * units[names.index("mu_n")]
    if "mu_p" in names:
        mu = np.maximum(mu, states[:, names.index("mu_p")]
                        * units[names.index("mu_p")])
    gate_j = score_j < float(getattr(jplan, "esc_gate_score",
                                     jl.ESCALATE_GATE_SCORE))
    mask_j = (~np.isfinite(off["per_meas"][..., 0])
              | ((mu > jl.ESCALATE_MU_MODEL)[:, None] & gate_j))
    if not (mask_j.sum(axis=1) == off["fail_states"]).all():
        print("note: JAX's derived row mask disagrees with its own "
              f"fail_states {off['fail_states'].tolist()}")
    ll_j = inl["per_meas"][..., 0].astype(float)

    # the port's fast plan in float64 (its ladder never fires there on
    # these states if float32 rounding is what flags the rows)
    ll_t64 = tl.make_eval_logll(tplan, dtype=torch.float64, device="cpu")(
        torch.as_tensor(states), torch.ones(1, dtype=torch.float64))[
        "per_meas"][..., 0].numpy()

    rows = [(k, m) for k in range(K) for m in range(M)]
    t0 = time.perf_counter()
    compare = tl._make_compare_pipeline(tplan, torch.float64, "cpu")
    ll_o = oracle_ll(tplan, states, rows, compare).reshape(K, M)
    oracle_s = time.perf_counter() - t0
    ll_jf = off["per_meas"][..., 0].astype(float)

    print("state m | repaired port JAX | esc_score port JAX | ll: port "
          "(f32, final), port f64, JAX f32 fast, JAX final, oracle")
    for k, m in rows:
        print(f"{k} {m} | {int(mask_t[k, m])} {int(mask_j[k, m])} | "
              f"{score_t[k, m]:.5f} {score_j[k, m]:.5f} | "
              f"{ll_t[k, m]:.4f} {ll_t64[k, m]:.4f} {ll_jf[k, m]:.4f} "
              f"{ll_j[k, m]:.4f} {ll_o[k, m]:.4f}")
    d_t, d_j = np.abs(ll_t - ll_o), np.abs(ll_j - ll_o)
    diff = mask_t != mask_j
    print(f"mu_n of the states {np.round(states[:, names.index('mu_n')], 2).tolist()}; "
          f"rows repaired: port {int(mask_t.sum())} of {K * M} "
          f"(repair_states {out_t['repair_states'].tolist()}), JAX "
          f"{int(mask_j.sum())} (fail_states {off['fail_states'].tolist()})"
          f"; rows where they differ {int(diff.sum())}")
    print(f"|final ll - oracle| over all rows: port median "
          f"{np.median(d_t):.4e} max {d_t.max():.4e}; JAX median "
          f"{np.median(d_j):.4e} max {d_j.max():.4e}; port f64 max "
          f"{np.abs(ll_t64 - ll_o).max():.4e}")
    if diff.any():
        print(f"on the {int(diff.sum())} rows repaired by one side only: "
              f"|port - oracle| max {d_t[diff].max():.4e}, |JAX - oracle| "
              f"max {d_j[diff].max():.4e}, |JAX fast f32 - oracle| max "
              f"{np.abs(ll_jf - ll_o)[diff].max():.4e}")
    if mask_t.any():
        print(f"on the port's repaired rows: |port - oracle| max "
              f"{d_t[mask_t].max():.4e}")
    print(f"seconds: port eval {port_s:.1f}, JAX compile + 2 evals "
          f"{jax_s:.1f}, oracle {oracle_s:.1f} (CPU)")

if __name__ == "__main__":
    main()
