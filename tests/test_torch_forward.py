"""PyTorch port parity: forward plans and the batched forward solve
(plain PyTorch path) against metrotrpl_tpu's XLA path, plus the
likelihood plan built from the flagship config."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_plans_equal, rel_err, staub_raw

from metrotrpl_tpu.physics.models import beer_lambert as j_beer_lambert
from metrotrpl_tpu.solver import forward as jf
from metrotrpl_tpu_torch.physics.models import beer_lambert as t_beer_lambert
from metrotrpl_tpu_torch.solver import forward as tf

PLAN_CASES = {
    "aligned": dict(),
    "chord": dict(hmax=16.0, align_outputs=False, refactor_every=4,
                  ramp_block=2, newton_plateau=1),
    "no_plateau": dict(hmax=8.0, align_outputs=False, refactor_every=4,
                       tail_growth=1.3, tail_block=2),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_forward_plan_fields_equal(case):
    lengths = [311.0, 2000.0, 311.0]
    times = [np.linspace(0, 200, 41), np.linspace(0, 150, 31),
             np.linspace(0, 200, 21)]
    meas = ["TRPL", "TRTS", "TRPL"]
    args = (lengths, [16] * 3, meas, times)
    assert_plans_equal(tf.make_forward_plan(*args, **PLAN_CASES[case]),
                       jf.make_forward_plan(*args, **PLAN_CASES[case]))
    assert tf.refine_for_tols(1e-9, n_steps=400) == \
        jf.refine_for_tols(1e-9, n_steps=400)


def _batch(plan, B, dtype_np, seed):
    """Staub-ish rows (+-0.2 dex on every fitted parameter), alternating
    thin/thick samples, as numpy arrays for both packages. The last row
    decays through the underflow clamp (fast surfaces, 1 ns lifetimes)."""
    rng = np.random.default_rng(seed)
    raw = {k: (v * 10.0 ** rng.uniform(-0.2, 0.2, B)
               if k not in ("n0", "eps", "Tm") else np.full(B, v))
           for k, v in staub_raw().items()}
    for k, v in staub_raw(Sf=1e6, Sb=1e6, tauN=1, tauP=1).items():
        raw[k][-1] = v
    fl = np.full((B, 1), 2.12e-3) * 10.0 ** rng.uniform(-0.5, 0.5, (B, 1))
    al = np.full((B, 1), 6e-3)
    return ({k: v.astype(dtype_np) for k, v in raw.items()},
            fl.astype(dtype_np), al.astype(dtype_np))


def _run_both(plan, B, dtype_np, seed, jax_backend="xla", block_b=None):
    raw, fl, al = _batch(plan, B, dtype_np, seed)
    rows = np.arange(B) % len(plan.dx)
    pick = lambda a: np.asarray(a)[rows]  # noqa: E731
    x = pick(plan.x_centers).astype(dtype_np)
    kw = dict(refactor_every=plan.refactor_every, n_ramp=plan.n_ramp,
              ramp_block=plan.ramp_block, newton_plateau=plan.newton_plateau,
              with_diag=True)
    jw = None if plan.out_w is None else jnp.asarray(pick(plan.out_w),
                                                     dtype_np)
    init_j = j_beer_lambert(jnp.asarray(fl), jnp.asarray(al), jnp.asarray(x))
    sj, rj = jax.jit(lambda i, r: jf.solve_forward_batch(
        i, r, jnp.asarray(pick(plan.dx), dtype_np),
        jnp.asarray(pick(plan.dt), dtype_np),
        jnp.asarray(pick(plan.out_idx)), jnp.asarray(pick(plan.is_trpl)),
        backend=jax_backend, block_b=block_b, out_w=jw, **kw))(
            init_j, {k: jnp.asarray(v) for k, v in raw.items()})
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    t = lambda a, d=tdt: torch.as_tensor(np.asarray(a), dtype=d)  # noqa
    init_t = t_beer_lambert(t(fl), t(al), t(x))
    st, rt = tf.solve_forward_batch(
        init_t, {k: t(v) for k, v in raw.items()}, t(pick(plan.dx)),
        t(pick(plan.dt)), t(pick(plan.out_idx), torch.int64),
        t(pick(plan.is_trpl), torch.bool),
        out_w=None if plan.out_w is None else t(pick(plan.out_w)), **kw)
    return (st.numpy(), rt.numpy()), (np.asarray(sj), np.asarray(rj))


@pytest.mark.parametrize("case", ["aligned", "chord"])
def test_solve_forward_batch_matches_xla_f64(case):
    """Plain PyTorch solve vs the JAX XLA path (stacked layout, colored-JVP
    Jacobian) at float64, TRPL and TRTS rows, with the residual stream and
    the min_y tail clamp: rel 1e-9 (the two differ only by float64
    reassociation; measured ~1e-15)."""
    plan = tf.make_forward_plan(
        [311.0, 2000.0], [16, 16], ["TRPL", "TRTS"],
        [np.linspace(0, 200, 21)] * 2, **PLAN_CASES[case])
    (st, rt), (sj, rj) = _run_both(plan, 6, np.float64, seed=4)
    assert np.isfinite(sj).all() and np.isfinite(st).all()
    # the dying row is held at the clamp from the same point on
    clamp = float(np.finfo(np.float64).tiny)
    np.testing.assert_array_equal(st == clamp, sj == clamp)
    assert (sj[-1] == clamp).any() and not (sj[:-1] == clamp).any()
    ok = sj > clamp
    assert rel_err(st[ok], sj[ok]) < 1e-9
    # the residual is a max of Newton updates of size ~1e-5: compare on
    # the scale of the update, not of the state
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-12)
    if case == "aligned":
        # solve_single runs the first row through a one-row plan
        raw, fl, al = _batch(plan, 6, np.float64, seed=4)
        ic = t_beer_lambert(torch.as_tensor(fl[0]), torch.as_tensor(al[0]),
                            torch.as_tensor(plan.x_centers[0])).numpy()
        one = tf.solve_single(ic, {k: v[0] for k, v in raw.items()},
                              311.0, 16, np.linspace(0, 200, 21),
                              device="cpu")
        assert rel_err(one, sj[0]) < 1e-9


@pytest.fixture(scope="module")
def flagship_config(tmp_path_factory):
    """The flagship config as `write-example --fast` writes it, with a
    stand-in measurement file (plans depend on the times, not the data
    values, so no oracle solve is needed)."""
    from metrotrpl_tpu.cli import main as jcli
    from metrotrpl_tpu.config import get_data, get_initpoints, read_config

    d = tmp_path_factory.mktemp("flagship")
    meas = d / "meas.csv"
    t = np.linspace(0, 2000, 501)
    rows = [np.stack([t, 1e17 * np.exp(-t / (300 + 50 * m)),
                      2e15 * np.exp(-t / (300 + 50 * m))], axis=1)
            for m in range(6)]
    np.savetxt(meas, np.concatenate(rows), delimiter=",")
    cfg = str(d / "cfg.txt")
    jcli(["write-example", cfg, "--fast",
          "--init-cond", os.path.join("Inputs",
                                      "staub_MAPI_threepower_twothick_fluences.csv"),
          "--measurement", str(meas), "--output", str(d / "out")])
    sim_info, param_info, meas_flags, MCMC_fields = read_config(cfg)
    iniPar = get_initpoints(MCMC_fields["init_cond_path"], meas_flags)
    e_data = get_data(MCMC_fields["measurement_path"], meas_flags,
                      MCMC_fields)
    return sim_info, param_info, MCMC_fields, e_data, iniPar


def test_likelihood_plan_fields_equal_on_flagship_config(flagship_config):
    """build_likelihood_plan / build_move_plan on the flagship config give
    field-equal plans, f64 rung included; from_reference_plan carries a
    JAX plan over unchanged."""
    from metrotrpl_tpu.inference import likelihood as jl
    from metrotrpl_tpu.inference.moves import build_move_plan as j_move
    from metrotrpl_tpu_torch.convert import from_reference_plan
    from metrotrpl_tpu_torch.inference import likelihood as tl
    from metrotrpl_tpu_torch.inference.moves import build_move_plan as t_move

    sim_info, param_info, mcmc, e_data, iniPar = flagship_config
    hm, align = jl.resolve_solver_mode(mcmc, 4.0)
    assert (hm, align) == tl.resolve_solver_mode(mcmc, 4.0)
    kw = dict(hmax=hm, align_outputs=align,
              refactor_every=int(mcmc["refactor_every"]))
    ref = jl.build_likelihood_plan(sim_info, param_info, dict(mcmc), e_data,
                                   iniPar, **kw)
    mine = tl.build_likelihood_plan(sim_info, param_info, dict(mcmc),
                                    e_data, iniPar, **kw)
    assert ref.fwd[0][2].solve_dtype == "float64"
    assert_plans_equal(mine, ref)
    jm, tmv = j_move(param_info, mcmc), t_move(param_info, mcmc)
    assert_plans_equal(tmv, jm)
    conv, conv_move = from_reference_plan(ref, jm)
    assert_plans_equal(conv, ref)
    assert_plans_equal(conv_move, jm)
    assert type(conv).__module__ == tl.__name__
