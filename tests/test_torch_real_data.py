"""PyTorch port parity on the real measured staub MAPI data
(`Inputs/real_staub_aug_corr_renoised.csv`, the config of `cli
write-real-example --fast`, docs/REAL_DATA.md): density-mode initial
profiles and 3 curves of 141 points out to 4248 ns, with and without the
745 nm detector IRF, against the JAX XLA path at float64; and the port's
IRF stage against the numpy reference pipeline. The grid is cut from
nx=128 to nx=32 (the profiles averaged over blocks of 4 cells)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import REPO, assert_plans_equal, compare_eval, rel_err

from metrotrpl_tpu.inference import likelihood as jl
from metrotrpl_tpu.ops.convolve import load_irf_tables as j_irf_tables
from metrotrpl_tpu_torch.cli import main as tcli
from metrotrpl_tpu_torch.config import get_data, get_initpoints, read_config
from metrotrpl_tpu_torch.convert import from_reference_plan
from metrotrpl_tpu_torch.inference import likelihood as tl
from metrotrpl_tpu_torch.inference.metropolis import plans_from_config
from metrotrpl_tpu_torch.ops.convolve import load_irf_tables
from metrotrpl_tpu_torch.oracle.irf_reference import (
    do_irf_convolution_reference,
)

NX = 32


def _real_config(tmp_path):
    """The write-real-example --fast --irf config, its data and initial
    profiles, cut to nx=32, with its 3 measurements listed twice: with the
    745 nm IRF (measurements 0-2) and without it (3-5, IRF wavelength 0).
    Rows are independent, so one plan holds both configurations:
    (sim_info, param_info, MCMC_fields, e_data, iniPar, irf_tables)."""
    cfg = str(tmp_path / "real.txt")
    tcli(["write-real-example", cfg, "--fast", "--irf", "--init-cond",
          os.path.join(REPO, "Inputs", "real_staub_input.csv"),
          "--measurement",
          os.path.join(REPO, "Inputs", "real_staub_aug_corr_renoised.csv"),
          "--output", str(tmp_path / "out")])
    sim_info, pi, flags, mcmc = read_config(cfg)
    assert mcmc["irf_convolution"] == [745] * 3
    e_data = get_data(mcmc["measurement_path"], flags, mcmc)
    ini = get_initpoints(mcmc["init_cond_path"], flags)
    assert ini.shape == (3, 128) and len(e_data[0][0]) == 141
    sim_info = {"lengths": sim_info["lengths"] * 2, "nx": [NX] * 6,
                "meas_types": sim_info["meas_types"] * 2, "num_meas": 6}
    mcmc["irf_convolution"] = [745] * 3 + [0] * 3
    ini = np.tile(ini.reshape(3, NX, 128 // NX).mean(axis=2), (2, 1))
    e_data = tuple(list(a) * 2 for a in e_data)
    tables = load_irf_tables([745], os.path.join(REPO, "IRFs"))
    return sim_info, pi, mcmc, e_data, ini, tables


def test_real_data_eval_matches_jax(tmp_path):
    """The port's plan equals JAX's field for field (the JAX plan built
    with the JAX package's own IRF tables, R > 300,000 resample points);
    the port's eval_logll on the config's initial guess and a state
    +-0.15 dex around it at T = 1, 8, 128 matches JAX's XLA path, with the
    IRF and without: per_meas and each configuration's logll_T within rel
    1e-9, every value finite, no row repaired. (JAX runs escalate="off":
    its n_solver_fail of 0 shows that no row is repairable, so "inline"
    gives the same values.)"""
    sim_info, pi, mcmc, e_data, ini, tables = _real_config(tmp_path)
    tplan, _ = plans_from_config(sim_info, pi, dict(mcmc), e_data, ini,
                                 irf_tables=tables)
    hm, align = jl.resolve_solver_mode(mcmc, 4.0)
    jplan = jl.build_likelihood_plan(
        sim_info, pi, mcmc, e_data, ini,
        irf_tables=j_irf_tables([745], os.path.join(REPO, "IRFs")),
        hmax=hm, align_outputs=align, refactor_every=mcmc["refactor_every"])
    assert_plans_equal(tplan, from_reference_plan(jplan))
    assert tplan.ini_mode == "density"
    assert tplan.has_irf.tolist() == [True] * 3 + [False] * 3
    assert tplan.res_t.shape[1] > 300_000      # half the IRF step

    names = pi["names"]
    base = np.array([pi["init_guess"][n] for n in names])
    active = np.array([bool(pi["active"][n]) for n in names])
    rng = np.random.default_rng(7)
    states = np.concatenate([base[None], base[None] * 10 ** (rng.uniform(
        -0.15, 0.15, (1, len(names))) * active[None])])
    temps = np.array([1.0, 8.0, 128.0])
    out_j = jax.jit(jl.make_eval_logll(jplan, escalate="off"))(
        jnp.asarray(states), jnp.asarray(temps))
    assert int(out_j["n_solver_fail"]) == 0
    out_t = tl.make_eval_logll(tplan, device="cpu")(
        torch.as_tensor(states), torch.as_tensor(temps))
    compare_eval(out_t, out_j, dll=np.inf)
    assert int(out_t["repair_states"].sum()) == 0
    pm_t, pm_j = out_t["per_meas"].numpy(), np.asarray(out_j["per_meas"])
    assert np.isfinite(pm_t).all()
    assert rel_err(pm_t, pm_j) < 1e-9
    for half in (slice(0, 3), slice(3, 6)):        # with, without the IRF
        assert rel_err(pm_t[:, half].sum(axis=1),
                       pm_j[:, half].sum(axis=1)) < 1e-9
    # the IRF moves every curve's likelihood
    assert (pm_t[:, :3] != pm_t[:, 3:]).all()


def test_irf_stage_matches_reference_pipeline(tmp_path):
    """The port's IRF stage on one measured curve (the first power's data,
    linear) equals the numpy reference pipeline (resample at half the IRF
    step, moment convolution, max-shift, trim to the convolved span,
    interpolate onto the data times) within rel 1e-9, on the same set of
    valid points."""
    sim_info, pi, mcmc, e_data, ini, tables = _real_config(tmp_path)
    plan = tl.build_likelihood_plan(sim_info, pi, mcmc, e_data, ini,
                                    irf_tables=tables)
    t = e_data[0][0]
    y = 10.0 ** e_data[1][0]
    sol = torch.zeros((6, plan.exp_times.shape[1]), dtype=torch.float64)
    sol[0, :len(t)] = torch.as_tensor(y)
    sol_irf, valid, fail = tl._make_irf_stage(plan, torch.float64,
                                              torch.device("cpu"))(sol)
    table, t_irf = tables[745]
    ct, cy, ok = do_irf_convolution_reference(t, y, table, t_irf,
                                              time_max_shift=True)
    assert ok and not bool(fail[0])
    ref_valid = t < np.nanmax(ct)
    np.testing.assert_array_equal(valid[0, :len(t)].numpy(), ref_valid)
    assert ref_valid.sum() > 100
    assert rel_err(sol_irf[0, :len(t)].numpy()[ref_valid],
                   np.interp(t[ref_valid], ct, cy)) < 1e-9
