"""The plain reference against the port's plain path on the CPU, where
both compute in float64 and must agree to rounding: the likelihood with
its ladder and IRF stage (at nx=128, the ladder's float64 branch, on
curves cut short), and the walk's draws and proposals.
Also the frozen synthesis against the port's LSODA oracle."""

import copy

import numpy as np
import pytest
import torch

from portbench.harness import common
from portbench.reference import likelihood as rl
from portbench.reference import mh
from portbench.tests.test_portbench_layout import _curves


def _short(cell, tmp_path, t_end):
    """The cell's configuration on curves cut at t_end ns."""
    curves = _curves(cell, tmp_path)
    cfg = copy.deepcopy(cell.config)
    cfg.pop("synthesize", None)
    cfg["meas_fields"]["time_cutoff"] = [0, t_end]
    cfg["MCMC_fields"]["measurement_path"] = str(curves)
    cell.config = cfg
    return cfg


@pytest.mark.parametrize("config,t_end", [("staub-flagship", 400.0),
                                          ("staub-real-irf", 800.0)])
def test_reference_equals_the_ports_plain_path(config, t_end, tmp_path):
    from metrotrpl_tpu_torch.inference.likelihood import make_eval_logll
    from metrotrpl_tpu_torch.inference.metropolis import plans_from_config

    cell = common.Cell(f"{config}.walk-e8")
    cfg = _short(cell, tmp_path, t_end)
    sim_info, param_info, mc, e_data, iniPar, irf = \
        common.program_inputs(cell)
    lp, _ = plans_from_config(sim_info, param_info, dict(mc), e_data,
                              iniPar, irf_tables=irf)
    setup = rl.load_setup(rl_cfg(cfg), root=common.BENCH_DIR)
    names = list(param_info["names"])
    x0 = np.array([param_info["init_guess"][n] for n in names])
    act = np.array([bool(param_info["active"][n]) for n in names])
    rng = np.random.default_rng(3)
    X = np.stack([x0, x0 * np.where(act, 10 ** rng.uniform(-.1, .1, len(x0)),
                                    1), x0.copy()])
    X[2, names.index("mu_n")] = 60.0          # over the rung's trigger
    temps = setup.temps
    r = make_eval_logll(lp, dtype=torch.float64, device="cpu")(
        torch.as_tensor(X), torch.as_tensor(temps))
    ref, n_rung = rl.loglik(setup, X, temps)
    np.testing.assert_allclose(ref, r["logll_T"].numpy(), rtol=1e-9)
    assert n_rung == int(r["repair_states"].sum())
    if setup.irf is not None:   # the gate is open to every IRF row
        assert n_rung >= 1


def rl_cfg(cfg):
    """A parsed configuration as the reference reads its file ("inf" as a
    string)."""
    import json
    return json.loads(json.dumps(cfg).replace("Infinity", '"inf"'))


def test_draws_and_proposals_equal_the_walks():
    from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
    from metrotrpl_tpu_torch.inference.moves import (
        build_move_plan,
        make_trial_move,
    )

    cell = common.Cell("staub-flagship.walk-e8")
    cfg = cell.config
    pi = copy.deepcopy(cfg["param_info"])
    pi["prior_dist"] = {k: tuple(v) for k, v in pi["prior_dist"].items()}
    plan = build_move_plan(pi, cfg["MCMC_fields"])
    temps = np.asarray(cfg["MCMC_fields"]["parallel_tempering"])
    K, P, T = len(temps), len(pi["names"]), mh.MAX_PROPOSALS
    seed = 3000000019
    src = TorchDraws(seed, K, P, T, False, torch.float32, "cpu")
    spec = mh.MoveSpec(cfg, temps, torch.float32, "cpu")
    x0 = torch.tensor([pi["init_guess"][n] for n in pi["names"]],
                      dtype=torch.float32).repeat(K, 1)
    for k in (1, 10, 123):
        d = src.draws(k)
        u_prop, u_acc, swap_i, swap_u = mh.draws(seed, k, K, P, T,
                                                 torch.float32, "cpu")
        assert torch.equal(d.u_prop, u_prop) and torch.equal(d.u_acc, u_acc)
        assert torch.equal(d.swap_i, swap_i) and torch.equal(d.swap_u,
                                                             swap_u)
        base = torch.tensor(plan.trial_move, dtype=torch.float32)
        w = torch.sqrt(torch.tensor(temps, dtype=torch.float32))[:, None] \
            * base[None]
        prog = make_trial_move(x0, w, d.u_prop, None, plan)
        assert torch.equal(prog, spec.propose(x0, u_prop))
        x0 = prog


def test_synthesis_equals_the_ports_oracle():
    from metrotrpl_tpu_torch.oracle import solve_reference

    from portbench.harness.synth import trpl_curve
    from portbench.reference.models import beer_lambert

    cfg = common.Cell("staub-flagship.walk-e8").config
    uc = cfg["param_info"]["unit_conversions"]
    prm = {k: float(v) * float(uc.get(k, 1))
           for k, v in cfg["synthesize"]["truth"].items()}
    nx, th = 16, 311.0
    x = np.linspace(th / nx / 2, th - th / nx / 2, nx)
    ic = beer_lambert(torch.tensor(2.12e11 * 1e-14), torch.tensor(6e4 * 1e-7),
                      torch.as_tensor(x), torch.tensor(1.0)).numpy()
    t = np.linspace(0, 200.0, 51)
    np.testing.assert_allclose(trpl_curve(ic, th, nx, t, prm),
                               solve_reference(ic, th, nx, t, prm),
                               rtol=1e-9)


def test_fir_in_row_chunks_equals_one_convolution():
    """The IRF stage's filter, taken a row at a time at the walk's
    length, equals a plain convolution of each row."""
    g = np.random.default_rng(5)
    sig = torch.as_tensor(g.standard_normal((3, 720_000)))
    taps = torch.as_tensor(g.standard_normal(190))
    out = rl._fir(sig, taps).numpy()
    for b in range(3):
        want = np.convolve(sig[b].numpy(), taps.numpy())[:sig.shape[1]]
        np.testing.assert_allclose(out[b], want, rtol=1e-12, atol=1e-12)
