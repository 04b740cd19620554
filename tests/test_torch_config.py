"""The port's own copies of the JAX package's jax-free modules (config and
data IO, checkpoints, the LSODA oracle) against the originals, and the
port's entry points defaulting to the card."""

import inspect
import os

import numpy as np
import pytest
import torch
from torch_parity import REPO, assert_plans_equal, param_info, traps_raw

from metrotrpl_tpu import config as jcfg
from metrotrpl_tpu.io import ensemble as jens
from metrotrpl_tpu.oracle import solve_reference as j_solve_reference
from metrotrpl_tpu.runtime import load_csv as j_load_csv
from metrotrpl_tpu_torch import config as tcfg
from metrotrpl_tpu_torch.io import ensemble as tens

INPUTS = os.path.join(REPO, "Inputs")
FLUENCES = os.path.join(INPUTS,
                        "staub_MAPI_threepower_twothick_fluences.csv")


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(REPO, "Inputs"))
    if f.endswith(".csv")))
def test_load_csv_equals_jax_runtime(name):
    """The port's CSV reader (its native parser, runtime.load_csv) gives
    the JAX package's arrays on every CSV in Inputs/, shape and bits."""
    path = os.path.join(INPUTS, name)
    mine, ref = tcfg.data_io.load_csv(path), j_load_csv(path)
    assert mine.shape == ref.shape and mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)


def test_get_data_and_initpoints_equal_jax():
    """get_data (log-y, time cutoff, a reordered selection) and
    get_initpoints on the repo's real measurement and initial-condition
    files give the JAX package's arrays."""
    for flags in ({"time_cutoff": [0, np.inf], "select_obs_sets": None},
                  {"time_cutoff": [10, 2000], "select_obs_sets": [2, 0]}):
        for log_y in (0, 1):
            mine = tcfg.get_data(
                os.path.join(INPUTS, "real_staub_aug_corr_renoised.csv"),
                flags, {"log_y": log_y})
            ref = jcfg.get_data(
                os.path.join(INPUTS, "real_staub_aug_corr_renoised.csv"),
                flags, {"log_y": log_y})
            assert_plans_equal(mine, ref, "get_data")
        for f in ("real_staub_input.csv",
                  "staub_MAPI_threepower_twothick_input.csv"):
            np.testing.assert_array_equal(
                tcfg.get_initpoints(os.path.join(INPUTS, f), flags),
                jcfg.get_initpoints(os.path.join(INPUTS, f), flags))
    flags = {"select_obs_sets": None}
    np.testing.assert_array_equal(tcfg.get_initpoints(FLUENCES, flags),
                                  jcfg.get_initpoints(FLUENCES, flags))


def _stand_in_measurements(path, n=6):
    t = np.linspace(0, 2000, 501)
    rows = [np.stack([t, 1e17 * np.exp(-t / (300 + 50 * m)),
                      2e15 * np.exp(-t / (300 + 50 * m))], axis=1)
            for m in range(n)]
    np.savetxt(path, np.concatenate(rows), delimiter=",")


def test_config_dicts_equal_jax_on_flagship_and_traps_configs(tmp_path):
    """The flagship config as the port's and the JAX package's
    `write-example --fast` write it, and the traps config the port's
    write_example_config writes: the port's read_config gives the JAX
    reader's four dicts on each file, and the two write-example files
    read the same."""
    from metrotrpl_tpu.cli import main as jcli
    from metrotrpl_tpu_torch.cli import main as tcli
    from metrotrpl_tpu_torch.cli import write_example_config

    meas = str(tmp_path / "meas.csv")
    _stand_in_measurements(meas)
    common = ["--fast", "--init-cond", FLUENCES, "--measurement", meas,
              "--output", str(tmp_path / "out")]
    tcli(["write-example", str(tmp_path / "t.txt"), *common])
    jcli(["write-example", str(tmp_path / "j.txt"), *common])
    write_example_config(str(tmp_path / "traps.txt"), model="traps",
                         fast=True, init_cond=FLUENCES, measurement=meas,
                         output=str(tmp_path / "out_traps"),
                         checkpoint_freq=50)
    for name in ("t.txt", "j.txt", "traps.txt"):
        path = str(tmp_path / name)
        assert_plans_equal(tcfg.read_config(path), jcfg.read_config(path),
                           name)
    assert_plans_equal(tcfg.read_config(str(tmp_path / "t.txt")),
                       jcfg.read_config(str(tmp_path / "j.txt")))
    _, pi, _, mc = tcfg.read_config(str(tmp_path / "traps.txt"))
    assert mc["model"] == "traps" and pi["names"][-3:] == ["kC", "Nt",
                                                           "tauE"]
    assert sum(pi["active"].values()) == 13


@pytest.mark.parametrize("model", ["std", "traps"])
def test_oracle_copy_equals_jax_oracle(model):
    """The port's LSODA oracle gives the JAX package's curves bit for bit
    (the same numpy and scipy calls)."""
    from metrotrpl_tpu_torch.oracle import solve_reference

    from metrotrpl_tpu.oracle.scipy_reference import beer_lambert

    nx, th = 16, 311.0
    x = np.linspace(th / nx / 2, th - th / nx / 2, nx)
    ic = beer_lambert(2.12e-3, 6e-3, x)
    t = np.linspace(0, 200, 21)
    np.testing.assert_array_equal(
        solve_reference(ic, th, nx, t, traps_raw(), model=model),
        j_solve_reference(ic, th, nx, t, traps_raw(), model=model))


def _ensemble(module, out):
    pi = param_info(model="traps")
    sim_info = {"lengths": [311.0], "nx": [8], "meas_types": ["TRPL"],
                "num_meas": 1}
    mcmc = {"output_path": str(out), "init_cond_path": "x",
            "measurement_path": "x", "checkpoint_freq": 2,
            "ini_mode": "fluence", "solver": ("sdirk",), "model": "traps",
            "num_iters": 3, "log_y": 1, "model_uncertainty": 0.05,
            "parallel_tempering": [1.0, 4.0]}
    ens = module.Ensemble(pi, sim_info, mcmc, 3)
    ens.H.states[:] = np.random.default_rng(1).uniform(
        1, 2, ens.H.states.shape)
    return ens


def test_checkpoints_cross_both_ways(tmp_path):
    """A checkpoint written by the port loads in the JAX package and one
    written by the JAX package loads in the port, each as the loader's own
    classes with the same History; both streams name only sim_utils
    classes, never a module of either package."""
    for writer, reader in ((tens, jens), (jens, tens)):
        path = tmp_path / f"{writer.__name__}.pik"
        src = _ensemble(writer, tmp_path)
        src.checkpoint(str(path))
        raw = path.read_bytes()
        assert b"metrotrpl_tpu" not in raw
        assert b"sim_utils" in raw
        got = reader.load_checkpoint(str(path))
        assert type(got) is reader.Ensemble
        assert type(got.H) is reader.History
        np.testing.assert_array_equal(got.H.states, src.H.states)
        assert got.ensemble_fields["names"] == src.ensemble_fields["names"]


def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    """make_eval_logll, build_mh_kernel, run_mh, run_mh_fused,
    solve_single, metro, the dense sampler and the MLE take device="cuda"
    by default; without a card each raises instead of running on the
    CPU."""
    from metrotrpl_tpu_torch.inference.dense import bayes
    from metrotrpl_tpu_torch.inference.likelihood import make_eval_logll
    from metrotrpl_tpu_torch.inference.metropolis import (
        build_mh_kernel,
        metro,
        run_mh,
        run_mh_fused,
    )
    from metrotrpl_tpu_torch.inference.mle import mle
    from metrotrpl_tpu_torch.solver.forward import solve_single

    calls = {
        make_eval_logll: lambda: make_eval_logll(None),
        build_mh_kernel: lambda: build_mh_kernel(None, None, [1.0], [0.1],
                                                 10, False),
        run_mh: lambda: run_mh(None, None, None, None),
        run_mh_fused: lambda: run_mh_fused([None], None, None, None, [1]),
        bayes: lambda: bayes(None, None, None, None, None, {}, None),
        mle: lambda: mle(None, None, None, None, {}, None, None),
        solve_single: lambda: solve_single(None, {}, 311.0, 8, [0.0, 1.0]),
        metro: lambda: metro(None, None, None, {}, None),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, call in calls.items():
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_irf_oracle_toml_writer_and_parse_config_equal_jax(tmp_path):
    """The port's IRF oracle gives the JAX oracle's arrays bit for bit on
    the 745 nm IRF and a decay (tables, convolution, max-shift, trim); its
    write_config_toml writes the JAX writer's bytes for the flagship
    config's raw dicts; parse_config gives the JAX dicts on the text file
    and on the TOML file."""
    from metrotrpl_tpu.oracle import irf_reference as j_irf
    from metrotrpl_tpu_torch.cli import main as tcli
    from metrotrpl_tpu_torch.oracle import irf_reference as t_irf

    irf = np.loadtxt(os.path.join(REPO, "IRFs", "irf_745nm.csv"),
                     delimiter=",")
    t = np.linspace(0, 40, 81)
    y = 1e3 * np.exp(-t / 7)
    outs = []
    for mod in (t_irf, j_irf):
        table = mod.make_tables_numeric(irf[:40, 0], irf[:40, 1],
                                        u_spacing=200)
        ct, cy, ok = mod.do_irf_convolution_reference(
            t, y, table, irf[:40, 0], time_max_shift=True)
        outs.append((table, ct, cy, ok, *mod.post_conv_trim_reference(
            ct, cy, t, np.log10(y), 0.1 + 0 * t)))
    assert outs[0][3] and outs[1][3]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)

    meas = str(tmp_path / "meas.csv")
    _stand_in_measurements(meas)
    txt = str(tmp_path / "cfg.txt")
    tcli(["write-example", txt, "--fast", "--init-cond", FLUENCES,
          "--measurement", meas, "--output", str(tmp_path / "out")])
    raw = tcfg.parse_config(txt)
    assert_plans_equal(raw, jcfg.parse_config(txt), "parse_config(txt)")
    tcfg.write_config_toml(str(tmp_path / "t.toml"), *raw)
    jcfg.write_config_toml(str(tmp_path / "j.toml"), *jcfg.parse_config(txt))
    assert (tmp_path / "t.toml").read_bytes() == \
        (tmp_path / "j.toml").read_bytes()
    toml = str(tmp_path / "t.toml")
    assert_plans_equal(tcfg.parse_config(toml), jcfg.parse_config(toml),
                       "parse_config(toml)")
