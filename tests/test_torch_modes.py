"""PyTorch port parity of the CLI's other inference modes: the dense
sampler and the MLE against the JAX package on the same config and seed
(float64, CPU), and the CLI's mcmc --ensembles mapping, dense and mle
commands with --device cpu."""

import os

import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import param_info, rel_err, synth_config

from metrotrpl_tpu.inference import dense as jdense
from metrotrpl_tpu.inference.mle import mle as jmle
from metrotrpl_tpu.io.ensemble import load_checkpoint as j_load
from metrotrpl_tpu.workloads import STAUB_PRIOR
from metrotrpl_tpu_torch.inference import dense as tdense
from metrotrpl_tpu_torch.inference.mle import mle as tmle


def _problem(out, num_iters=32):
    """One 311 nm TRPL curve (nx=16, 21 points over 500 ns, LSODA data at
    the staub truth), sdirk fast mode, p0 and tauN free in a box around
    the truth: (sim_info, param_info, flags, e_data, iniPar)."""
    sim_info, mcmc, e_data, iniPar = synth_config(
        nx=16, lengths=(311.0,), nt=21, t_end=500.0, model_uncertainty=0.05)
    names = ("p0", "tauN")
    pi = param_info(trial_move=0.02,
                    prior=dict(STAUB_PRIOR, p0=(1e15, 6e15),
                               tauN=(200.0, 1000.0)),
                    inactive=[n for n in STAUB_PRIOR if n not in names])
    mcmc.update({"init_cond_path": "x", "measurement_path": "x",
                 "output_path": str(out), "num_iters": num_iters,
                 "solver": ("sdirk",), "hmax": 16.0, "hard_bounds": 1,
                 "checkpoint_freq": num_iters, "load_checkpoint": None,
                 "scale_factor": None})
    return sim_info, pi, mcmc, e_data, iniPar


def test_random_grid_and_scale_factors_match_jax():
    """The grid draws the JAX package's numbers from the same numpy
    generator; scale-factor bounds are widened the same way."""
    args = (np.array([1e1, 0.0, 3.0]), np.array([1e3, 2.0, 3.0]),
            np.array([1, 0, 1]), 200)
    np.testing.assert_array_equal(
        tdense.random_grid(*args, np.random.default_rng(4)),
        jdense.random_grid(*args, np.random.default_rng(4)))
    pis = [{"names": ["a", "_s0"], "init_guess": {"_s0": 2.0},
            "prior_dist": {"_s0": (0, np.inf)}} for _ in range(2)]
    flags = {"scale_factor": [10.0, [0], None, [2.0]]}
    tdense.modify_scale_factors(pis[0], flags)
    jdense.modify_scale_factors(pis[1], flags)
    assert pis[0] == pis[1]
    assert pis[0]["prior_dist"]["_s0"] == (0.2, 20.0)


def test_dense_bayes_matches_jax(tmp_path):
    """Port bayes vs JAX bayes on the same config and seed, both float64:
    the same grid X, P within rel 1e-9 (the same -inf entries), the same
    file names from export."""
    sim_info, pi, flags, e_data, iniPar = _problem(tmp_path)
    Nj, Pj, Xj = jdense.bayes(None, None, iniPar, sim_info, e_data,
                              dict(flags), pi, seed=3, dtype=jnp.float64)
    Nt, Pt, Xt = tdense.bayes(None, None, iniPar, sim_info, e_data,
                              dict(flags), pi, seed=3, dtype=torch.float64,
                              device="cpu", chunk=20)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(Nt, Nj)
    np.testing.assert_array_equal(np.isfinite(Pt), np.isfinite(Pj))
    ok = np.isfinite(Pj)
    assert ok.sum() >= 24 and rel_err(Pt[ok], Pj[ok]) < 1e-9
    tdense.export(str(tmp_path / "t" / "CPU0"), Pt, Xt)
    jdense.export(str(tmp_path / "j" / "CPU0"), Pj, Xj)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == ["CPU0_P.npy", "CPU0_X.npy"]


def test_mle_matches_jax(tmp_path):
    """Port mle vs JAX mle, float64, from a start off the truth, 6
    Nelder-Mead iterations: every traced state within rel 1e-9 and logll
    within rel 1e-9 (the simplex makes the same moves; the costs differ in
    the last digits only), and the fit improved."""
    sim_info, pi, flags, e_data, iniPar = _problem(tmp_path / "t")
    pi["init_guess"] = dict(pi["init_guess"], p0=1.5e15, tauN=400.0)
    et = tmle(e_data, sim_info, pi, iniPar, dict(flags), "mle.pik", None,
              maxiter=6, device="cpu")
    flags["output_path"] = str(tmp_path / "j")
    ej = jmle(e_data, sim_info, pi, iniPar, dict(flags), "mle.pik", None,
              maxiter=6)
    n = ej.latest_iter
    assert et.latest_iter == n > 6
    assert rel_err(et.H.loglikelihood[0, 1:n], ej.H.loglikelihood[0, 1:n]) \
        < 1e-9
    assert rel_err(et.H.states[0, :, 1:n], ej.H.states[0, :, 1:n]) < 1e-9
    ll = et.H.loglikelihood[0, 1:n]
    assert np.isfinite(ll).all() and ll.max() > ll[0]
    back = j_load(str(tmp_path / "t" / "mle.pik"))
    np.testing.assert_array_equal(back.H.loglikelihood, et.H.loglikelihood)


def test_cli_inference_commands(tmp_path):
    """cli mcmc --ensembles 2 under array task 3 writes replicas 6 and 7
    (seeds 5 + 6 and 5 + 7: distinct walks), and the same command with
    --mesh 1x2 --mesh-devices cpu,cpu (two gloo ranks, one chain each)
    writes the same two checkpoints bit for bit; cli dense and cli mle
    write their outputs; a pa config builds a plan with no solve group."""
    from metrotrpl_tpu_torch.cli import main
    from metrotrpl_tpu_torch.config import generate_config_script_file
    from metrotrpl_tpu_torch.inference.likelihood import build_likelihood_plan

    sim_info, pi, flags, e_data, iniPar = _problem(tmp_path / "out", 6)
    t, v, _ = e_data
    rows = np.stack([t[0], 10 ** v[0], 0.02 * 10 ** v[0]], axis=1)
    np.savetxt(str(tmp_path / "data.csv"), rows, delimiter=",")
    np.savetxt(str(tmp_path / "ic.csv"), iniPar, delimiter=",")
    flags.update({"init_cond_path": str(tmp_path / "ic.csv"),
                  "measurement_path": str(tmp_path / "data.csv"),
                  "parallel_tempering": [1.0, 4.0], "temper_freq": 2,
                  "irf_convolution": None, "force_min_y": 0})
    cfg = str(tmp_path / "cfg.txt")
    generate_config_script_file(cfg, sim_info, pi, {
        "time_cutoff": [0, 500], "select_obs_sets": None}, flags)

    main(["mcmc", cfg, "--jobid", "3", "--ensembles", "2", "--seed", "5",
          "--device", "cpu"])
    out = tmp_path / "out"
    assert not os.path.exists(out / "CPU0-final.pik")
    e6, e7 = (j_load(str(out / f"CPU{j}-final.pik")) for j in (6, 7))
    assert [e.ensemble_fields["_rng_seed"] for e in (e6, e7)] == [11, 12]
    assert e6.H.states.shape == (2, len(pi["names"]), 6)
    assert not np.array_equal(e6.H.states, e7.H.states)
    os.remove(out / "CPU6-final.pik")
    main(["mcmc", cfg, "--jobid", "3", "--ensembles", "2", "--seed", "5",
          "--device", "cpu", "--mesh", "1x2", "--mesh-devices", "cpu,cpu"])
    for j, ref in ((6, e6), (7, e7)):
        m = j_load(str(out / f"CPU{j}-final.pik"))
        assert m.ensemble_fields["_rng_seed"] == ref.ensemble_fields[
            "_rng_seed"]
        for a in ("states", "loglikelihood", "accept", "swap_attempts",
                  "swap_accept"):
            np.testing.assert_array_equal(getattr(m.H, a), getattr(ref.H, a),
                                          err_msg=a)

    main(["dense", cfg, "--jobid", "2", "--device", "cpu"])
    P = np.load(out / "CPU2_P.npy")
    assert P.shape == (6,) and np.isfinite(P).all()
    assert np.load(out / "CPU2_X.npy").shape == (6, len(pi["names"]))
    main(["mle", cfg, "--maxiter", "2", "--device", "cpu"])
    assert j_load(str(out / "MLE0-final.pik")).latest_iter > 2

    pa_plan = build_likelihood_plan(dict(sim_info, meas_types=["pa"]), pi,
                                    flags, e_data, iniPar)
    assert pa_plan.kind == "pa" and pa_plan.fwd is None
