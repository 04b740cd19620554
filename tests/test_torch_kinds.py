"""PyTorch port parity of the likelihood kinds that run no forward solve
(the NN surrogate and the 'pa' toy potential) and of the CLI's config
writers, against the JAX package on the same inputs (float64, CPU)."""

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    REPO,
    JaxReplayDraws,
    assert_plans_equal,
    compare_eval,
    plane_rel,
    rel_err,
)

from metrotrpl_tpu import surrogate as jsur
from metrotrpl_tpu.inference import likelihood as jl
from metrotrpl_tpu.inference import metropolis as jmet
from metrotrpl_tpu.inference.moves import build_move_plan as j_move
from metrotrpl_tpu.ops.convolve import make_I_tables
from metrotrpl_tpu.workloads import STAUB_NAMES, STAUB_TRUE, STAUB_UC
from metrotrpl_tpu_torch import surrogate as tsur
from metrotrpl_tpu_torch.convert import from_reference_nn, from_reference_plan
from metrotrpl_tpu_torch.inference import likelihood as tl
from metrotrpl_tpu_torch.inference import metropolis as tmet

#: the NN features of the staub truth at the 311 nm fluence
#: (reference forward_solver.py:213-219 order)
TRUE_FEATS = np.array([[STAUB_TRUE[n] for n in
                        ("p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Sf", "Sb",
                         "tauN", "tauP")]
                       + [1 / STAUB_TRUE["eps"], 2.12e11, 6e4, 311.0]])


def _jax_nn(seed=1, widths=(14, 8, 4)):
    """A seeded JAX surrogate whose scales keep log10 of the staub
    features and 10**out finite (tests/test_modes.py's fixture)."""
    rng = np.random.default_rng(seed)
    nn = jsur.NeuralNetwork()
    nn.params = [(jnp.asarray(rng.standard_normal((a, b)) * 0.3),
                  jnp.asarray(rng.standard_normal(b) * 0.1))
                 for a, b in zip(widths[:-1], widths[1:])]
    nn.model_scales = np.array(
        [np.zeros(widths[0]), np.ones(widths[0]) * 20, np.zeros(widths[-1]),
         np.ones(widths[-1])], dtype=object)
    nn.has_model = True
    return nn


def _save_nn(nn, tmp_path):
    wpath, spath = str(tmp_path / "w.npz"), str(tmp_path / "s.npy")
    nn.save_npz(wpath)
    np.save(spath, nn.model_scales, allow_pickle=True)
    return wpath, spath


def test_surrogate_matches_jax(tmp_path):
    """The port's module loads the JAX package's .npz and scales and
    predicts its curves (rel 1e-12, float64); multiexp agrees; the port's
    save_npz round-trips through the JAX loader exactly; from_reference_nn
    gives the same module; a keras .h5 loads into the same arrays."""
    import h5py

    jnn = _jax_nn(widths=(14, 16, 8, 4))
    wpath, spath = _save_nn(jnn, tmp_path)
    tnn = tsur.NeuralNetwork()
    tnn.load_model(wpath, spath)
    rng = np.random.default_rng(2)
    x = TRUE_FEATS * 10 ** rng.uniform(-0.5, 0.5, (5, 14))
    t = np.linspace(0, 500, 33)
    for row in x:
        y_j = np.asarray(jnn.predict(t, row[None]))
        assert rel_err(tnn.predict(t, row[None]).numpy(), y_j) < 1e-12
        assert rel_err(from_reference_nn(jnn, "cpu").predict(
            t, row[None]).numpy(), y_j) < 1e-12
    args = rng.uniform(-1, 1, (3, 6)) * np.array([1, 1, 1, 0, 0, 0]) \
        + np.array([-0.2, -0.1, -0.01, 2.0, 3.0, 1.0])
    assert rel_err(tsur.multiexp(torch.as_tensor(t), torch.as_tensor(args)),
                   jsur.multiexp(jnp.asarray(t), jnp.asarray(args))) < 1e-12

    tnn.save_npz(str(tmp_path / "t.npz"))
    back = jsur.NeuralNetwork()
    back.load_model(str(tmp_path / "t.npz"), spath)
    for (kb, bb), (kj, bj) in zip(back.params, jnn.params):
        np.testing.assert_array_equal(np.asarray(kb), np.asarray(kj))
        np.testing.assert_array_equal(np.asarray(bb), np.asarray(bj))

    h5 = str(tmp_path / "w.h5")
    with h5py.File(h5, "w") as f:
        g = f.create_group("model_weights")
        names = ["dense"] + [f"dense_{i}" for i in range(1, 3)]
        g.attrs["layer_names"] = np.array([n.encode() for n in names])
        for n, (k, b) in zip(names, jnn.params):
            lg = g.create_group(n).create_group(n)
            lg.create_dataset("kernel:0", data=np.asarray(k))
            lg.create_dataset("bias:0", data=np.asarray(b))
    th5 = tsur.NeuralNetwork()
    th5.load_model(h5, spath)
    for (kt, bt), (kj, bj) in zip(th5.params,
                                  jsur._load_keras_dense_h5(h5)):
        np.testing.assert_array_equal(kt, np.asarray(kj))
        np.testing.assert_array_equal(bt, np.asarray(bj))


def _nn_pi(names):
    return {"names": names, "unit_conversions": dict(STAUB_UC),
            "do_log": {n: 1 for n in names},
            "active": {n: 1 for n in names},
            "init_guess": {n: STAUB_TRUE.get(n, 1.0) for n in names},
            "prior_dist": {n: (1e-30, 1e30) for n in names},
            "trial_move": {n: 0.01 for n in names}}


@pytest.mark.parametrize("variant", ["plain", "irf", "fluence_min_y"])
def test_nn_likelihood_matches_jax(tmp_path, variant):
    """The NN likelihood (tests/test_modes.py:305-358 and :514-577):
    data made from the surrogate's own curve (convolved with the 520 nm
    IRF by the numpy reference pipeline for "irf"), the port's
    eval_logll against JAX's on the truth and 5 scattered states at three
    temperatures: logll_T and per_meas within 1e-9 of the largest |ll|;
    the truth fits to ~0; the plan converted from JAX's evaluates the same. "fluence_min_y"
    adds a fittable fluence and force_min_y."""
    from metrotrpl_tpu_torch.oracle.irf_reference import (
        do_irf_convolution_reference,
    )

    jnn = _jax_nn()
    wpath, spath = _save_nn(jnn, tmp_path)
    t = np.linspace(0, 100, 41)
    curve = np.asarray(jnn.predict(t, TRUE_FEATS))
    names = list(STAUB_NAMES)
    mcmc = {"ini_mode": "fluence", "model": "std", "log_y": 1,
            "model_uncertainty": 1, "solver": ("NN", wpath, spath)}
    tables = None
    if variant == "irf":
        irf = np.loadtxt(os.path.join(REPO, "IRFs", "irf_520nm.csv"),
                         delimiter=",")
        tables = make_I_tables({520: irf})
        ct, cy, ok = do_irf_convolution_reference(
            t, curve, tables[520][0], tables[520][1], time_max_shift=True)
        assert ok
        curve = np.interp(t, ct, cy)
        mcmc["irf_convolution"] = [520]
    elif variant == "fluence_min_y":
        curve = np.maximum(curve, curve[len(t) // 2])
        names.append("_f0")
        mcmc.update(force_min_y=1,
                    fittable_fluences=[0.1, np.array([0]), None, [1.0]])
    e_data = ([t], [np.log10(np.abs(curve))], [np.full(len(t), 0.05)])
    sim_info = {"lengths": [311.0], "nx": [24], "meas_types": ["TRPL"],
                "num_meas": 1}
    args = (sim_info, _nn_pi(names), mcmc, e_data,
            np.array([[2.12e11, 6e4, 1]]))
    jplan = jl.build_likelihood_plan(*args, irf_tables=tables)
    tplan = tl.build_likelihood_plan(*args, irf_tables=tables)
    assert tplan.kind == "nn" and tplan.fwd is None
    assert bool(tplan.has_irf[0]) == (variant == "irf")

    base = np.array([STAUB_TRUE.get(n, 1.0) for n in names])
    rng = np.random.default_rng(4)
    states = np.concatenate([base[None], base[None] * 10 ** rng.uniform(
        -0.2, 0.2, (5, len(names)))])
    temps = np.array([1.0, 3.0, 20.0])
    out_j = jl.make_eval_logll(jplan, dtype=jnp.float64)(
        jnp.asarray(states), jnp.asarray(temps))
    for plan in (tplan, from_reference_plan(jplan)):
        out_t = tl.make_eval_logll(plan, dtype=torch.float64, device="cpu")(
            torch.as_tensor(states), torch.as_tensor(temps))
        compare_eval(out_t, out_j, dll=np.inf)
        for key in ("logll_T", "per_meas"):
            # the truth's ll is ~0 (a rounding residue), so relative to
            # the largest |ll| of the batch
            assert plane_rel(out_t[key].numpy(), out_j[key]) < 1e-9, key
    ll = out_t["logll_T"].numpy()[:, 0]
    assert np.isfinite(ll).all()
    assert ll[0] > (-1e-3 if variant == "irf" else -1e-8) and ll[1:].max() \
        < ll[0]


def _pa_setup(out, num_iters=20):
    """The pa toy problem (tests/test_metropolis.py's settings)."""
    sim_info = {"lengths": [1], "nx": [1], "meas_types": ["pa"],
                "num_meas": 1}
    pi = {"names": ["x0"], "unit_conversions": {}, "do_log": {"x0": 0},
          "active": {"x0": 1}, "init_guess": {"x0": 0.2},
          "prior_dist": {"x0": (-2, 2)}, "trial_move": {"x0": 0.2}}
    mcmc = {"init_cond_path": "x", "measurement_path": "x",
            "output_path": str(out), "ini_mode": "density",
            "num_iters": num_iters, "solver": ("solveivp",), "model": "pa",
            "model_uncertainty": 1, "log_y": 1, "hard_bounds": 1,
            "checkpoint_freq": num_iters,
            "parallel_tempering": [0.05, 0.3, 2.0], "temper_freq": 5,
            "load_checkpoint": None}
    e_data = ([np.array([0.0])], [np.array([0.0])], [np.array([1.0])])
    return sim_info, pi, mcmc, e_data, np.zeros((1, 1))


def test_pa_kind_matches_jax(tmp_path):
    """The pa plan builds field for field as JAX's (fwd None) and converts
    from it; eval_logll equals JAX's on a grid across and past the prior
    box (+inf potential outside [-2, 2]); a 20-iteration window of 3
    tempered chains replaying the JAX keyed stream follows the JAX window
    draw for draw."""
    sim_info, pi, mcmc, e_data, ini = _pa_setup(tmp_path)
    jplan = jl.build_likelihood_plan(sim_info, pi, mcmc, e_data, ini)
    tplan = tl.build_likelihood_plan(sim_info, pi, mcmc, e_data, ini)
    assert tplan.kind == "pa" and tplan.fwd is None
    assert_plans_equal(tplan, from_reference_plan(jplan))
    xs = np.linspace(-2.5, 2.5, 41)[:, None]
    temps = np.array([0.05, 0.3, 2.0])
    out_j = jl.make_eval_logll(jplan)(jnp.asarray(xs), jnp.asarray(temps))
    out_t = tl.make_eval_logll(tplan, device="cpu")(torch.as_tensor(xs),
                                                   torch.as_tensor(temps))
    compare_eval(out_t, out_j, dll=1e-12)
    assert np.isinf(out_t["logll_T"].numpy()[[0, -1]]).all()

    jmove = j_move(pi, mcmc)
    _, tmove = from_reference_plan(jplan, jmove)
    seed, k0, n_it = 21, 1, 20
    states = np.array([[0.2], [-0.7], [1.3]])
    jk = jmet.build_mh_kernel(jplan, jmove, temps, jmove.trial_move, 5, True,
                              window=n_it, dtype=jnp.float64)
    out_j = jax.tree.map(np.asarray, jk.run_window(
        jnp.asarray(states), jk.init_ll(jnp.asarray(states)),
        jnp.asarray(k0), jax.random.PRNGKey(seed)))
    tk = tmet.build_mh_kernel(tplan, tmove, temps, jmove.trial_move, 5, True,
                              dtype=torch.float64, device="cpu")
    st = torch.as_tensor(states)
    out_t = tk.run_window(st, tk.init_ll(st), k0, n_it,
                          JaxReplayDraws(seed, 3, 1, tmove.max_proposals,
                                         torch.float64))
    np.testing.assert_array_equal(out_t[5][2].numpy(), out_j[5][2])
    assert 0 < out_j[5][2].sum() < out_j[5][2].size
    np.testing.assert_array_equal(out_t[2].numpy(), out_j[2])
    np.testing.assert_array_equal(out_t[3].numpy(), out_j[3])
    assert rel_err(out_t[5][0].numpy(), out_j[5][0]) < 1e-12
    assert np.max(np.abs(out_t[1].numpy() - out_j[1])) < 1e-9


def test_pa_walk_dense_and_mle_run_without_a_solve_group(tmp_path):
    """metro, the dense sampler and the MLE run a plan with fwd None: the
    pa walk stays in the prior box with swaps, dense gives -U(x) at T=1,
    the MLE's trace is finite."""
    from metrotrpl_tpu_torch.inference.dense import bayes
    from metrotrpl_tpu_torch.inference.mle import mle

    sim_info, pi, mcmc, e_data, ini = _pa_setup(tmp_path, 60)
    ens = tmet.metro(sim_info, ini, e_data, mcmc, pi, export_path="pa.pik",
                     seed=5, device="cpu", trap_signals=False)
    H = ens.H
    assert np.all(np.abs(H.states) < 2) and H.swap_accept.sum() > 0
    assert np.isfinite(H.loglikelihood).all()
    _, P, X = bayes(None, None, ini, sim_info, e_data, dict(mcmc), pi,
                    seed=1, device="cpu", chunk=16)
    np.testing.assert_allclose(
        P, -tl.u_potential(torch.as_tensor(X[:, 0])).numpy(), rtol=1e-15)
    e = mle(e_data, sim_info, pi, ini, dict(mcmc), "mle.pik", None,
            maxiter=5, device="cpu")
    assert np.isfinite(e.H.loglikelihood[0, 1:e.latest_iter]).all()


class _FrozenDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5, 678)


def test_writers_equal_jax_byte_for_byte(tmp_path, monkeypatch):
    """write-example --fast, write-real-example (plain, and --fast --irf),
    write-pa-example (config and companion files) and convert-config
    (text -> TOML -> text) write the JAX package's bytes, with the header's
    clock frozen in both; the TOML round trip parses back to the text
    file's dicts."""
    from metrotrpl_tpu.cli import main as jcli
    from metrotrpl_tpu.config import script_io as j_sio
    from metrotrpl_tpu_torch.cli import main as tcli
    from metrotrpl_tpu_torch.config import read_config
    from metrotrpl_tpu_torch.config import script_io as t_sio

    for mod in (j_sio, t_sio):
        monkeypatch.setattr(mod.datetime, "datetime", _FrozenDatetime)
    monkeypatch.chdir(REPO)
    flu = os.path.join("Inputs", "staub_MAPI_threepower_twothick_fluences.csv")
    meas = str(tmp_path / "meas.csv")
    t = np.linspace(0, 2000, 501)
    np.savetxt(meas, np.concatenate([np.stack(
        [t, 1e17 * np.exp(-t / 400), 1e15 + 0 * t], 1)] * 6), delimiter=",")
    runs = {
        "ex": ["write-example", "{d}/ex.txt", "--fast", "--init-cond", flu,
               "--measurement", meas, "--output", str(tmp_path / "out")],
        "real": ["write-real-example", "{d}/real.txt"],
        "real_irf": ["write-real-example", "{d}/real_irf.txt", "--fast",
                     "--irf", "--num-iters", "300"],
        "pa": ["write-pa-example", "{d}/pa", "--jobid", "3"],
    }
    for pkg, cli in (("j", jcli), ("t", tcli)):
        d = tmp_path / pkg
        d.mkdir()
        for argv in runs.values():
            cli([a.format(d=d) for a in argv])
        cli(["convert-config", f"{d}/real_irf.txt", f"{d}/real_irf.toml"])
        cli(["convert-config", f"{d}/real_irf.toml", f"{d}/back.txt"])
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    assert {"pa3.txt", "pa_ic.csv", "pa_data.csv", "real_irf.toml"} \
        <= set(files)
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    assert_plans_equal(read_config(str(tmp_path / "t" / "back.txt")),
                       read_config(str(tmp_path / "t" / "real_irf.txt")))
    assert read_config(str(tmp_path / "t" / "real_irf.toml"))[3][
        "irf_convolution"] == [745.0] * 3
