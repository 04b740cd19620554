"""PyTorch port parity of the traps model (C=4) through the likelihood
and the walk: plans field-equal to the JAX package's, make_eval_logll with
its escalation ladder against the JAX inline ladder, and a traps metro()
whose checkpoint the JAX package loads."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import (
    assert_plans_equal,
    compare_eval,
    param_info,
    staub_states,
    synth_config,
)

from metrotrpl_tpu.inference import likelihood as jl
from metrotrpl_tpu.io.ensemble import load_checkpoint as j_load_checkpoint
from metrotrpl_tpu_torch.convert import from_reference_plan
from metrotrpl_tpu_torch.inference import likelihood as tl


def test_traps_eval_logll_matches_jax_f64():
    """Traps-model states around the truth (+-0.15 dex on the 13 active
    parameters, the trap parameters included) on the thin and thick
    sample, fast chord plan, nx=8, three temperatures, float64: the
    likelihood plan is field-equal to the JAX one (and carries over
    through from_reference_plan); logll_T and per_meas within 1e-6 with
    identical -inf entries and fail_states. The last state has ks = 0:
    its PL underflows to the clamp, the ladder re-solves it and concedes
    it as -inf, identically in both."""
    sim_info, mcmc, e_data, iniPar = synth_config(nx=8, t_end=500.0,
                                                  model="traps")
    pi = param_info(model="traps")
    kw = dict(hmax=48.0, align_outputs=False, refactor_every=4)
    jplan = jl.build_likelihood_plan(sim_info, pi, mcmc, e_data, iniPar,
                                     **kw)
    tplan = tl.build_likelihood_plan(sim_info, pi, mcmc, e_data, iniPar,
                                     **kw)
    assert tplan.fwd[0][1].model == "traps"
    assert tplan.fwd[0][1].n_ramp is not None        # chord phases run
    assert_plans_equal(tplan, jplan)
    assert_plans_equal(from_reference_plan(jplan), jplan)

    states = staub_states(pi, 6, seed=12, spread=0.15)
    states[-1, pi["names"].index("ks")] = 0.0
    temps = np.array([1.0, 4.0, 32.0])
    out_j = jax.jit(jl.make_eval_logll(jplan, escalate="inline"))(
        jnp.asarray(states), jnp.asarray(temps))
    ev = tl.make_eval_logll(tplan, dtype=torch.float64, device="cpu")
    out_t = ev(torch.as_tensor(states), torch.as_tensor(temps))
    ll_j = np.asarray(out_j["logll_T"])
    assert np.isfinite(ll_j[:-1]).all() and not np.isfinite(ll_j[-1]).any()
    assert out_t["repair_states"].numpy()[-1] == 2
    compare_eval(out_t, out_j, dll=1e-6)
    np.testing.assert_allclose(out_t["resid"].numpy()[:-1],
                               np.asarray(out_j["resid"])[:-1], rtol=1e-6,
                               atol=1e-12)


def test_traps_metro_checkpoint_loads_in_jax_package(tmp_path):
    """A 4-iteration traps metro(device='cpu') on the 16-parameter traps
    config writes a checkpoint that the JAX package's load_checkpoint
    loads, with the traps History layout and finite log-likelihoods."""
    from metrotrpl_tpu_torch.inference.metropolis import metro

    sim_info, mcmc, e_data, iniPar = synth_config(
        nx=8, lengths=(311.0,), nt=6, t_end=50.0, model="traps",
        model_uncertainty=0.05)
    mcmc.update({"init_cond_path": "x", "measurement_path": "x",
                 "output_path": str(tmp_path), "num_iters": 4,
                 "solver": ("sdirk",), "hmax": 16.0, "hard_bounds": 1,
                 "checkpoint_freq": 2, "parallel_tempering": [1.0, 4.0],
                 "temper_freq": 2, "load_checkpoint": None})
    pi = param_info(trial_move=0.02, model="traps")
    metro(sim_info, iniPar, e_data, mcmc, pi, export_path="f.pik", seed=5,
          device="cpu", trap_signals=False)
    ens = j_load_checkpoint(str(tmp_path / "f.pik"))
    assert type(ens).__module__ == "metrotrpl_tpu.io.ensemble"
    assert ens.ensemble_fields["model"] == "traps"
    assert ens.ensemble_fields["names"][-3:] == ["kC", "Nt", "tauE"]
    assert ens.H.states.shape == (2, 16, 4)
    assert ens.latest_iter == 4
    assert np.isfinite(ens.H.loglikelihood).all()
    assert hasattr(ens.H, "mean_tauE")
