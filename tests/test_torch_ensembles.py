"""PyTorch port parity of the multi-ensemble walk: E tempered ensembles
fused into one solve batch follow the JAX ``vmap_ensembles`` draw for
draw and equal E separate windows (one evaluation per iteration for all
ensembles; the sequential schedule)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import (
    JaxReplayDraws,
    param_info,
    rel_err,
    synth_config,
)

from metrotrpl_tpu.inference import likelihood as jl
from metrotrpl_tpu.inference import metropolis as jmet
from metrotrpl_tpu.inference.moves import build_move_plan as j_move
from metrotrpl_tpu.workloads import STAUB_PRIOR
from metrotrpl_tpu_torch.convert import from_reference_plan
from metrotrpl_tpu_torch.inference import metropolis as tmet
from metrotrpl_tpu_torch.inference.mh_core import (
    TorchDraws,
    make_window_body,
    swap_perm_round,
)
from metrotrpl_tpu_torch.inference.moves import build_move_plan


def _swap_round_one_ensemble(st, ll, swap_i, swap_u):
    """One ensemble's swap round, attempt by attempt on the host: the
    reference metropolis.py:204-261 math."""
    st, ll = st.clone(), ll.clone()
    K = ll.shape[-1]
    att = torch.zeros(K, dtype=torch.int64)
    acc = torch.zeros(K, dtype=torch.int64)
    for j in range(K - 1):
        i = int(swap_i[j])
        logratio = ll[i, i] + ll[i + 1, i + 1] - ll[i + 1, i] - ll[i, i + 1]
        att[i] += 1
        if swap_u[j] < torch.exp(-logratio):
            acc[i] += 1
            st[[i, i + 1]] = st[[i + 1, i]]
            ll[[i, i + 1]] = ll[[i + 1, i]]
    return st, ll, att, acc


def test_swap_round_batched_over_ensembles():
    """The batched swap round equals each ensemble's own round, exactly,
    with some swaps accepted and some refused."""
    g = torch.Generator().manual_seed(3)
    E, K, P = 4, 5, 3
    st = torch.rand((E, K, P), generator=g, dtype=torch.float64)
    ll = -5 * torch.rand((E, K, K), generator=g, dtype=torch.float64)
    si = torch.randint(0, K - 1, (E, K - 1), generator=g)
    su = torch.rand((E, K - 1), generator=g, dtype=torch.float64)
    out = swap_perm_round(st, ll, si, su)
    for e in range(E):
        ref = _swap_round_one_ensemble(st[e], ll[e], si[e], su[e])
        for a, b in zip(out, ref):
            assert torch.equal(a[e], b)
    assert 0 < int(out[3].sum()) < int(out[2].sum()) == E * (K - 1)


def test_fused_window_one_evaluation_per_iteration():
    """On a cheap Gaussian likelihood: the fused window over E=3 calls its
    evaluation once per iteration on all E*K proposals, and ensemble e
    equals a one-ensemble window fed the same draw source, bit for bit."""
    pi = param_info(trial_move=0.05, prior=dict(STAUB_PRIOR))
    move = build_move_plan(pi, {"hard_bounds": 1})
    names = pi["names"]
    base = np.array([pi["init_guess"][n] for n in names])
    K, P, E, n_it = 4, len(names), 3, 7
    temps = torch.tensor([1.0, 2.0, 4.0, 8.0], dtype=torch.float64)
    widths = temps.sqrt()[:, None] * torch.as_tensor(move.trial_move)[None]
    centre = torch.as_tensor(np.log10(base))
    calls = []

    def eval_nf(states):
        calls.append(states.shape[0])
        d2 = torch.sum((torch.log10(states) - centre) ** 2, dim=1)
        ll = -d2[:, None] / (2e-3 * temps[None, :])
        return ll, torch.zeros(states.shape[0], dtype=torch.int64)

    window = make_window_body(eval_nf, move, widths, 2, True)
    rng = np.random.default_rng(1)
    states = torch.as_tensor(
        base * 10.0 ** (rng.uniform(-0.02, 0.02, (E, K, P)) * move.active))
    ll = torch.stack([eval_nf(s)[0] for s in states])
    calls.clear()

    def sources():
        return [TorchDraws(11 + e, K, P, 100, False, torch.float64, "cpu")
                for e in range(E)]

    fused = window(states, ll, 1, n_it, sources())
    assert calls == [E * K] * n_it
    for e, src in enumerate(sources()):
        one = window(states[e:e + 1], ll[e:e + 1], 1, n_it, [src])
        *head, hist = one
        *fhead, fhist = fused
        for a, b in zip(fhead, head):
            assert torch.equal(a[e], b[0])
        for a, b in zip(fhist, hist):
            assert torch.equal(a[e], b[0])
    acc = fused[5][2]
    assert 0 < int(acc.sum()) < acc.numel()
    assert int(fused[2].sum()) == E * 3 * (K - 1)   # k = 2, 4, 6


def test_fused_window_matches_jax_vmap_ensembles():
    """E=2 ensembles of 3 tempered chains, 6 iterations, 2 measurements,
    nx=16, float64, hard bounds, swaps every 2nd iteration: the port's
    fused window, fed one JaxReplayDraws per ensemble (JAX gives each
    ensemble its own key with e0=0), follows JAX vmap_ensembles: states
    within rel 1e-9, ll within 1e-6, accept history and swap counters
    exact. run_ensembles_sequential gives the fused window's outputs."""
    sim_info, mcmc, e_data, iniPar = synth_config(
        nx=16, t_end=100.0, hard_bounds=1, model_uncertainty=0.01)
    pi = param_info(trial_move=0.05, prior=dict(STAUB_PRIOR))
    jplan = jl.build_likelihood_plan(sim_info, pi, mcmc, e_data, iniPar,
                                     hmax=16.0, align_outputs=False,
                                     escalate=False)
    jmove = j_move(pi, mcmc)
    tplan, tmove = from_reference_plan(jplan, jmove)
    temps = np.array([1.0, 3.0, 9.0])
    K, E, k0, n_it, seeds = 3, 2, 1, 6, (41, 42)
    names = pi["names"]
    P = len(names)
    base = np.array([pi["init_guess"][n] for n in names])
    active = np.array([bool(pi["active"][n]) for n in names])
    rng = np.random.default_rng(8)
    states = base * 10.0 ** (rng.uniform(-0.03, 0.03, (E, K, P)) * active)

    tk = tmet.build_mh_kernel(tplan, tmove, temps, jmove.trial_move, 2, True,
                              dtype=torch.float64, device="cpu")
    vk = tmet.vmap_ensembles(tk)
    st_t = torch.as_tensor(states)
    ll_t = vk.init_ll(st_t)   # one evaluation of all E * K states
    assert ll_t.shape == (E, K, K)
    for e in range(E):
        assert torch.equal(ll_t[e], tk.init_ll(st_t[e]))

    # both windows start from the port's ll (test_torch_mh holds init_ll
    # to the JAX one), so the JAX side compiles the window alone
    jk = jmet.vmap_ensembles(jmet.build_mh_kernel(
        jplan, jmove, temps, jmove.trial_move, 2, True, window=n_it,
        dtype=jnp.float64))
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    out_j = jax.tree.map(np.asarray, jk.run_window(
        jnp.asarray(states), jnp.asarray(ll_t.numpy()), jnp.asarray(k0),
        keys))

    def sources():
        return [JaxReplayDraws(s, K, P, tmove.max_proposals, torch.float64)
                for s in seeds]

    out_t = vk.run_window(st_t, ll_t, k0, n_it, sources())
    st, ll, att, acc, nf, hist = out_t
    np.testing.assert_array_equal(hist[2].numpy(), out_j[5][2])   # accept
    assert 0 < out_j[5][2].sum() < out_j[5][2].size
    np.testing.assert_array_equal(att.numpy(), out_j[2])
    np.testing.assert_array_equal(acc.numpy(), out_j[3])
    assert out_j[2].sum() == E * 3 * (K - 1)
    assert rel_err(hist[0].numpy(), out_j[5][0]) < 1e-9
    assert rel_err(st.numpy(), out_j[0]) < 1e-9
    assert np.max(np.abs(ll.numpy() - out_j[1])) < 1e-6
    assert np.max(np.abs(hist[1].numpy() - out_j[5][1])) < 1e-6
    np.testing.assert_array_equal(nf.numpy(), out_j[4])

    seq = tmet.run_ensembles_sequential(tk, st_t, ll_t, k0, n_it, sources())
    for a, b in zip((*seq[:5], *seq[5]), (*out_t[:5], *out_t[5])):
        assert torch.equal(a, b)
