"""PyTorch port parity of the sharded walk (``metrotrpl_tpu_torch.parallel``):
the window on a 2x2 world of gloo processes on the CPU, fed the JAX
keyed stream, against JAX ``build_sharded_mh_kernel`` on a 2x2
virtual-CPU mesh (float64), and against the port's fused window; the
identity topology against the default window; the mesh's errors.

The spawned ranks import this module, so it imports jax and the JAX
package only inside the tests."""

import os
import pickle
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from metrotrpl_tpu_torch.inference.mh_core import (
    IterDraws,
    make_window_body,
    single_device_topology,
)
from metrotrpl_tpu_torch.parallel import ChainMesh, make_chain_mesh
from metrotrpl_tpu_torch.parallel.mesh import mesh_backend, mesh_devices
from metrotrpl_tpu_torch.parallel.sharded_mh import build_sharded_mh_kernel

TEMPS = np.array([1.0, 2.0, 4.0, 8.0])
E, K, K0, N_IT, SEED = 2, 4, 1, 4, 17


class _Replay:
    """Draw source replaying precomputed draws: {k: (u_prop, u_mu, u_acc,
    swap_i, swap_u)} as numpy arrays."""

    def __init__(self, by_k):
        self.by_k = by_k

    def draws(self, k):
        u, um, ua, si, su = self.by_k[k]
        return IterDraws(torch.as_tensor(u), torch.as_tensor(um),
                         torch.as_tensor(ua), torch.as_tensor(si),
                         torch.as_tensor(su))


def _window_rank(rank, work):
    """One rank of the 2x2 world: its block's window on the inputs in
    inputs.pik, saved to rank{rank}.npz."""
    with open(os.path.join(work, "inputs.pik"), "rb") as f:
        plan, move, base_move, states, ll, draws = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=4,
                            init_method=f"file://{work}/rendezvous",
                            timeout=timedelta(seconds=120))
    try:
        mesh = make_chain_mesh((2, 2), ["cpu"] * 4, timeout=120)
        kern = build_sharded_mh_kernel(plan, move, TEMPS, base_move, 2, True,
                                       mesh, n_ens=E, dtype=torch.float64)
        e0, c0 = kern.topo.offsets()
        blk = (slice(e0, e0 + kern.topo.E_l), slice(c0, c0 + kern.topo.K_l))
        out = kern.run_window(torch.as_tensor(states[blk]),
                              torch.as_tensor(ll[blk]), K0, N_IT,
                              [_Replay(draws[e]) for e in range(E)][blk[0]])
        st, lo, att, acc, nf, hist = out
        np.savez(os.path.join(work, f"rank{rank}.npz"), e0=e0, c0=c0,
                 st=st.numpy(), ll=lo.numpy(), att=att.numpy(),
                 acc=acc.numpy(), nf=nf.numpy(),
                 **{f"h{i}": h.numpy() for i, h in enumerate(hist)})
    finally:
        dist.destroy_process_group()


def _spawn(fn, n, args, limit=240):
    """Run fn(rank, *args) in n spawned processes; fail on a rank's error
    or after `limit` seconds."""
    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


def test_sharded_window_matches_jax_and_fused(tmp_path):
    """E=2 ensembles of K=4 tempered chains, one 311 nm curve at nx=16,
    float64, swaps every 2nd iteration, 4 iterations: the port's window on
    a 2x2 world of gloo processes (each rank a 1 x 2 block), fed JAX's
    keyed stream of each global ensemble, equals the port's fused window
    bit for bit and follows JAX build_sharded_mh_kernel on a 2x2 mesh:
    accepts, swap counters and failure counts exact, states and ll within
    rel 1e-12."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from torch_parity import JaxReplayDraws, param_info, synth_config

    from metrotrpl_tpu.inference import likelihood as jl
    from metrotrpl_tpu.inference.moves import build_move_plan as j_move
    from metrotrpl_tpu.parallel.sharded_mh import build_sharded_mh_kernel \
        as j_sharded
    from metrotrpl_tpu.workloads import STAUB_PRIOR
    from metrotrpl_tpu_torch.convert import from_reference_plan
    from metrotrpl_tpu_torch.inference import metropolis as tmet

    sim_info, mcmc, e_data, iniPar = synth_config(
        nx=16, lengths=(311.0,), nt=6, t_end=50.0, hard_bounds=1,
        model_uncertainty=0.02)
    pi = param_info(trial_move=0.05, prior=dict(STAUB_PRIOR))
    jplan = jl.build_likelihood_plan(sim_info, pi, mcmc, e_data, iniPar,
                                     hmax=16.0, align_outputs=False,
                                     escalate=False)
    jmove = j_move(pi, mcmc)
    tplan, tmove = from_reference_plan(jplan, jmove)
    names = pi["names"]
    P = len(names)
    base = np.array([pi["init_guess"][n] for n in names])
    active = np.array([bool(pi["active"][n]) for n in names])
    rng = np.random.default_rng(5)
    states = base * 10.0 ** (rng.uniform(-0.03, 0.03, (E, K, P)) * active)

    fk = tmet.vmap_ensembles(tmet.build_mh_kernel(
        tplan, tmove, TEMPS, jmove.trial_move, 2, True, dtype=torch.float64,
        device="cpu"))
    ll = fk.init_ll(torch.as_tensor(states)).numpy()
    draws = []
    for e in range(E):
        src = JaxReplayDraws(SEED, K, P, tmove.max_proposals, torch.float64,
                             ens=e)
        draws.append({k: tuple(a.numpy() for a in src.draws(k))
                      for k in range(K0, K0 + N_IT)})
    fused = fk.run_window(torch.as_tensor(states), torch.as_tensor(ll), K0,
                          N_IT, [_Replay(d) for d in draws])
    fused = [a.numpy() for a in (*fused[:5], *fused[5])]

    # spawn arguments stay small: a start blocks until the process before
    # it has read a payload larger than a pipe's buffer
    with open(tmp_path / "inputs.pik", "wb") as f:
        pickle.dump((tplan, tmove, jmove.trial_move, states, ll, draws), f)
    _spawn(_window_rank, 4, (str(tmp_path),))
    mine = [np.zeros_like(a) for a in fused]
    for r in range(4):
        z = np.load(tmp_path / f"rank{r}.npz")
        e, c = slice(int(z["e0"]), int(z["e0"]) + 1), \
            slice(int(z["c0"]), int(z["c0"]) + 2)
        for i, key in enumerate(("st", "ll", "att", "acc")):
            mine[i][e, c] = z[key]
        mine[4][e] = z["nf"]
        for i in range(3):
            mine[5 + i][e, :, c] = z[f"h{i}"]
    for a, b in zip(mine, fused):
        np.testing.assert_array_equal(a, b)

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("ens", "chains"))
    jk = j_sharded(jplan, jmove, TEMPS, jmove.trial_move, 2, True,
                   window=N_IT, mesh=mesh, n_ens=E, dtype=jnp.float64)
    with mesh:
        out_j = jax.tree.map(np.asarray, jk.run_window(
            jnp.asarray(states), jnp.asarray(ll), jnp.asarray(K0),
            jax.random.PRNGKey(SEED)))
    st, lo, att, acc, nf, hist = mine[:5] + [mine[5:]]
    h_j = [np.moveaxis(h, 0, 1) for h in out_j[5]]   # (n, E, ...) first
    np.testing.assert_array_equal(hist[2], h_j[2])   # accept
    assert 0 < h_j[2].sum() < h_j[2].size
    np.testing.assert_array_equal(att, out_j[2])
    np.testing.assert_array_equal(acc, out_j[3])
    assert out_j[2].sum() == E * 2 * (K - 1)          # k = 2, 4
    np.testing.assert_array_equal(nf, out_j[4])
    for a, b in ((st, out_j[0]), (hist[0], h_j[0]), (lo, out_j[1]),
                 (hist[1], h_j[1])):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def test_pow10_does_not_depend_on_the_batch():
    """pow10 of an element is the same in a tensor of one element as in a
    tensor of 4000 (float64 and float32): the walk's powers of ten do not
    move when a rank's block holds fewer rows than the fused batch."""
    from metrotrpl_tpu_torch import pow10

    rng = np.random.default_rng(3)
    for dt in (torch.float64, torch.float32):
        x = torch.as_tensor(rng.uniform(-30, 30, 4000), dtype=dt)
        whole = pow10(x)
        alone = torch.cat([pow10(x[i:i + 1].clone()) for i in range(4000)])
        assert torch.equal(whole, alone)
        np.testing.assert_allclose(whole.double().numpy(),
                                   10.0 ** x.double().numpy(),
                                   rtol=2e-14 if dt == torch.float64
                                   else 1e-5)


@pytest.mark.parametrize("n_ens", [1, 3])
def test_identity_topology_equals_default_window(n_ens):
    """make_window_body with single_device_topology(E, K) given explicitly
    equals the default (topo=None) window bit for bit, on a cheap Gaussian
    likelihood with swaps every 2nd iteration; a block that does not fit
    the topology raises."""
    from torch_parity import param_info

    from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
    from metrotrpl_tpu_torch.inference.moves import build_move_plan
    from metrotrpl_tpu_torch.workloads import STAUB_PRIOR

    pi = param_info(trial_move=0.05, prior=dict(STAUB_PRIOR))
    move = build_move_plan(pi, {"hard_bounds": 1})
    base = np.array([pi["init_guess"][n] for n in pi["names"]])
    P = len(base)
    temps = torch.as_tensor(TEMPS)
    widths = temps.sqrt()[:, None] * torch.as_tensor(move.trial_move)[None]
    centre = torch.as_tensor(np.log10(base))

    def eval_nf(s):
        d2 = torch.sum((torch.log10(s) - centre) ** 2, dim=1)
        return (-d2[:, None] / (2e-3 * temps[None, :]),
                torch.zeros(s.shape[0], dtype=torch.int64))

    rng = np.random.default_rng(2)
    states = torch.as_tensor(
        base * 10.0 ** (rng.uniform(-0.02, 0.02, (n_ens, K, P))
                        * move.active))
    ll = eval_nf(states.reshape(-1, P))[0].reshape(n_ens, K, K)
    outs = []
    for topo in (None, single_device_topology(n_ens, K)):
        window = make_window_body(eval_nf, move, widths, 2, True, topo)
        srcs = [TorchDraws(3 + e, K, P, 100, False, torch.float64, "cpu")
                for e in range(n_ens)]
        out = window(states, ll, 1, 6, srcs)
        outs.append([*out[:5], *out[5]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert 0 < int(outs[0][7].sum()) < outs[0][7].numel()
    bad = make_window_body(eval_nf, move, widths, 2, True,
                           single_device_topology(n_ens + 1, K))
    with pytest.raises(ValueError, match="topology"):
        bad(states, ll, 1, 1, srcs)


def test_mesh_errors(monkeypatch, tmp_path):
    """A mesh that does not divide E or K raises ValueError (the kernel and
    metro, before anything is spawned); asking for more cards than the
    host has raises, as does a device list of the wrong length; the
    backend follows the devices."""
    from torch_parity import walk_setup

    from metrotrpl_tpu_torch.inference.metropolis import metro

    mesh = ChainMesh(shape=(2, 3), rank=0, i_e=0, i_c=0,
                     device=torch.device("cpu"), backend="gloo",
                     chains_group=None, comm_device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        build_sharded_mh_kernel(None, None, TEMPS, np.ones(3), 2, True, mesh,
                                n_ens=2)
    with pytest.raises(ValueError, match="not divisible"):
        metro(*walk_setup(tmp_path, 3), device="cpu", trap_signals=False,
              seed=1, n_ensembles=2, mesh_shape=(3, 1))
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".mesh")]
    with pytest.raises(ValueError, match="devices were given"):
        mesh_devices((1, 2), ["cpu"])
    assert mesh_devices((2, 2), device="cpu") == [torch.device("cpu")] * 4
    if not torch.cuda.is_available():   # no card: cuda raises, no fallback
        with pytest.raises(RuntimeError, match="is_available"):
            mesh_devices((1, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices; only 1"):
        mesh_devices((1, 2))
    with pytest.raises(ValueError, match="has 1 cards"):
        mesh_devices((1, 2), ["cuda:0", "cuda:1"])
    shared = mesh_devices((1, 2), ["cuda:0", "cuda"])
    assert shared == [torch.device("cuda", 0)] * 2
    assert mesh_backend(shared) == "gloo"
    assert mesh_backend(mesh_devices((1, 1))) == "nccl"
    assert mesh_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh_backend(["cpu", "cpu"]) == "gloo"
