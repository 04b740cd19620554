"""PyTorch port end to end over a mesh of processes on the CPU:
metro(mesh_shape=...) at 1x2, 2x1 and 2x2 (gloo ranks) equals
metro(n_ensembles=2) at the same seeds, History and swap counters bit for
bit, through checkpoints that the JAX package loads."""

import json
import os

import numpy as np
import pytest
from torch_parity import walk_setup

from metrotrpl_tpu.io.ensemble import load_checkpoint as j_load

N_ITERS = 5


def _metro(out, **kw):
    from metrotrpl_tpu_torch.inference.metropolis import metro

    return metro(*walk_setup(out, N_ITERS), device="cpu", trap_signals=False,
                 seed=21, n_ensembles=2, **kw)


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    return _metro(tmp_path_factory.mktemp("fused"))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_metro_mesh_equals_fused(fused, shape, tmp_path):
    """Each replica's History and swap counters equal the fused walk's bit
    for bit, in the returned ensembles and in the CPU{e}-final.pik the
    block leaders wrote (loaded by the JAX package); every rank wrote its
    own log file and report (gloo, cpu, its place in the grid), and the
    rendezvous directory is gone. Each rank's report counts the
    collectives of its chains group that the walk's length implies, with
    the bytes of the rank's own buffers (float64): the initial state's
    gather, a History gather and a failure sum a window, an all-gather a
    swap round."""
    enss = _metro(tmp_path, mesh_shape=shape)
    assert len(enss) == 2
    for e, ref in enumerate(fused):
        back = j_load(str(tmp_path / f"CPU{e}-final.pik"))
        for ens in (enss[e], back):
            assert ens.latest_iter == N_ITERS
            assert ens.ensemble_fields["_rng_seed"] == 21 + e
            for a in ("states", "loglikelihood", "accept", "swap_attempts",
                      "swap_accept"):
                np.testing.assert_array_equal(getattr(ens.H, a),
                                              getattr(ref.H, a), err_msg=a)
    assert fused[0].H.swap_attempts.sum() > 0
    n = shape[0] * shape[1]
    names = os.listdir(tmp_path)
    assert not [p for p in names if p.startswith(".mesh")]
    for r in range(n):
        assert sum(p.startswith(f"Ensemble0.rank{r}2") for p in names) == 1
        with open(tmp_path / f"mesh_rank{r}.json") as f:
            rep = json.load(f)
        assert (rep["backend"], rep["device"]) == ("gloo", "cpu")
        assert divmod(r, shape[1]) == (rep["i_e"], rep["i_c"])
        assert sum(rep["launches"].values()) == 0   # the CPU launches none
        assert (rep["collectives"], rep["collective_bytes"]) == \
            _collectives(shape, fused[0].H.states.shape[1])


def _collectives(shape, P, K=2, temper_freq=2, checkpoint_freq=3):
    """(count, bytes) of one rank's collectives over a walk of iterations
    1 .. N_ITERS - 1 in windows of checkpoint_freq (walk_setup's)."""
    E_l, K_l = 2 // shape[0], K // shape[1]
    iters = range(1, N_ITERS)
    windows = [len(iters[i:i + checkpoint_freq])
               for i in range(0, len(iters), checkpoint_freq)]
    swaps = sum(1 for k in iters if k % temper_freq == 0)
    count = 1 + 2 * len(windows) + swaps
    scalars = E_l * K_l * (1 + swaps * (P + K)) + sum(
        E_l * K_l * (n * P + 2 * n + 2 + K) + E_l for n in windows)
    return count, 8 * scalars
