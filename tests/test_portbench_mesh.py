"""The benchmark's mesh cell (portbench/harness/mesh.py) on the CPU: one
spawned 2x2 world of gloo ranks, a thread each, at a small size (nx 16,
curves cut at 20 ns, 4 ensembles x 8 chains, windows of one iteration, a
swap round every iteration, the measured window traced), in which ensemble
block 1 (ranks 2 and 3) walks with a planted fault: its swap rounds'
scatter keeps the other chain block's rows. The History gathered from
block 0 must pass the check against the plain reference, block 1's must
fail it, and each rank's spans and collectives must count the walk."""

import json
import shutil
from time import perf_counter
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.harness import check, common, mesh, outcome

ROOT = common.REPO_DIR
CELL = "staub-flagship-mpi.mesh-2x2"
SEED = 3000000021
#: the test's size: grid cells, the curves' end [ns], ensembles, window
NX, T_END, E, W = 16, 20, 4, 1


def _wrong_block_scatter(rank):
    """In ensemble block 1 (ranks 2 and 3) the swap round's scatter keeps
    the other chain block's rows (states, ll, counts)."""
    if rank < 2:
        return
    from metrotrpl_tpu_torch.parallel import sharded_mh

    make = sharded_mh.mesh_topology

    def broken(m, n_ens, n_chains, n_params):
        tp = make(m, n_ens, n_chains, n_params)
        c = (1 - m.i_c) * tp.K_l
        rows = slice(c, c + tp.K_l)
        return tp._replace(scatter=lambda st, ll, att, acc: (
            st[:, rows], ll[:, rows], att[:, rows], acc[:, rows]))
    sharded_mh.mesh_topology = broken


def _tiny_checkout(root):
    for sub in ("configs", "traffic", "metrics", "data"):
        shutil.copytree(ROOT / "portbench" / sub, root / "portbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", root)
    path = root / "portbench/configs/staub-flagship-mpi.json"
    cfg = json.loads(path.read_text())
    t = np.linspace(0, T_END, 11)
    curve = np.stack([t, np.exp(-t / 300.0) + 1e-3, np.full_like(t, .02)], 1)
    np.savetxt(root / "curves.csv", np.concatenate(
        [curve] * cfg["simPar"]["num_meas"]), delimiter=",")
    cfg.pop("synthesize")
    cfg["simPar"]["nx"] = [NX] * cfg["simPar"]["num_meas"]
    cfg["meas_fields"]["time_cutoff"] = [0, T_END]
    cfg["MCMC_fields"]["measurement_path"] = str(root / "curves.csv")
    cfg["MCMC_fields"]["temper_freq"] = 1
    cfg["deployment"]["ensembles"] = E
    path.write_text(json.dumps(cfg))
    mix = root / "portbench/traffic/mesh-2x2.json"
    tr = json.loads(mix.read_text())
    tr.update(ensembles=E, window_iters=W, trace_windows=1)
    mix.write_text(json.dumps(tr))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cell run once, traced: (cell, outcome)."""
    root = tmp_path_factory.mktemp("mesh")
    _tiny_checkout(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "CACHE_DIR", root / "cache")
        mp.setattr(outcome, "DEVICE", "cpu")
        mp.setattr(outcome, "load_library", lambda: None)
        mp.setattr(check, "N_STATES", 6)
        mp.setattr(check, "N_ITERS", 2)
        mp.setattr(check, "N_SWAPS", 2)
        mp.setattr(mesh.torch, "get_num_threads", lambda: 4)
        cell = common.Cell(CELL, root=root)
        args = SimpleNamespace(seed=SEED, seconds=0.01, trace=1)
        out = mesh.run(cell, args, perf_counter(),
                       prepare=_wrong_block_scatter)
        yield cell, out


def _block(out, i_e):
    """The History and seeds of ensemble block i_e."""
    blk = slice(i_e * E // 2, (i_e + 1) * E // 2)
    h = out.history
    return (h[0],) + tuple(a[blk] for a in h[1:]), out.seeds[blk]


def _verdict(cell, out, i_e, monkeypatch):
    monkeypatch.setattr(check, "N_STATES", 6)
    monkeypatch.setattr(check, "N_ITERS", 2)
    monkeypatch.setattr(check, "N_SWAPS", 2)
    hist, seeds = _block(out, i_e)
    compared, ok = check.walk_verdict(cell, hist, seeds, out.dtype, "cpu",
                                      SEED)
    return {k: (v, lim) for k, v, lim in compared}, ok


def test_gathered_history_passes_the_check(world, monkeypatch):
    cell, out = world
    assert out.history[3].shape == (E, W, 8, 13)   # the measured window
    assert out.seeds == [SEED + e for e in range(E)]
    assert out.attempted == W * E * 8 * 6 and out.failed == 0
    assert out.e2e["setup_s"] > 0     # traced: no rate
    nums, ok = _verdict(cell, out, 0, monkeypatch)
    assert ok, nums
    assert "swaps_wrong" in nums


def test_wrong_block_scatter_reads_incorrect(world, monkeypatch):
    cell, out = world
    nums, ok = _verdict(cell, out, 1, monkeypatch)
    assert not ok
    assert nums["moves_wrong"][0] > 0 or \
        nums["swaps_wrong"][0] > nums["swaps_wrong"][1], nums


def test_spans_and_collectives_count_the_walk(world):
    """Each rank's traced window (iteration 2): one swap round, one
    History gather and one failure sum, each in its
    span, and as many collectives counted, with the bytes of their
    buffers (float64 on the CPU)."""
    _, out = world
    P, K, K_l, E_l = 13, 8, 4, 2
    ranks = out.ctx["ranks"]
    assert len(ranks) == 4
    for t in ranks:
        assert (t["iterations"], t["windows"], t["swap_rounds"]) == (W, 1, 1)
        n = t["span_counts"]
        assert (n[mesh.GATHER], n[mesh.HISTORY], n[mesh.FAIL_SUM]) == \
            (1, 1, 1)
        gather = E_l * K_l * (P + K)
        history = E_l * K_l * (W * P + 2 * W + 2 + K)
        assert t["comm"] == (3, 8 * (gather + history + E_l))
        assert t["nccl_s"] == {}      # gloo: no NCCL kernel
    assert out.ctx["trace"].window_s > 0


def test_rung_rows_imbalance_reads_the_ranks(world):
    cell, out = world
    ranks = [{"counters": {("std", "float64"): (1, rows)}}
             for rows in (10, 30, 20, 20)]
    ctx = dict(out.ctx, ranks=ranks)
    assert cell.reader("rung_rows_imbalance.mesh")(ctx) == 1.5
    assert cell.reader("gather_ms_per_swap.mesh")(out.ctx) is None


def test_a_mix_off_the_deployment_is_refused(tmp_path):
    """The mix has to run the grid and the ensembles that the
    configuration's deployment states."""
    for sub in ("configs", "traffic"):
        shutil.copytree(ROOT / "portbench" / sub, tmp_path / "portbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    mix = tmp_path / "portbench/traffic/mesh-2x2.json"
    tr = json.loads(mix.read_text())
    assert common.Cell(CELL, root=tmp_path).config["deployment"]["mesh"] \
        == tr["mesh"]
    mix.write_text(json.dumps(dict(tr, mesh=[1, 4])))
    cell = common.Cell(CELL, root=tmp_path)
    args = SimpleNamespace(seed=SEED, seconds=1.0, trace=0)
    with pytest.raises(ValueError, match="deployment"):
        mesh._job(cell, args, 0.0, tmp_path, None)
