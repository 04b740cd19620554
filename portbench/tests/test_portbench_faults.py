"""A run driven end to end on the CPU at a size a test holds (curves cut
at 400-800 ns, 2 ensembles, windows of 2 iterations, chunks of 8), with
the timed path sound and then broken underneath: ``correct`` must come
out true, and false for each fault a cell can have. The look for a card
is skipped (the CUDA calls the harness makes are stubbed) and the
program runs its plain path. The control is read at the cells' own size
on the card (test_portbench_control.py): at this size its float32 rung
rows rarely fail."""

import json
import shutil
from time import perf_counter
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import check, common, outcome
from portbench.tests.test_portbench_layout import ROOT, _curves


#: where each configuration's curves are cut in these tests [ns]
CUT = {"staub-flagship": 400, "staub-real-irf": 800}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A checkout whose cells are cut to test size: .root, and .run(cell)
    the cell's outcome."""
    for sub in ("configs", "traffic", "metrics", "data"):
        shutil.copytree(ROOT / "portbench" / sub,
                        tmp_path / "portbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for name, t_end in CUT.items():
        path = tmp_path / "portbench/configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cell = SimpleNamespace(config=common._inf(cfg))
        curves = _curves(cell, tmp_path)
        cfg.pop("synthesize", None)
        cfg["meas_fields"]["time_cutoff"] = [0, t_end]
        cfg["MCMC_fields"]["measurement_path"] = str(curves)
        path.write_text(json.dumps(cfg))
    tr = tmp_path / "portbench/traffic"
    for f, cut in (("walk-e8.json", {"ensembles": 2, "window_iters": 2,
                                     "trace_windows": 1}),
                   ("dense-512.json", {"chunk": 8, "chunks_per_call": 1,
                                       "trace_calls": 1})):
        mix = json.loads((tr / f).read_text())
        mix.update(cut)
        (tr / f).write_text(json.dumps(mix))
    for name, fn in (("is_available", lambda: True),
                     ("synchronize", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(outcome, "DEVICE", "cpu")
    monkeypatch.setattr(outcome, "load_library", lambda: None)
    monkeypatch.setattr(check, "N_STATES", 6)
    monkeypatch.setattr(check, "N_ITERS", 2)
    monkeypatch.setattr(check, "N_SWAPS", 2)

    def run(workload, temper_freq=None):
        import importlib

        if temper_freq:
            path = tmp_path / "portbench/configs" / \
                f"{workload.split('.')[0]}.json"
            cfg = json.loads(path.read_text())
            cfg["MCMC_fields"]["temper_freq"] = temper_freq
            path.write_text(json.dumps(cfg))
        cell = common.Cell(workload, root=tmp_path)
        mode = importlib.import_module(
            f"portbench.harness.{cell.traffic['mode']}")
        args = SimpleNamespace(seed=3000000021, seconds=0.01, trace=0)
        return mode.run(cell, args, perf_counter())
    return SimpleNamespace(run=run, root=tmp_path)


def _wrap_eval(monkeypatch, module, change):
    """Break the likelihood the timed path evaluates: ``change(result,
    states, temps)`` alters what each evaluation returns."""
    make = module.make_eval_logll

    def broken(plan, **kw):
        ev = make(plan, **kw)

        def f(states, temps):
            return change(ev(states, temps), states, temps)
        return f
    monkeypatch.setattr(module, "make_eval_logll", broken)


def _half_batch(r, states, temps):
    """Half of the measurements left out, the mean over the rest."""
    pm = r["per_meas"]
    M = pm.shape[1]
    return dict(r, logll_T=M * pm[:, :M // 2].mean(dim=1))


def _altered(r, states, temps):
    """Every answer altered where it is produced: by 5 %, and by 3."""
    return dict(r, logll_T=1.05 * r["logll_T"] - 3.0)


WALKS = ["staub-flagship.walk-e8", "staub-real-irf.walk-e8"]


@pytest.mark.parametrize("workload", WALKS + ["staub-flagship.dense-512"])
def test_sound_run_is_correct(tiny, workload):
    out = tiny.run(workload)
    assert out.correct, out.compared
    assert out.attempted > 0


@pytest.mark.parametrize("workload", WALKS)
def test_step_that_returns_its_state_unchanged(tiny, workload, monkeypatch):
    from metrotrpl_tpu_torch.inference import mh_core

    monkeypatch.setattr(mh_core, "make_trial_move",
                        lambda state, *a, **k: state.clone())
    assert not tiny.run(workload).correct


def _planted(monkeypatch, fault):
    """readings.py's fault, turned on as the measured windows start; the
    modules it breaks are restored after the test."""
    from metrotrpl_tpu_torch.inference import metropolis, mh_core

    from portbench import readings
    from portbench.harness import walk

    monkeypatch.setattr(metropolis, "make_eval_logll",
                        metropolis.make_eval_logll)
    monkeypatch.setattr(mh_core, "swap_perm_round", mh_core.swap_perm_round)
    on = readings.plant(fault)
    measure = walk.Walk.measure

    def measure_on(self, *a, **k):
        on["v"] = True
        return measure(self, *a, **k)
    monkeypatch.setattr(walk.Walk, "measure", measure_on)


def _failing(out):
    return {k for k, v, lim in out.compared if v > lim}


@pytest.mark.parametrize("workload", WALKS)
def test_every_proposal_rejected(tiny, workload, monkeypatch):
    """Each proposal's log-likelihood comes back far too low, so the walk
    rejects every proposal and its states and records stay as they
    were: only the reference's accepts can see it."""
    _planted(monkeypatch, "reject-all")
    out = tiny.run(workload)
    assert not out.correct
    assert _failing(out) == {"accepts_missed"}


@pytest.mark.parametrize("workload", WALKS)
def test_swap_rounds_left_out(tiny, workload, monkeypatch):
    """Every swap round leaves the ensemble as it was; a swap round every
    other iteration, so that the measured History holds one."""
    _planted(monkeypatch, "no-swap")
    out = tiny.run(workload, temper_freq=2)
    assert not out.correct
    assert "swaps_wrong" in _failing(out)


@pytest.mark.parametrize("workload", WALKS)
def test_sound_run_with_swap_rounds_is_correct(tiny, workload):
    out = tiny.run(workload, temper_freq=2)
    assert out.correct, out.compared
    assert "swaps_wrong" in {k for k, _, _ in out.compared}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in WALKS + ["staub-flagship.dense-512"]
    for f in (_half_batch, _altered)])
def test_likelihood_faults(tiny, workload, fault, monkeypatch):
    from metrotrpl_tpu_torch.inference import dense, metropolis

    mod = dense if "dense" in workload else metropolis
    _wrap_eval(monkeypatch, mod, fault)
    assert not tiny.run(workload).correct


def test_readings_judge_a_faulty_walk_apart(tiny, monkeypatch, capsys):
    """readings.py on the CPU: a walk's evidence written with every
    proposal rejected, then judged by the reference and the control."""
    import json as js

    from metrotrpl_tpu_torch.inference import metropolis

    from portbench import readings

    monkeypatch.setattr(metropolis, "make_eval_logll",
                        metropolis.make_eval_logll)
    w, out = "staub-flagship.walk-e8", tiny.root / "readings"
    common_args = ["--workload", w, "--root", str(tiny.root), "--out",
                   str(out)]
    readings.main(common_args + ["--seeds", "3000000031", "--seconds",
                                 "0.01", "--evidence-only", "--fault",
                                 "reject-all", "--device", "cpu"])
    readings.main(common_args + ["--judge", str(out), "--device", "cpu"])
    recs = [js.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]
    assert len(recs) == 2
    r = recs[1]
    assert r["accepts_missed"] == 1.0 and r["moves_wrong"] == 0
    assert r["ll_off_share"] == 0.0
    assert 0.0 <= r["ctl_accepts_missed"] <= 1.0
