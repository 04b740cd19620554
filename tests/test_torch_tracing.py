"""The port's spans (metrotrpl_tpu_torch/tracing.py) on the smallest walk
the tests build (torch_parity.walk_setup: nx=8, one curve, 2 chains):
nothing recorded and no profiler range opened without a profiler; under
one, a span per iteration and per evaluation with the right parents, in
the profiler's trace too; the walk's bits the same either way; and the
host-sync count, silent, routed to the innermost span."""

import json
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from metrotrpl_tpu_torch import tracing
from metrotrpl_tpu_torch.inference.likelihood import build_likelihood_plan
from metrotrpl_tpu_torch.inference.metropolis import (
    build_mh_kernel,
    vmap_ensembles,
)
from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
from metrotrpl_tpu_torch.inference.moves import build_move_plan, n_tries
from torch_parity import walk_setup

N_ITERS = 2
ITERATION = "metrotrpl.walk.iteration"
EVAL = "metrotrpl.likelihood.eval"
SYNC = "called a synchronizing CUDA operation"


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    """The walk built, then one window without a profiler (with
    record_function made to fail) and the same window under one. The step
    grid starts at 1 ns and doubles (7 steps, the ladder's 14), so that
    the profiled window stays short on the CPU."""
    out = tmp_path_factory.mktemp("tracing")
    sim_info, iniPar, e_data, mc, pi = walk_setup(out, N_ITERS)
    tracing.reset()
    like_plan = build_likelihood_plan(sim_info, pi, mc, e_data, iniPar,
                                      hmax=16.0, align_outputs=False,
                                      h0=1.0, growth=2.0)
    move_plan = build_move_plan(pi, mc)
    names = pi["names"]
    temps = np.asarray(mc["parallel_tempering"])
    base = np.array([pi["trial_move"][n] if pi["active"][n] else 0.0
                     for n in names])
    kernel = vmap_ensembles(build_mh_kernel(
        like_plan, move_plan, temps, base, mc["temper_freq"], True,
        dtype=torch.float64, device="cpu"))
    built = tracing.records()
    x0 = np.array([pi["init_guess"][n] for n in names])
    states = torch.as_tensor(np.broadcast_to(
        x0, (1, len(temps), len(names))).copy())
    ll = kernel.init_ll(states)

    def window():
        src = TorchDraws(7, len(temps), len(names), n_tries(move_plan),
                         False, torch.float64, "cpu")
        return kernel.run_window(states, ll, 1, N_ITERS, [src])

    def no_range(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    tracing.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", no_range)
        off = window()
    off_records = tracing.records()
    trace = out / "trace.json"
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = window()
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    return {"built": built, "off": off, "off_records": off_records,
            "on": on, "on_records": tracing.records(), "events": events,
            "warnings": [str(w.message) for w in seen]}


def test_profiler_flag_follows_the_profiler():
    """The private flag every span checks: off, on inside a profiler, and
    off again after it."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_no_profiler_records_nothing(walks):
    assert walks["off_records"] == []
    # the set-up's build spans record with or without a profiler
    # (the plan, then the evaluator's tensors)
    assert [(r.name, r.traced) for r in walks["built"]] == [
        ("metrotrpl.likelihood.build", False)] * 2


def test_spans_under_the_profiler(walks):
    recs = walks["on_records"]
    iters = [i for i, r in enumerate(recs) if r.name == ITERATION]
    evals = [r for r in recs if r.name == EVAL]
    assert len(iters) == len(evals) == N_ITERS
    assert [r.parent for r in evals] == iters
    assert all(r.traced for r in recs)
    for i, r in enumerate(recs):
        if r.parent >= 0:   # children lie inside their parent
            p = recs[r.parent]
            assert p.t0 <= r.t0 <= r.t1 <= p.t1
            assert r.parent < i
    by_parent = {}
    for r in recs:
        by_parent.setdefault(r.parent, []).append(r)
    # the ladder's sync and the IRF stage run inside each evaluation
    for i in (recs.index(e) for e in evals):
        assert {c.name for c in by_parent[i]} == {
            "metrotrpl.ladder.sync", "metrotrpl.likelihood.irf"}
    for i in iters:
        r = recs[i]
        own = (r.t1 - r.t0) - sum(c.t1 - c.t0 for c in by_parent[i])
        assert 0 <= own <= r.t1 - r.t0
    ranges = [e["name"] for e in walks["events"]
              if e.get("cat") == "user_annotation"]
    for name in (ITERATION, EVAL):
        assert ranges.count(name) == N_ITERS


def test_tracing_changes_no_bit(walks):
    off, on = walks["off"], walks["on"]
    for a, b in zip(off[:5], on[:5]):
        assert torch.equal(a, b)
    for a, b in zip(off[5], on[5]):   # History: states, ll, accepts
        assert torch.equal(a, b)


def test_sync_count_is_zero_and_silent_without_cuda(walks):
    assert not torch.cuda.is_initialized()
    assert all(r.syncs == 0 for r in walks["on_records"])
    assert not [m for m in walks["warnings"] if m.startswith(SYNC)]


def test_sync_warning_counts_against_the_innermost_span(monkeypatch):
    """The routing of the sync warning, with the CUDA calls faked: each
    counts once against the innermost open span and is not shown; other
    warnings pass; the first span after the profiler puts the mode, the
    hook and the filter back."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    tracing.reset()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        filters = list(warnings.filters)
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    warnings.warn(f"{SYNC} (Triggered internally at x.cpp)")
                for _ in range(2):
                    warnings.warn(SYNC)
                warnings.warn("another warning")
        assert modes == ["warn"]
        with tracing.span("after"):
            pass
        assert modes == ["warn", 0]
        assert warnings.filters == filters
        warnings.warn(SYNC)
    assert [(r.name, r.syncs, r.traced) for r in tracing.records()] == [
        ("outer", 2, True), ("inner", 1, True)]
    assert [str(w.message) for w in seen] == ["another warning", SYNC]
