"""The readers of the program's own spans, on records made by hand: self
time, the traced and set-up split, the division by the work done, and
nothing read where the program kept nothing."""

import pytest

from portbench.harness import common, spans

#: (name, parent, t0, t1, syncs, traced): two set-up builds, then two
#: traced iterations, each with an evaluation holding the ladder's sync
#: and the IRF stage, then a build after the traced windows
RECORDS = [
    (spans.BUILD, -1, 0.0, 0.5, 3, False),
    (spans.BUILD, -1, 0.6, 0.8, 30, False),
    (spans.ITERATION, -1, 10.0, 10.010, 5, True),         # 2
    (spans.EVAL, 2, 10.002, 10.008, 2, True),             # 3
    (spans.LADDER_SYNC, 3, 10.003, 10.004, 1, True),
    (spans.IRF, 3, 10.005, 10.007, 0, True),
    (spans.ITERATION, -1, 10.020, 10.032, 5, True),        # 6
    (spans.EVAL, 6, 10.022, 10.030, 2, True),             # 7
    (spans.LADDER_SYNC, 7, 10.023, 10.026, 1, True),
    (spans.IRF, 7, 10.027, 10.029, 0, True),
    (spans.BUILD, -1, 20.0, 20.4, 30, False),
]


class Trace:
    span_device_s = {spans.IRF: 0.006, "portbench.irf_stage": 0.0061}


def _ctx(iterations=2, evaluations=2):
    return {"trace": Trace(), "iterations": iterations,
            "evaluations": evaluations}


def _read(cell, name, ctx, records, monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: records)
    return common.Cell(cell).reader(name)(ctx)


WALK = "staub-real-irf.walk-e8"


@pytest.mark.parametrize("name, value", [
    # the iterations' 22 ms less their evaluations' 14 ms, per iteration
    ("loop_host_ms_per_iter.walk", 4.0),
    # 5 + 2 + 1 + 0 syncs an iteration; the builds are not traced
    ("host_syncs_per_eval.walk", 8.0),
    ("ladder_wait_ms_per_eval.walk", 2.0),
    ("irf_span_ms_per_iter.walk", 3.0),
    # the builds before the first traced record, not the one after
    ("setup_plan_s.walk", 0.7),
])
def test_walk_readers(name, value, monkeypatch):
    got = _read(WALK, name, _ctx(), RECORDS, monkeypatch)
    assert got == pytest.approx(value)


def test_self_time_is_within_the_duration():
    for name in (spans.ITERATION, spans.EVAL, spans.LADDER_SYNC):
        assert 0 <= spans.self_s(RECORDS, name) <= spans.host_s(
            RECORDS, name)
    # leaves: their self time is their duration
    assert spans.self_s(RECORDS, spans.IRF) == pytest.approx(0.004)


def test_dense_readers(monkeypatch):
    """A traced call rebuilds the plan: its build counts per chunk, and
    its syncs with the chunks'."""
    recs = [
        (spans.BUILD, -1, 0.0, 1.0, 3, False),
        (spans.BUILD, -1, 1.0, 1.5, 30, False),
        (spans.BUILD, -1, 5.0, 5.004, 3, True),
        (spans.BUILD, -1, 5.004, 5.010, 29, True),
        ("metrotrpl.dense.chunk", -1, 5.010, 5.090, 4, True),
        (spans.EVAL, 4, 5.011, 5.080, 1, True),
        (spans.LADDER_SYNC, 5, 5.030, 5.040, 1, True),
        ("metrotrpl.dense.chunk", -1, 5.090, 5.170, 4, True),
        (spans.EVAL, 7, 5.091, 5.160, 1, True),
        (spans.LADDER_SYNC, 8, 5.100, 5.112, 1, True),
    ]
    cell = "staub-flagship.dense-512"
    ctx = _ctx(iterations=0, evaluations=2)
    got = {n: _read(cell, n, ctx, recs, monkeypatch) for n in (
        "host_syncs_per_eval.dense", "rebuild_ms_per_eval.dense",
        "ladder_wait_ms_per_eval.dense", "setup_plan_s.dense")}
    assert got == pytest.approx({
        "host_syncs_per_eval.dense": (3 + 29 + 2 * (4 + 1 + 1)) / 2,
        "rebuild_ms_per_eval.dense": 10.0 / 2,
        "ladder_wait_ms_per_eval.dense": 22.0 / 2,
        "setup_plan_s.dense": 1.5})


@pytest.mark.parametrize("records", [None, [], RECORDS[:2]],
                         ids=["no tracing module", "no records",
                              "nothing traced"])
def test_nothing_to_read(records, monkeypatch):
    """A program without the spans (or a run that traced none) reads
    nothing, for every reader of its spans; so does a trace without the
    IRF span."""
    monkeypatch.setattr(spans, "program_records",
                        lambda: None if not records or not any(
                            r[5] for r in records) else records)
    for cell in (WALK, "staub-flagship.dense-512"):
        c = common.Cell(cell)
        for m in c.per_layer:
            if m["source"] == "program_span" or m["name"].startswith(
                    "host_syncs"):
                assert c.reader(m["name"])(_ctx()) is None, m["name"]

    class Bare:
        span_device_s = {}
    ctx = dict(_ctx(), trace=Bare())
    assert common.Cell(WALK).reader("irf_span_ms_per_iter.walk")(ctx) is None


def test_no_evaluations_reads_nothing(monkeypatch):
    assert _read(WALK, "host_syncs_per_eval.walk", _ctx(0, 0), RECORDS,
                 monkeypatch) is None


def test_program_records_without_the_program(monkeypatch):
    """The parent of the change that added the spans has no tracing
    module: the helper reads nothing and raises nothing."""
    import sys

    monkeypatch.setitem(sys.modules, "metrotrpl_tpu_torch.tracing", None)
    assert spans.program_records() is None
