"""The reader of the walk's graph replays on records made by hand: the
traced replay spans per iteration, and nothing where the program kept no
records or replayed no graph."""

import pytest

from portbench.harness import common, spans

WALKS = ["staub-flagship.walk-e8", "staub-real-irf.walk-e8"]
REPLAY = "metrotrpl.walk.replay"


def _iteration(t, first, replays):
    """An iteration's records from index ``first`` on: the iteration, its
    evaluation, then ``replays`` replays inside the evaluation."""
    recs = [(spans.ITERATION, -1, t, t + 0.01, 1, True),
            (spans.EVAL, first, t + 0.001, t + 0.009, 1, True)]
    recs += [(REPLAY, first + 1, t + 0.002 + 0.001 * j, t + 0.0025
              + 0.001 * j, 0, True) for j in range(replays)]
    return recs


def _read(cell, records, iterations, monkeypatch):
    monkeypatch.setattr(spans, "program_records", lambda: records)
    return common.Cell(cell).reader("graph_replays_per_iter.walk")(
        {"iterations": iterations})


@pytest.mark.parametrize("cell", WALKS)
def test_replays_per_iteration(cell, monkeypatch):
    # an untraced replay (set-up) is not counted
    recs = [(REPLAY, -1, 0.0, 0.001, 0, False)]
    for i in range(4):
        recs += _iteration(1.0 + i, len(recs), 3)
    assert _read(cell, recs, 4, monkeypatch) == pytest.approx(3.0)
    # one iteration of four ran eagerly
    recs = []
    for i, n in enumerate((3, 0, 3, 3)):
        recs += _iteration(1.0 + i, len(recs), n)
    assert _read(cell, recs, 4, monkeypatch) == pytest.approx(2.25)


@pytest.mark.parametrize("cell", WALKS)
def test_nothing_read_without_replays(cell, monkeypatch):
    assert _read(cell, None, 4, monkeypatch) is None
    recs = []
    for i in range(2):
        recs += _iteration(1.0 + i, len(recs), 0)
    assert _read(cell, recs, 2, monkeypatch) is None
