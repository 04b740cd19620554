"""The control on the card, at each cell's own size: the reference with
its float64 rung computed in float32, put in the program's place at the
states and proposals a short window of the cell recorded, must come out
not correct on every seed, while the program's own readings pass
(readings.py; about a minute a seed). Run on the card:
``python -m pytest portbench/tests/test_portbench_control.py -q``."""

import json

import pytest

from portbench.harness import common

CELLS = ["staub-flagship.walk-e8", "staub-flagship.dense-512",
         "staub-real-irf.walk-e8"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload, tmp_path, capsys):
    from portbench import readings

    readings.main(["--workload", workload, "--seeds",
                   "2400000001,2400000002,2400000003", "--seconds", "5",
                   "--out", str(tmp_path)])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    cell = common.Cell(workload)
    mode = cell.traffic["mode"]
    lim = cell.config["limits"][mode]
    assert len(recs) == 3
    for r in recs:
        assert r["ll_off_share"] <= lim["ll_off_share"]
        assert r["ctl_ll_off_share"] > lim["ll_off_share"]
        if mode == "walk":
            assert r["moves_wrong"] == 0
            assert r["accepts_missed"] <= lim["accepts_missed"]
            assert r["ctl_accepts_missed"] > lim["accepts_missed"]
            assert r["swaps_wrong"] <= lim["swaps_wrong"]
