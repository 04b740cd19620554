"""scripts/posterior_torch.py's walk: a short leg on the CPU through the
script's run_leg, its report, and the card as the script's default."""

import os
import sys

import numpy as np
import pytest
from torch_parity import REPO

SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import posterior_torch as pt  # noqa: E402


def test_short_leg_and_report_on_the_cpu(tmp_path, monkeypatch):
    """A 2-chain x 20-iteration fast leg of the traps workload (cut to
    nx=8 and 100 ns for the CPU's plain path) runs through the script's
    walk; its states stay finite and in the priors; the report holds
    one row per active parameter; the card is the default device."""
    import torch

    w = pt.traps_workload()._replace(nx=8, t_end=100.0, nt=11)
    t, vals = pt.make_dataset(w)
    r = pt.run_leg(w, t, vals, "fast", 20, 2, device="cpu",
                   log=lambda line: None)
    assert r["samples"]["kC"].shape == (20, 2)
    assert np.isfinite(r["states"]).all() and np.isfinite(r["ll"]).all()
    assert 0.0 < r["acceptance"] <= 1.0
    lo = np.array([w.prior[n][0] for n in w.names])
    hi = np.array([w.prior[n][1] for n in w.names])
    assert np.all((r["states"] > lo) & (r["states"] < hi))
    gold = pt.read_committed_gold(os.path.join(REPO, w.artifact))
    lines, worst = pt.model_section(w, {"fast": r}, gold, "the CPU")
    rows = [ln for ln in lines if ln.startswith("| ") and "10^(" in ln]
    assert len(rows) == 13 and set(worst) == {"fast"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pt.main(["--out", str(tmp_path / "x.md")])
    assert not (tmp_path / "x.md").exists()
