"""The port's quicksim (metrotrpl_tpu_torch/gui/quicksim.py): its traps
solve against the JAX package's at float64 (the std case is in
tests/test_torch_gui.py), its background manager on the CPU, and the card
as the default device with no fallback to the CPU."""

import queue
import time

import numpy as np
import pytest
import torch
from torch_parity import assert_run_tasks_equal_jax, quicksim_tasks

from metrotrpl_tpu.workloads import STAUB_TRUE
from metrotrpl_tpu_torch.gui import quicksim as tqs
from tests import tkstub

STAUB = dict(STAUB_TRUE)


@pytest.mark.parametrize("model", ["traps"])
def test_run_tasks_equals_jax_run_tasks(model):
    """run_tasks(device="cpu") at float64 and nx=16 against the JAX
    package's (torch_parity.assert_run_tasks_equal_jax)."""
    assert_run_tasks_equal_jax(model)


def test_quicksim_manager_background_process_on_the_cpu():
    """A spawned child solves on the CPU when asked and streams one result
    per task, equal to run_tasks in this process."""
    tasks = [tqs.QuicksimTask(thickness=311, nx=16, final_time=50, nt=6,
                              fluence=2.12e11, absp=6e4, direction=1,
                              params=STAUB)]
    qs = tqs.QuicksimManager(device="cpu")
    qs.simulate(tasks)
    results, done = [], False
    deadline = time.time() + 120
    while not done and time.time() < deadline:
        items, done = qs.poll()
        results.extend(items)
        time.sleep(0.2)
    qs.join(10)
    assert done and len(results) == 1
    idx, t, sol, msg = results[0]
    assert msg == "ok" and idx == 0
    np.testing.assert_array_equal(sol, tqs.run_tasks(tasks,
                                                     device="cpu")[0][1])


def test_quicksim_defaults_to_the_card_and_never_falls_back(monkeypatch):
    """run_tasks, QuicksimManager, the Window and gui.main take the card by
    default and raise without one; a child asked for the card it cannot
    see reports the error to the poller and solves nothing."""
    import inspect

    from metrotrpl_tpu_torch.gui import main as gmain
    from metrotrpl_tpu_torch.gui.window import Window

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tqs.run_tasks, tqs._worker, tqs.QuicksimManager, Window):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    task = quicksim_tasks(tqs, "std", 8)[:1]
    with pytest.raises(RuntimeError, match="cuda"):
        tqs.run_tasks(task)
    with pytest.raises(RuntimeError, match="cuda"):
        tqs.QuicksimManager()
    tkstub.install(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        gmain.main([])
    q = queue.Queue()
    tqs._worker(task, None, q, device="cuda")
    first = q.get_nowait()
    assert first[0] == -1 and first[3].startswith("error: ")
    assert "cuda" in first[3]
    assert q.get_nowait() is None and q.empty()
