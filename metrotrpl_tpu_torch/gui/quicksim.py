"""Quicksim: re-simulate decay curves from posterior states.

Port of ``metrotrpl_tpu/gui/quicksim.py`` (reference GUI/quicksim.py
equivalent): simulations run in a background ``multiprocessing.Process``
streaming results through a Queue so the tk mainloop stays responsive
(reference :90-133); the solver is the port's batched SDIRK forward model
instead of scipy. When multiple tasks are queued they are solved as ONE
batch: on the card, one launch of the solve kernel's instantiation for
the model and dtype (float64 by default) with B = number of tasks.

The solve runs on the device the caller names: the card by default, the
CPU (the kernel's plain PyTorch version) only when asked. A child that
cannot reach the card reports the error to the poller; it never solves on
the CPU instead.
"""

import multiprocessing as mp
from typing import NamedTuple

import numpy as np
import torch

from metrotrpl_tpu_torch import resolve_device


class QuicksimTask(NamedTuple):
    """One re-simulation request (the reference's 'ext var' set,
    GUI/quicksim_entry_popup.py): thickness [nm], nx, final_time [ns], nt,
    fluence [cm^-2], absp [cm^-1], direction (+-1), plus the parameter
    state dict in [cm, V, s] units and the measurement type."""
    thickness: float
    nx: int
    final_time: float
    nt: int
    fluence: float
    absp: float
    direction: float
    params: dict
    meas: str = "TRPL"
    model: str = "std"


#: Default entry-unit -> internal-unit conversions (the staub vocabulary);
#: pass the loaded ensemble's per-run table via ``units`` when available.
DEFAULT_UNITS = {"n0": 1e-21, "p0": 1e-21, "mu_n": 1e5, "mu_p": 1e5,
                 "ks": 1e12, "Cn": 1e33, "Cp": 1e33, "Sf": 1e-2, "Sb": 1e-2}

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def run_tasks(tasks, scale_factors=None, dtype="float64", units=None,
              device="cuda"):
    """Solve all tasks as one batch on ``device``; returns list of (t, sol)
    numpy arrays.

    units : optional {param: conversion} from the run's config
    (ensemble_fields['units']); defaults to the staub table."""
    from metrotrpl_tpu_torch.physics.models import beer_lambert
    from metrotrpl_tpu_torch.solver.forward import (
        make_forward_plan,
        solve_forward_batch,
    )

    device = resolve_device(device)
    uc = DEFAULT_UNITS if units is None else units
    if not tasks:
        return []
    if len({t.nx for t in tasks}) != 1:
        raise NotImplementedError("quicksim batch needs a common nx")
    tdtype = _DTYPES[dtype]

    times = [np.linspace(0, t.final_time, t.nt) for t in tasks]
    plan = make_forward_plan(
        [t.thickness for t in tasks], [t.nx for t in tasks],
        [t.meas for t in tasks], times, model=tasks[0].model)

    def dev(a, dt=tdtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    x = dev(plan.x_centers)
    fl = dev([[t.fluence * 1e-14] for t in tasks])
    ab = dev([[t.absp * 1e-7] for t in tasks])
    dr = dev([[t.direction] for t in tasks])
    init = beer_lambert(fl, ab, x, dr)

    keys = set()
    for t in tasks:
        keys |= set(t.params)
    raw = {k: dev([t.params.get(k, 0.0) * uc.get(k, 1) for t in tasks])
           for k in keys}

    sol = solve_forward_batch(
        init, raw, dev(plan.dx), dev(plan.dt),
        dev(plan.out_idx, torch.int64), dev(plan.is_trpl, torch.bool),
        model=tasks[0].model, scheme=plan.scheme,
        newton_iters=plan.newton_iters,
        out_w=None if plan.out_w is None else dev(plan.out_w),
        refactor_every=plan.refactor_every, n_ramp=plan.n_ramp,
        ramp_block=plan.ramp_block, newton_plateau=plan.newton_plateau)
    sol = sol.cpu().numpy()
    out = []
    for m, t in enumerate(tasks):
        s = sol[m, :t.nt].copy()
        if scale_factors is not None and scale_factors[m] is not None:
            s = s * scale_factors[m]
        out.append((times[m], s))
    return out


def _worker(tasks, scale_factors, queue, units=None, device="cuda"):
    # a spawn child: it imports the port, and on the card loads (or
    # builds) the kernel library itself
    try:
        results = run_tasks(tasks, scale_factors, units=units,
                            device=device)
        for i, (t, s) in enumerate(results):
            queue.put((i, t, s, "ok"))
    except Exception as err:  # surface errors to the GUI poller
        queue.put((-1, None, None, f"error: {err}"))
    queue.put(None)  # sentinel


class QuicksimManager:
    """Background-process runner polled by the GUI (reference
    GUI/quicksim.py:16-100 contract: spawn, poll queue, join).

    device : where the child solves ("cuda", the default, or "cpu");
        asking for the card where there is none raises here."""

    def __init__(self, device="cuda"):
        self.device = str(resolve_device(device))
        self.proc = None
        self.queue = None

    def simulate(self, tasks, scale_factors=None, units=None):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.proc = ctx.Process(
            target=_worker,
            args=(tasks, scale_factors, self.queue, units, self.device))
        self.proc.start()

    def poll(self):
        """Non-blocking drain; returns (results, done)."""
        results = []
        done = False
        while self.queue is not None and not self.queue.empty():
            item = self.queue.get_nowait()
            if item is None:
                done = True
            else:
                results.append(item)
        return results, done

    def join(self, timeout=None):
        if self.proc is not None:
            self.proc.join(timeout)
            self.proc = None
