"""What the mode drivers share: the kernel library, the counters the
program keeps, the traced window, and a run's outcome."""

import os
from time import perf_counter

from portbench.harness import common

#: where the program runs
DEVICE = "cuda"
#: the harness's own host range around the program's IRF stage in a
#: traced run
IRF_SPAN = "portbench.irf_stage"


class Outcome:
    """A cell's run: end-to-end metrics, the readers' context, and the
    verdict with the numbers compared."""

    def __init__(self):
        self.e2e = {}
        self.ctx = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak = 0
        self.compared = []
        self.correct = False


def seconds_since(t0):
    import torch

    torch.cuda.synchronize()
    return perf_counter() - t0


def load_library():
    """Load the program's kernel library, built into the checkout on the
    first run only, and say which (on standard error)."""
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    lib = sk.kernel_library()
    where = os.path.relpath(lib.path, common.REPO_DIR)
    if lib.build_seconds:
        common.log(f"kernel library built by nvcc in "
                   f"{lib.build_seconds:.1f} s: {where}")
    else:
        common.log(f"kernel library loaded from the checkout's cache: "
                   f"{where}")


def open_spans():
    """Wrap the program's IRF stage, as it is built, in a host range of
    the harness's own, so that the trace can attribute its kernels. A
    program without that stage is left as it is."""
    import torch

    from metrotrpl_tpu_torch.inference import likelihood as L

    make = getattr(L, "_make_irf_stage", None)
    if make is None:
        return

    def wrapped(*a, **k):
        stage = make(*a, **k)

        def irf(*x, **y):
            with torch.profiler.record_function(IRF_SPAN):
                return stage(*x, **y)
        return irf

    L._make_irf_stage = wrapped


def counters():
    """The program's kernel counters: {(model, dtype tag): (launches,
    rows)}."""
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    return {(m, str(d).split(".")[-1]): (sk.LAUNCHES[(m, d)],
                                         sk.ROWS[(m, d)])
            for (m, d) in sk.LAUNCHES}


def trace_windows(fn, cell):
    from portbench.harness.trace import traced

    path = common.CACHE_DIR / "trace" / f"{cell.name}.json"
    return traced(fn, path)


def reader_context(cell, c0, c1, summary, iters=0, evals=0, samples=0):
    """What a per-layer reader is given: the trace's summary, the counter
    deltas over the traced window, the work done in it, the
    configuration's model, and the reference's solve plans of the
    configuration."""
    delta = {k: (c1[k][0] - c0[k][0], c1[k][1] - c0[k][1]) for k in c1}
    setup = cell.setup()
    return {"trace": summary, "counters": delta, "iterations": iters,
            "evaluations": evals, "samples": samples, "fast_plan": setup.fast,
            "rung_plan": setup.rung, "irf_span": IRF_SPAN,
            "model": cell.config["MCMC_fields"]["model"]}
