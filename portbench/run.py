#!/usr/bin/env python3
"""The benchmark of metrotrpl_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <config>.<mix> --seed <n>
                             --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json from the root of a checkout: builds the
program under test from the cell's configuration (configs/) and traffic
mix (traffic/), warms it up (set-up, timed as ``setup_s``), measures it
for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or
traces a few of its windows (``--trace 1``: its per-layer metrics, each
read by metrics/<name>.py), then checks what the timed path produced
against the plain reference (reference/). The last line of standard
output is one JSON object: correct, attempted, failed, metrics, device,
with ``--trace 1`` a breakdown, and last the numbers compared beside
their limits (also the last lines of standard error). Exits non-zero,
printing no result, without the cards the cell asks for.
"""

import argparse
import importlib
import json
import sys
from pathlib import Path
from time import perf_counter

T_START = perf_counter()
BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))

from portbench.harness import common  # noqa: E402

#: top-level modules that must not be loaded: the JAX stack and the JAX
#: package the port was made from (names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "metrotrpl_tpu")


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.pin_cache_dirs()
    cell = common.Cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        common.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                   f"found {found}")
        return 3
    mode = importlib.import_module(
        f"portbench.harness.{cell.traffic['mode']}")
    out = mode.run(cell, args, T_START)
    common.log(f"run done at {perf_counter() - T_START:.3f} s")

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(out.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    bad = forbidden_loaded()
    if bad:
        common.log(f"modules that must not load were loaded: {bad}")
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out.memory_peak}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if args.trace:
        tr = out.ctx["trace"]
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps[:10]]}
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, v, lim in out.compared}
    for k, v, lim in out.compared:
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
