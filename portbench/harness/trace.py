"""The traced run: torch.profiler over a few measured windows, reduced to
what the per-layer readers take.

The profiler's Chrome trace is parsed directly: device events
(``kernel``, ``gpu_memcpy``, ``gpu_memset``) give the busy time (the
union of their intervals) and each kernel's name and duration; every
host range opened with ``record_function`` (the harness's own or the
program's) gives, by its name and through the correlation ids of the
launches made inside it, the device time of the kernels it launched.
"""

import bisect
import json
import os
from time import perf_counter
from collections import defaultdict

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class TraceSummary:
    """What one traced window holds.

    kernels : list of (name, seconds) of every kernel
    busy_s : seconds in which some device operation ran
    window_s : the traced window's length on the host clock
    span_device_s : host range name -> device seconds of the kernels
        launched inside it
    idle_gaps : the longest stretches without a device operation, as
        (what the host was doing meanwhile, seconds)
    """

    def __init__(self, kernels, busy_s, window_s, span_device_s, idle_gaps):
        self.kernels = kernels
        self.busy_s = busy_s
        self.window_s = window_s
        self.span_device_s = span_device_s
        self.idle_gaps = idle_gaps

    def kernel_seconds(self, match):
        """Total seconds of the kernels whose name satisfies ``match``."""
        return sum(d for n, d in self.kernels if match(n))

    def top_ops(self, n=10):
        tot = defaultdict(float)
        for name, d in self.kernels:
            tot[name] += d
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def _union(intervals):
    total, end = 0.0, None
    out = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            out.append([a, b])
            end = b
        elif b > end:
            out[-1][1] = b
            end = b
    for a, b in out:
        total += b - a
    return total, out


def reduce_trace(path, window_s):
    """The TraceSummary of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, launches, ranges, host = [], {}, defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        args = e.get("args", {})
        if cat in _DEVICE_CATS:
            dev.append((e["name"], ts, ts + dur, cat, args.get("correlation")))
        elif cat == "cuda_runtime" and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat == "user_annotation":
            ranges[e["name"]].append((e.get("tid"), ts, ts + dur))
        elif cat == "cpu_op":
            host.append((ts, ts + dur, e["name"]))
    kernels = [(n, (b - a) * 1e-6) for n, a, b, c, _ in dev if c == "kernel"]
    busy_us, merged = _union([(a, b) for _, a, b, _, _ in dev])
    span_s = {}
    for name, rs in ranges.items():
        by_tid = defaultdict(list)
        for tid, a, b in rs:
            by_tid[tid].append((a, b))
        for v in by_tid.values():
            v.sort()
        starts = {tid: [a for a, _ in v] for tid, v in by_tid.items()}
        s = 0.0
        for n, a, b, c, corr in dev:
            hit = launches.get(corr)
            if hit is None or hit[0] not in by_tid:
                continue
            tid, t = hit
            k = bisect.bisect_right(starts[tid], t) - 1
            if k >= 0 and t <= by_tid[tid][k][1]:
                s += (b - a) * 1e-6
        span_s[name] = s
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    host_starts = [h[0] for h in host]
    idle = []
    for a, b in gaps[:10]:
        # the longest host op under way at the gap's middle
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(host_starts, mid)
        what = [h for h in host[max(0, k - 2000):k] if h[1] >= mid]
        what.sort(key=lambda h: h[0] - h[1])
        idle.append((what[0][2] if what else "host (no op)",
                     (b - a) * 1e-6))
    return TraceSummary(kernels, busy_us * 1e-6, window_s, span_s, idle)


def traced(fn, out_path):
    """Run fn() under the profiler (host and device), write its trace to
    out_path, and return (fn's result, the trace's summary). fn returns
    (work done, window seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    t0 = perf_counter()
    prof.export_chrome_trace(str(out_path))
    summary = reduce_trace(out_path, result[1])
    from portbench.harness.common import log
    log(f"trace written and read in {perf_counter() - t0:.3f} s "
        f"({os.path.getsize(out_path) / 1e6:.1f} MB)")
    return result, summary
