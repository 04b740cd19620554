"""The reduction of a profiler trace and the per-layer readers, on a
trace made by hand."""

import json

import pytest

from portbench.harness import common, readers, yardstick
from portbench.harness.trace import reduce_trace
from portbench.reference import likelihood as rl

SPAN = "portbench.irf_stage"
F32 = ("void sdirk::sdirk_cell_kernel<float, 3>(float const*, float "
       "const*, float const*, float const*, float*, float*, float*, int, "
       "int, int, int, sdirk::Scheme<float>, sdirk::Plan)")
F64 = ("void sdirk::sdirk_solve_kernel<double, 3, 1>(double const*, double "
       "const*, double const*, double const*, double*, double*, double*, "
       "int, int, int, int, sdirk::Scheme<double>, sdirk::Plan)")


def _trace(path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": SPAN, "ts": 100,
         "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 112, "dur": 2, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 200, "dur": 2, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 205, "dur": 2, "tid": 1, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 120, "dur": 30,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": F32, "ts": 210, "dur": 1000,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": F64, "ts": 1300, "dur": 2000,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1250,
         "dur": 10, "args": {}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 150,
         "dur": 3200, "tid": 1},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return reduce_trace(path, 4000e-6)


def test_reduce_trace(tmp_path):
    t = _trace(tmp_path / "t.json")
    assert t.busy_s == pytest.approx((30 + 1000 + 2000 + 10) * 1e-6)
    assert t.span_device_s[SPAN] == pytest.approx(30e-6)
    assert [n for n, _ in t.top_ops(2)] == [F64, F32]
    # the longest gap (1210 -> 1250) lies under the host's aten::item
    assert t.idle_gaps[0][0] == "aten::item"


def test_readers_on_a_hand_made_trace(tmp_path):
    cell = common.Cell("staub-flagship.walk-e8")
    setup = rl.load_setup(common.Cell("staub-real-irf.walk-e8").config_path)
    ctx = {"trace": _trace(tmp_path / "t.json"),
           "counters": {("std", "float32"): (1, 384),
                        ("std", "float64"): (1, 24)},
           "iterations": 2, "evaluations": 2, "samples": 0,
           "fast_plan": setup.fast, "rung_plan": setup.rung,
           "irf_span": SPAN, "model": "std"}
    assert readers.is_solve_kernel(F32, "float32")
    assert readers.is_solve_kernel(F64, "float64")
    assert not readers.is_solve_kernel(F32, "float64")
    least32 = yardstick.least_seconds(setup.fast, 4, 384)
    assert readers.roofline(ctx, "float32") == pytest.approx(
        100 * least32 / 1000e-6)
    values = {m["name"]: cell.reader(m["name"])(ctx)
              for m in cell.per_layer}
    assert values["launches_per_iter.walk"] == 1.5
    assert values["rung_rows_per_eval.walk"] == 12
    assert values["device_idle.walk"] == pytest.approx(
        100 * (1 - 3040 / 4000))
    assert 0 < values["mfu.walk"] < 100
    assert 0 < values["rung_roofline.walk"] < 100
    # a cell whose trace has no IRF stage reads nothing for it
    irf = common.Cell("staub-real-irf.walk-e8").reader("irf_ms_per_iter.walk")
    assert irf(ctx) == pytest.approx(1e3 * 30e-6 / 2)
    ctx["trace"].span_device_s = {}
    assert irf(ctx) is None
    # a model the frozen count does not cover, or whose counters the
    # program does not keep, reads nothing rather than 0
    for model in ("traps", "nn"):
        ctx["model"] = model
        for name in ("fast_roofline.walk", "rung_roofline.walk", "mfu.walk",
                     "rung_rows_per_eval.walk"):
            assert cell.reader(name)(ctx) is None, (model, name)


def test_every_host_range_is_attributed(tmp_path):
    """A range the program opens is read by its name, with no list of
    names in the harness."""
    path = tmp_path / "t.json"
    _trace(path)
    ev = json.loads(path.read_text())["traceEvents"]
    ev.append({"ph": "X", "cat": "user_annotation", "name": "prog.eval",
               "ts": 190, "dur": 20, "tid": 1})
    path.write_text(json.dumps({"traceEvents": ev}))
    t = reduce_trace(path, 4000e-6)
    assert t.span_device_s[SPAN] == pytest.approx(30e-6)
    # the launches at 200 and 205 (the f32 and f64 kernels)
    assert t.span_device_s["prog.eval"] == pytest.approx(3000e-6)


def test_metric_variants_share_their_reader():
    cell = common.Cell("staub-flagship.walk-e8")
    dense = common.Cell("staub-flagship.dense-512")
    assert cell.reader("mfu.walk").__doc__ == dense.reader(
        "mfu.dense").__doc__
