"""irf_span_ms_per_iter: device milliseconds, per iteration of the walk,
of the kernels launched inside the program's own span of its IRF stage
(attributed by the launches' correlation ids)."""

from portbench.harness import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return spans.per(tr.span_device_s.get(spans.IRF), ctx["iterations"],
                     1e3)
