"""irf_ms_per_iter: device milliseconds, per iteration of the walk, of
the kernels launched inside the program's IRF stage (the harness's host
range around the stage, attributed by the launches' correlation ids)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["iterations"]:
        return None
    s = tr.span_device_s.get(ctx["irf_span"])
    if not s:
        return None
    return 1e3 * s / ctx["iterations"]
