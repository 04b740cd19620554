"""launches_per_iter: device kernels the traced windows ran (the
profiler's kernel events) per iteration of the walk."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["iterations"]:
        return None
    return len(tr.kernels) / ctx["iterations"]
