"""What the per-layer readers (portbench/metrics/) share: the solve
kernel's device time by precision, from the kernel names of the trace,
and the yardstick's least time of the rows the program counted."""

from portbench.harness import yardstick

#: the scalar size of each precision of the kernel
SIZE = {"float32": 4, "float64": 8}
#: the models whose operations the frozen count covers
COUNTED = ("std",)


def is_solve_kernel(name, precision):
    """Whether a trace's kernel name is the solve kernel in ``precision``
    (the kernel's template arguments name its scalar type)."""
    if "sdirk" not in name:
        return False
    return ("double" in name) == (precision == "float64")


def solve_seconds(ctx, precision):
    tr = ctx["trace"]
    if tr is None:
        return 0.0
    return tr.kernel_seconds(lambda n: is_solve_kernel(n, precision))


def rows(ctx, precision):
    """Rows the configuration's model solved in ``precision`` over the
    traced window (the program's ROWS counter), or None where the program
    keeps no such counter."""
    hit = ctx["counters"].get((ctx["model"], precision))
    return None if hit is None else hit[1]


def least_seconds(ctx, precision):
    """The yardstick's least time of the rows the kernel solved in this
    precision over the traced window, or None where the frozen count
    does not cover the model or no rows were counted."""
    n = rows(ctx, precision)
    if ctx["model"] not in COUNTED or n is None:
        return None
    plan = ctx["fast_plan"] if precision == "float32" else ctx["rung_plan"]
    return yardstick.least_seconds(plan, SIZE[precision], n)


def roofline(ctx, precision):
    """Share (%) of the kernel's device time that the yardstick's least
    time is, or None where the kernel did not run or is not counted."""
    t = solve_seconds(ctx, precision)
    least = least_seconds(ctx, precision)
    if t <= 0 or not least:
        return None
    return 100.0 * least / t


def per_eval(ctx, value):
    n = ctx["evaluations"]
    return None if not n else value / n
