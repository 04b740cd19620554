"""rung_rows_per_eval: rows the ladder solved again on the float64 rung
(the program's ROWS counter of the configuration's model's float64
kernel) per evaluation of the likelihood (an iteration of the walk, a
chunk of the dense sampler)."""

from portbench.harness import readers


def read(ctx):
    rows = readers.rows(ctx, "float64")
    return None if rows is None else readers.per_eval(ctx, rows)
