"""rung_rows_imbalance: the rows the float64 rung solved on the rank
that solved the most (the program's ROWS counter of the configuration's
model's float64 kernel, over the traced windows) over the ranks' mean;
1.0 is even. A swap round waits for the rank with the most rung waves.
Nothing is read without ranks or without rung rows."""


def read(ctx):
    rows = [r["counters"].get((ctx["model"], "float64"))
            for r in ctx.get("ranks") or []]
    rows = [hit[1] for hit in rows if hit is not None]
    if not rows or not sum(rows):
        return None
    return max(rows) * len(rows) / sum(rows)
