"""mfu: the whole step's share (%) of the card's peak: the yardstick's
least time for every solve of the traced window (float32 rows at the
float32 non-tensor peak, float64 rung rows at the float64 one) over the
window's length."""

from portbench.harness import readers


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0:
        return None
    least = [readers.least_seconds(ctx, p) for p in ("float32", "float64")]
    least = [t for t in least if t is not None]
    if not least or not sum(least):
        return None
    return 100.0 * sum(least) / tr.window_s
