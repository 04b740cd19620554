"""fast_roofline: the float32 solve kernel's share (%) of its roofline:
the yardstick's least time for the rows it solved on the fast plan (the
program's ROWS counter) over its device time in the trace."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "float32")
