"""rung_roofline: the float64 solve kernel's (the ladder's rung) share
(%) of its roofline: the yardstick's least time for the rows it solved
on the rung plan (the program's ROWS counter) over its device time in the
trace."""

from portbench.harness import readers


def read(ctx):
    return readers.roofline(ctx, "float64")
