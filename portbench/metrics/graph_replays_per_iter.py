"""graph_replays_per_iter: replays of the CUDA graphs that hold a walk
iteration's fixed-shape work (the program's ``metrotrpl.walk.replay``
spans inside the traced windows) per iteration of the walk. Nothing is
read where the program replays no graph."""

from portbench.harness import spans

#: the program's span around each replay
REPLAY = "metrotrpl.walk.replay"


def read(ctx):
    recs = spans.program_records()
    if recs is None:
        return None
    n = sum(1 for r in recs if r[0] == REPLAY and r[5])
    return spans.per(n, ctx["iterations"]) if n else None
