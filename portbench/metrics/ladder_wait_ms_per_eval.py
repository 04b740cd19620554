"""ladder_wait_ms_per_eval: host milliseconds inside the ladder's sync
(the program's span around the escalation ladder's ``nonzero`` of the
rows to repair and its test), per evaluation of the likelihood: the host
blocked on the fast solve and all that precedes it."""

from portbench.harness import spans


def read(ctx):
    recs = spans.program_records()
    if recs is None:
        return None
    return spans.per(spans.host_s(recs, spans.LADDER_SYNC),
                     ctx["evaluations"], 1e3)
