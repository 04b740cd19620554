"""loop_host_ms_per_iter: host milliseconds of the walk's iterations
outside the evaluation of the likelihood (the self time of the program's
iteration span: draws, trial move, accept, swap round, History), per
iteration."""

from portbench.harness import spans


def read(ctx):
    recs = spans.program_records()
    if recs is None:
        return None
    return spans.per(spans.self_s(recs, spans.ITERATION),
                     ctx["iterations"], 1e3)
