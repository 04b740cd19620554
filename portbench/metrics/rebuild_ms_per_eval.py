"""rebuild_ms_per_eval: host milliseconds the traced calls spent building
the likelihood's plan and its evaluator's device tensors (the program's
build spans), per evaluation (a chunk of the dense sampler)."""

from portbench.harness import spans


def read(ctx):
    recs = spans.program_records()
    if recs is None:
        return None
    return spans.per(spans.host_s(recs, spans.BUILD), ctx["evaluations"],
                     1e3)
