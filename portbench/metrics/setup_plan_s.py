"""setup_plan_s: host seconds of the set-up spent building the
likelihood's plan and its evaluator's device tensors (the program's
build spans that ended before the first traced span began)."""

from portbench.harness import spans


def read(ctx):
    recs = spans.program_records()
    if recs is None:
        return None
    return spans.setup_s(recs, spans.BUILD)
