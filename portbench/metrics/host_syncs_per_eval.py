"""host_syncs_per_eval: the times the host waited for the device (every
synchronising CUDA call PyTorch made, which the program counts against
its innermost open span while a profiler runs) inside the traced spans,
per evaluation of the likelihood (an iteration of the walk, a chunk of
the dense sampler)."""

from portbench.harness import spans


def read(ctx):
    recs = spans.program_records()
    if recs is None:
        return None
    return spans.per(spans.syncs(recs), ctx["evaluations"])
