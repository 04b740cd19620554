"""gather_ms_per_swap: device ms of the NCCL kernels launched inside the
program's ``metrotrpl.mesh.gather`` spans (each swap round's all-gather
over the chains group) per swap round of the traced windows, the mean
over the ranks. NCCL's kernel waits inside for the slowest rank of its
group, so this holds the straggle. Nothing is read where the program has
no such span or no NCCL kernel ran inside it."""

#: the program's span around each swap round's all-gather
GATHER = "metrotrpl.mesh.gather"


def read(ctx):
    ranks = ctx.get("ranks") or []
    per = [r["nccl_s"].get(GATHER, 0.0) / r["swap_rounds"] for r in ranks
           if r["swap_rounds"]]
    if not per or not sum(per):
        return None
    return 1e3 * sum(per) / len(per)
