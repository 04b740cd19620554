"""history_ms_per_window: device ms of the NCCL kernels launched inside
the program's ``metrotrpl.mesh.history`` spans (each window's History
rows gathered over the chains group) per traced window, the mean over
the ranks. Nothing is read where the program has no such span or no
NCCL kernel ran inside it."""

#: the program's span around each window's History gather
HISTORY = "metrotrpl.mesh.history"


def read(ctx):
    ranks = ctx.get("ranks") or []
    per = [r["nccl_s"].get(HISTORY, 0.0) / r["windows"] for r in ranks
           if r["windows"]]
    if not per or not sum(per):
        return None
    return 1e3 * sum(per) / len(per)
