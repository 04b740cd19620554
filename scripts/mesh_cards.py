"""The sharded flagship walk with a card of its own for every rank
(NCCL), held to the fused walk: chip_smoke.py's phase 20 at 2x2 and 1x4
on a host with at least four cards.

    python3 scripts/mesh_cards.py       # from the repository root

Builds the kernel library, writes the flagship config's oracle data into
chip_smoke_out/mesh_cards/, then walks metro(n_ensembles=2) on cuda:0
and metro(mesh_shape=...) with rank r on cuda:r, 50 iterations and a
resume to 100, bit for bit against the fused walk (chip_smoke's
phase20_mesh: its checks, launches and walker-steps/s lines). Exits
non-zero with fewer than four cards.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main():
    import torch

    from metrotrpl_tpu_torch.cli import write_example_config
    from metrotrpl_tpu_torch.solver import solve_kernel as sk
    from metrotrpl_tpu_torch.solver.kernel_times import nvidia_smi_line

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        sys.exit("mesh_cards: needs four CUDA devices")
    card = nvidia_smi_line()
    print(f"card: {card} x {torch.cuda.device_count()}")
    lib = sk.kernel_library()
    print(f"kernel library {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
    work = REPO / "chip_smoke_out" / "mesh_cards"
    work.mkdir(parents=True, exist_ok=True)
    fluences = REPO / "Inputs" / "staub_MAPI_threepower_twothick_fluences.csv"
    write_example_config(str(work / "flagship.txt"), model="std", fast=True,
                         num_iters=chip_smoke.N_ITERS_MESH,
                         init_cond=str(fluences),
                         measurement=str(work / "staub_nonoise.csv"),
                         output=str(work / "run"), checkpoint_freq=50)
    launches = chip_smoke.phase20_mesh(card, work, fluences,
                                       layouts=((2, 2, False),
                                                (1, 4, False)))
    print(json.dumps({label: {f"{m}_{str(d)[6:]}": n
                              for (m, d), n in ln.items()}
                      for label, ln in launches.items()}))


if __name__ == "__main__":
    main()
