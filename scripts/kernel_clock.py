#!/usr/bin/env python3
"""Cycle counts of the solve kernel's float designs, phase by phase, from
an instrumented copy of the kernel's source that the library never ships.

    python3 scripts/kernel_clock.py [--out FILE.json]   # from the repo root

Copies metrotrpl_tpu_torch/solver/csrc into
metrotrpl_tpu_torch/solver/_build/clock/, adds clock64() stamps around
each Newton iteration's RHS, PCR apply and damping max, each
factorization and its PCR levels, each step's stage sweep and each knot's
observables, and a switch that launches the thread-per-row design (Sim)
where the launch would pick the thread-per-cell one (CellSim); builds it
with the library's nvcc flags and prints ptxas' registers and spills.
Then, on the float32 batches of kernel_times.make_inputs (the flagship
fast plan at B=48, nx=128, and the posterior fast legs at nx=32), it runs
each design and prints, from block 0's thread 0: cycles per Newton
iteration in the RHS (its exchange included), the apply and the max;
cycles per factorization and in its levels; cycles per step in the stage
sweep and in the knot's sums; and the call's CUDA-event ms. The stamps
cost registers and change the code's schedule, so the ms here are not
the kernel's (kernel_times.py times the library): read this script for
the split of one block's cycles between the phases of the two designs.
``--out`` also writes the numbers to a JSON file.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: stamp slots: per Newton iteration, per factorization, per step
SLOTS = ["rhs", "apply", "max", "n_newton", "factor", "n_factor", "stages",
         "emit", "levels"]


def instrument(src):
    """The kernel source with the stamps, the design switch and two C
    entry points (clock_read, clock_rows) added."""
    def sub(old, new, count):
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"instrumenting: {old!r} found "
                               f"{src.count(old)} times, not {count}")
        src = src.replace(old, new)

    n = len(SLOTS)
    sub("namespace sdirk {\n",
        "namespace sdirk {\n__device__ long long g_clock[16];\n"
        "int h_rows;\n", 1)
    for old, k in (("rhs(Y, f);", 0), ("apply(G, d);", 1)):
        extra = " prof[3] += 1;" if k == 1 else ""
        sub(f"        {old}\n", f"        {{ long long t_ = clock64(); {old} "
            f"prof[{k}] += clock64() - t_;{extra} }}\n", 2)
    sub("        const S dmax = block_max(m);\n",
        "        long long tm_ = clock64();\n"
        "        const S dmax = block_max(m);\n"
        "        prof[2] += clock64() - tm_;\n", 2)
    for first in ("true", "false"):
        call = f"level<{first}>(lev, s, L, D, U);"
        sub(f"        {call}\n", f"        {{ long long t_ = clock64(); "
            f"{call} prof[8] += clock64() - t_; }}\n", 2)
    sub("      sim.factor(y, h * sc.gamma);\n",
        "      { long long t_ = clock64(); sim.factor(y, h * sc.gamma); "
        "sim.prof[4] += clock64() - t_; sim.prof[5] += 1; }\n", 2)
    sub("        const S r = sim.stages(y, h, sc, ni);\n"
        "        emit(k + 1, r);\n",
        "        long long t_ = clock64();\n"
        "        const S r = sim.stages(y, h, sc, ni);\n"
        "        long long t2_ = clock64();\n"
        "        emit(k + 1, r);\n"
        "        sim.prof[6] += t2_ - t_; sim.prof[7] += clock64() - t2_;\n",
        2)
    sub("        sim.prof[6] += t2_ - t_; sim.prof[7] += clock64() - t2_;\n"
        "      }\n    }\n  }\n}\n",
        "        sim.prof[6] += t2_ - t_; sim.prof[7] += clock64() - t2_;\n"
        "      }\n    }\n  }\n  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
        f"    for (int k = 0; k < {n}; ++k) g_clock[k] = sim.prof[k];\n}}\n",
        2)
    sub("    xpar = red_par = 0;\n",
        f"    xpar = red_par = 0;\n    for (int k = 0; k < {n}; ++k) "
        "prof[k] = 0;\n", 1)
    sub("    red_par = 0;\n  }\n",
        f"    red_par = 0;\n    for (int k = 0; k < {n}; ++k) prof[k] = 0;\n"
        "  }\n", 1)
    sub("  S Dv[NC][NC];", f"  long long prof[{n}];\n  S Dv[NC][NC];", 1)
    sub("  S fa[CPT][LFAC][NC];",
        f"  long long prof[{n}];\n  S fa[CPT][LFAC][NC];", 1)
    sub("  if (sizeof(S) != 4 || nx > 128) return row_shape<S, NC>(nx);",
        "  if (sizeof(S) != 4 || nx > 128 || h_rows) "
        "return row_shape<S, NC>(nx);", 1)
    sub("  if constexpr (sizeof(S) == 4) {\n    if (v.cell) return "
        "sdirk_cell_kernel<S, NC>;\n",
        "  if constexpr (sizeof(S) == 4) {\n    if (v.cell) return "
        "sdirk_cell_kernel<S, NC>;\n    if (v.cpt == 1) return "
        "sdirk_solve_kernel<S, NC, 1>;\n", 1)
    return src + (
        '\nextern "C" int clock_read(long long* o) {\n'
        "  return (int)cudaMemcpyFromSymbol(o, sdirk::g_clock,\n"
        "                                   16 * sizeof(long long));\n}\n"
        'extern "C" void clock_rows(int r) { sdirk::h_rows = r; }\n')


def build():
    """Build the instrumented library; returns (path, ptxas lines)."""
    from metrotrpl_tpu_torch.solver import _build

    d = _build.BUILD_DIR / "clock"
    d.mkdir(parents=True, exist_ok=True)
    (d / "sdirk_solve.cuh").write_text(
        (_build.CSRC / "sdirk_solve.cuh").read_text())
    (d / "sdirk_solve.cu").write_text(
        instrument((_build.CSRC / "sdirk_solve.cu").read_text()))
    lib = d / "libsdirk_clock.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
           str(d / "sdirk_solve.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-5000:]}")
    print(f"nvcc {time.perf_counter() - t0:.1f} s")
    log = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    return lib, log


def main():
    import torch

    from metrotrpl_tpu_torch.physics.models import ScaledParams
    from metrotrpl_tpu_torch.solver import _build
    from metrotrpl_tpu_torch.solver import kernel_times as kt
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the numbers to this JSON file")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_clock: needs a CUDA device")
    card = kt.nvidia_smi_line()
    print(f"card: {card}")
    path, log = build()
    for line in log:
        print(f"  ptxas: {line[-100:]}")
    clib = ctypes.CDLL(str(path))
    clib.clock_read.argtypes = [ctypes.c_void_p]
    clib.clock_rows.argtypes = [ctypes.c_int]
    sk._LIB = _build.KernelLibrary(path, 0.0, "\n".join(log))
    dev = torch.device("cuda")
    inputs = kt.make_inputs(_build.BUILD_DIR / "clock" / "work")
    out = {"card": card}
    for model in ("std", "traps"):
        for tag in ("f32", "f32_nx32"):
            p, y0, dts, dx, kw = inputs[(model, tag)]
            B = 48 if tag == "f32" else y0.shape[0]
            args = (ScaledParams(*(a[:B].to(dev) for a in p)),
                    y0[:B].to(dev), dts[:, :B].to(dev), dx[:B].to(dev))
            for rows, design in ((0, "cell"), (1, "rows")):
                clib.clock_rows(rows)
                ms = kt.cuda_ms(
                    lambda: sk.integrate_observables_cuda(*args, **kw), 10)
                buf = (ctypes.c_longlong * 16)()
                torch.cuda.synchronize()
                if clib.clock_read(ctypes.addressof(buf)) != 0:
                    raise RuntimeError("kernel_clock: reading the stamps "
                                       "failed")
                v = dict(zip(SLOTS, buf[:len(SLOTS)]))
                nn, nf, ns = v["n_newton"], v["n_factor"], dts.shape[0]
                rec = {"ms": ms, "B": B, "nx": int(y0.shape[-1]),
                       "rhs_cycles": v["rhs"] / nn,
                       "apply_cycles": v["apply"] / nn,
                       "max_cycles": v["max"] / nn,
                       "factor_cycles": v["factor"] / nf,
                       "levels_cycles": v["levels"] / nf,
                       "stages_cycles_per_step": v["stages"] / ns,
                       "sums_cycles_per_step": v["emit"] / ns,
                       "newton_iterations": nn, "factorizations": nf}
                label = f"{model}_{tag}_B{B}_{design}"
                out[label] = rec
                print(label, json.dumps({k: round(x, 1) if isinstance(
                    x, float) else x for k, x in rec.items()}), flush=True)
    if a.out:
        Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
