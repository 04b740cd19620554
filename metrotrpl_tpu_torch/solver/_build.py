"""Build and load the CUDA solve kernel (``csrc/*.cu``) at first use.

``nvcc`` compiles the sources into a shared library with a plain C
interface, loaded with ``ctypes``; nothing of PyTorch's C++ API is
included, so the build takes seconds. The library lands in ``_build/``
beside this file (listed in ``.gitignore``), named by a hash of the
sources and flags, so an edited source rebuilds and a fresh checkout
builds from its own sources. A failed build raises.

No fast-math flags: the solver's failure predicates work near the
float32 ``tiny`` and need IEEE denormals and divisions. ``-fmad=false``
keeps every product and sum rounded on its own, as the plain PyTorch
version rounds them: the float32 chord solve at nx=128 amplifies any
rounding difference, and only without contraction (and with each edge
current computed once, csrc/sdirk_solve.cu) did the float32 kernel flag
the same rows as the plain version on the card (PERF.md). The double
instantiations fuse their block algebra's multiply-adds explicitly
(``fma`` in ``madd``, csrc/sdirk_solve.cuh), which the flag leaves as
written.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
#: the library's entry points, one per model and scalar type
SOLVE_ENTRY_POINTS = tuple(f"metrotrpl_sdirk_solve_{m}_{d}"
                           for m in ("std", "traps") for d in ("f32", "f64"))
#: argtypes of every entry point: (dt, y0, par, dx, pl, tr, rs, B, nx,
#: n_steps, n_stages, A, gamma, newton_iters, n_phase1, ramp_block,
#: refactor, ni_plateau, stream)
SOLVE_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _D, _I,
                  _I, _I, _I, _I, _P]
#: the occupancy query of each entry point's variant: (nx, &blocks per
#: SM, &threads, &dynamic shared memory bytes)
OCCUPANCY_ENTRY_POINTS = tuple(n.replace("_solve_", "_occupancy_")
                               for n in SOLVE_ENTRY_POINTS)
_IP = ctypes.POINTER(ctypes.c_int)
OCCUPANCY_ARGTYPES = [_I, _IP, _IP, _IP]


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    cands = []
    if CUDA_HOME:
        cands.append(Path(CUDA_HOME) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (CUDA_HOME / /usr/local/cuda); the "
                       "CUDA solve kernel cannot be built")


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded solve-kernel library plus how it was obtained."""

    def __init__(self, path, build_seconds, ptxas_log):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from cache
        self.ptxas_log = ptxas_log
        self.lib = ctypes.CDLL(str(path))
        for names, argtypes in ((SOLVE_ENTRY_POINTS, SOLVE_ARGTYPES),
                                (OCCUPANCY_ENTRY_POINTS, OCCUPANCY_ARGTYPES)):
            for name in names:
                fn = getattr(self.lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int


def build_library():
    """Compile (if needed) and load the kernel library; raise on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _source_hash()
    out = BUILD_DIR / f"libsdirk_solve_{tag}.so"
    log = BUILD_DIR / f"libsdirk_solve_{tag}.ptxas.txt"
    if out.is_file():
        return KernelLibrary(out, 0.0,
                             log.read_text() if log.is_file() else "")
    sources = [str(f) for f in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build loads a whole file
    log.write_text(proc.stdout + proc.stderr)
    return KernelLibrary(out, seconds, proc.stdout + proc.stderr)
