"""Native runtime components (C++ via ctypes).

Copy of ``metrotrpl_tpu/runtime`` without its RHS timing loop: a
single-pass numeric-CSV parser for measurement / initial-condition / IRF
data files (``fastcsv.cpp``) and the compiled reference std RHS
(``refrhs.cpp``) behind the LSODA oracle's ``rhs="native"`` path. (numpy >= 2.0 ships a C tokenizer in
np.loadtxt, so the native parser is at parity with it, not faster.)

These are host code for the CPU, not device kernels. Each shared library
is compiled on first use with g++ into ``_build/`` beside this file
(listed in ``.gitignore``), named by a hash of its source, so an edited
source rebuilds and a fresh checkout builds from its own sources. Every
entry point falls back to the numpy implementation if the toolchain or
binary is unavailable, so the package never hard-depends on the native
build; :func:`native_available` says which path runs.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastcsv.cpp")
_RHS_SRC = os.path.join(_DIR, "refrhs.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_RHS_LIB = None
_RHS_TRIED = False


def _compile(src, stem):
    """Compile a C++ source to a content-addressed .so in BUILD_DIR;
    returns the path or None."""
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    so_path = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)   # atomic: a concurrent build loads a whole file
        return so_path
    except (OSError, subprocess.SubprocessError):
        return None


def _get_lib():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so_path = _compile(_SRC, "fastcsv")
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
            lib.parse_csv.restype = ctypes.c_int
            lib.parse_csv.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long),
            ]
            lib.free_buffer.restype = None
            lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_double)]
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def native_available():
    """Whether the native CSV parser built and loaded."""
    return _get_lib() is not None


_RHS_ARGT = ([ctypes.c_int] + [ctypes.c_double] * 14
             + [np.ctypeslib.ndpointer(np.float64)] * 2)


def _get_rhs_lib():
    global _RHS_LIB, _RHS_TRIED
    with _LOCK:
        if _RHS_TRIED:
            return _RHS_LIB
        _RHS_TRIED = True
        so_path = _compile(_RHS_SRC, "refrhs")
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
            lib.dydt_std.restype = None
            lib.dydt_std.argtypes = _RHS_ARGT
            _RHS_LIB = lib
        except OSError:
            _RHS_LIB = None
        return _RHS_LIB


def native_rhs_available():
    """Whether the compiled reference RHS built and loaded."""
    return _get_rhs_lib() is not None


def _rhs_param_list(params, dx):
    """(reference argument order, forward_solver.py:332) from a model-unit
    param dict."""
    from metrotrpl_tpu_torch.constants import eps0, q_C
    lam = q_C / (params["eps"] * eps0)
    return [float(dx), params["n0"], params["p0"], params["mu_n"],
            params["mu_p"], params["ks"], params["Cn"], params["Cp"],
            params["Sf"], params["Sb"], params["tauN"], params["tauP"],
            lam, params["Tm"]]


def _rhs_state(y, L):
    """y as a contiguous float64 [N, P, E] state of L cells."""
    y = np.ascontiguousarray(y, dtype=np.float64)
    if y.shape != (3 * int(L) + 1,):
        raise ValueError(f"state of shape {y.shape}, expected "
                         f"({3 * int(L) + 1},) for L={L}")
    return y


def dydt_std_native(y, L, dx, params):
    """Compiled reference RHS on a flat [N, P, E] state (model units).
    Returns dy or None if the native build is unavailable."""
    lib = _get_rhs_lib()
    if lib is None:
        return None
    y = _rhs_state(y, L)
    dy = np.zeros_like(y)
    lib.dydt_std(int(L), *_rhs_param_list(params, dx), y, dy)
    return dy


def make_native_rhs_std(nx, dx, params):
    """Build a minimal-overhead ``fun(t, y) -> dy`` closure over the
    compiled reference RHS for scipy's LSODA, or None if the native build
    is unavailable.

    The ctypes argument list is constructed once; per call the only
    Python work is one contiguity check and one small copy (LSODA may
    hold the returned array across calls, so the scratch buffer cannot
    be returned directly).
    """
    lib = _get_rhs_lib()
    if lib is None:
        return None
    args = _rhs_param_list(params, dx)
    dy = np.empty(3 * nx + 1, dtype=np.float64)
    fn = lib.dydt_std
    L = int(nx)

    def fun(t, y):
        fn(L, *args, _rhs_state(y, L), dy)
        return dy.copy()

    return fun


def load_csv(path, delimiter=","):
    """Load a numeric CSV into a float64 array (rows, cols), or 1-D for a
    single row or column.

    Uses the native parser when available; falls back to np.loadtxt.
    """
    lib = _get_lib()
    if lib is not None and delimiter in (",", None):
        data_ptr = ctypes.POINTER(ctypes.c_double)()
        rows = ctypes.c_long()
        cols = ctypes.c_long()
        rc = lib.parse_csv(os.fsencode(path), ctypes.byref(data_ptr),
                           ctypes.byref(rows), ctypes.byref(cols))
        if rc == 0:
            n = rows.value * cols.value
            arr = np.ctypeslib.as_array(data_ptr, shape=(n,)).copy()
            lib.free_buffer(data_ptr)
            out = arr.reshape(rows.value, cols.value)
            return out[0] if rows.value == 1 else out if cols.value > 1 \
                else out[:, 0]
        # fall through to numpy on parse errors (mixed content etc.)
    return np.loadtxt(path, delimiter=delimiter)
