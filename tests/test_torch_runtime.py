"""The port's native runtime (metrotrpl_tpu_torch/runtime) against numpy
and the JAX package's runtime: the C++ CSV parser, the compiled std RHS
and the LSODA oracle's rhs="native" path."""

import os

import numpy as np
import pytest
from torch_parity import REPO, staub_raw

from metrotrpl_tpu import runtime as jrt
from metrotrpl_tpu.oracle import solve_reference as j_solve_reference
from metrotrpl_tpu_torch import runtime as trt
from metrotrpl_tpu_torch.constants import eps0, q_C
from metrotrpl_tpu_torch.oracle import solve_reference
from metrotrpl_tpu_torch.oracle.scipy_reference import (
    beer_lambert,
    dydt_std,
    efield_init,
)

INPUTS = os.path.join(REPO, "Inputs")


def test_native_builds_into_the_port_tree():
    """Both libraries build with g++ into runtime/_build, named by a hash
    of their source."""
    assert trt.native_available() and trt.native_rhs_available()
    built = os.listdir(trt.BUILD_DIR)
    assert any(f.startswith("fastcsv-") and f.endswith(".so") for f in built)
    assert any(f.startswith("refrhs-") and f.endswith(".so") for f in built)


def _csv_cases(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((137, 3)) * 10.0 ** rng.integers(-20, 20,
                                                               (137, 3))
    cases = {"random": arr}
    paths = {}
    for name, a in cases.items():
        paths[name] = str(tmp_path / f"{name}.csv")
        np.savetxt(paths[name], a, delimiter=",")
    for name, text in (("row", "1.5,2.5,3.5\n"), ("col", "1.0\n2.0\n3.0\n"),
                       ("blank", "0,6.828546E+16,2.054048E+15\n\n"
                                 "1.13525404,6.703035E+16,2.016497E+15\n")):
        paths[name] = str(tmp_path / f"{name}.csv")
        with open(paths[name], "w") as f:
            f.write(text)
    for f in sorted(os.listdir(INPUTS)):
        if f.endswith(".csv"):
            paths[f] = os.path.join(INPUTS, f)
    return paths


def test_load_csv_equals_loadtxt_and_jax_runtime(tmp_path):
    """The native parser gives np.loadtxt's array and the JAX runtime's,
    bit for bit (shape and dtype too), on random exponents, a single row,
    a single column, blank lines and every CSV in Inputs/."""
    for name, path in _csv_cases(tmp_path).items():
        mine = trt.load_csv(path)
        ref = np.loadtxt(path, delimiter=",")
        j = jrt.load_csv(path)
        for other in (ref, j):
            assert mine.shape == other.shape and mine.dtype == other.dtype, \
                name
            np.testing.assert_array_equal(mine, other, err_msg=name)


def test_load_csv_falls_back_to_numpy_on_mixed_content(tmp_path):
    """A file the native parser refuses (a header line) goes to
    np.loadtxt, as in the JAX runtime."""
    path = str(tmp_path / "h.csv")
    with open(path, "w") as f:
        f.write("t,y\n1,2\n3,4\n")
    with pytest.raises(ValueError):
        trt.load_csv(path)
    with pytest.raises(ValueError):
        jrt.load_csv(path)


def _flagship_state(nx=32, L=311.0):
    pm = staub_raw()
    dx = L / nx
    x = np.linspace(dx / 2, L - dx / 2, nx)
    ic = beer_lambert(2.12e-3, 6e-3, x)
    N, P = ic + pm["n0"], ic + pm["p0"]
    E = efield_init(N, P, pm["n0"], pm["p0"], pm["eps"], dx)
    return np.concatenate([N, P, E]), pm, dx, ic


def test_native_rhs_equals_numpy_rhs_and_jax_native():
    """The compiled std RHS's dy equals the port's numpy RHS (rel 1e-12
    per block) and the JAX runtime's compiled dy bit for bit, on a
    flagship state and a perturbed one."""
    nx = 32
    y, pm, dx, _ = _flagship_state(nx)
    lam = q_C / (pm["eps"] * eps0)
    rng = np.random.default_rng(3)
    for state in (y, y * (1 + 0.01 * rng.standard_normal(y.shape))):
        ref = dydt_std(0.0, state, nx, dx, pm["n0"], pm["p0"], pm["mu_n"],
                       pm["mu_p"], pm["ks"], pm["Cn"], pm["Cp"], pm["Sf"],
                       pm["Sb"], pm["tauN"], pm["tauP"], lam, pm["Tm"])
        dy = trt.dydt_std_native(state, nx, dx, pm)
        for a, b in zip(np.split(dy, [nx, 2 * nx]),
                        np.split(ref, [nx, 2 * nx])):
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()
        np.testing.assert_array_equal(
            dy, jrt.dydt_std_native(state, nx, dx, pm))
        fun = trt.make_native_rhs_std(nx, dx, pm)
        np.testing.assert_array_equal(fun(0.0, state), dy)
    with pytest.raises(ValueError):
        trt.dydt_std_native(y[:-1], nx, dx, pm)


@pytest.mark.parametrize("rhs", ["numpy", "native"])
def test_oracle_rhs_argument_equals_jax_oracle(rhs):
    """solve_reference(rhs=...) gives the JAX oracle's curve with the same
    argument bit for bit, and the native curve equals the numpy one
    within rel 1e-9; any other rhs raises."""
    nx, L = 32, 311.0
    _, pm, _, ic = _flagship_state(nx, L)
    t = np.linspace(0, 1000, 101)
    mine = solve_reference(ic, L, nx, t, pm, rhs=rhs)
    np.testing.assert_array_equal(
        mine, j_solve_reference(ic, L, nx, t, pm, rhs=rhs))
    ref = solve_reference(ic, L, nx, t, pm)
    assert np.max(np.abs(mine - ref) / np.abs(ref)) <= 1e-9
    with pytest.raises(ValueError, match="rhs"):
        solve_reference(ic, L, nx, t, pm, rhs="numba")
