"""Native TOML config format.

The reference's 4-section text format (bayes_io.py:543-966) is fully
supported by :mod:`metrotrpl_tpu_torch.config.script_io`; this module adds a
modern, self-describing TOML alternative mapping onto the SAME parsed
dicts and passing through the SAME validation and derived-parameter
pipeline (``finalize_config``), so the two formats are interchangeable
everywhere a config path is accepted (``cli mcmc`` dispatches on the
``.toml`` extension).

Schema:

    # mu_constraint = [20.0, 3.0]   # optional ambipolar-mobility
    #                               # constraint [center, width]; must
    #                               # appear BEFORE the first [table]

    [grid]
    lengths = [311.0, 2000.0]        # nm, one per measurement
    nx = [128, 128]
    meas_types = ["TRPL", "TRPL"]

    [params.p0]                      # parameter order = table order
    unit_conversion = 1e-21
    do_log = true
    active = true
    guess = 3e15
    prior = [1e14, 1e16]
    trial_move = 0.003

    [measurement]
    time_cutoff = [0, 2000]          # 'inf' allowed (TOML float)
    # select_obs_sets = [0, 2]       # optional; omitted = all

    [mcmc]                           # keys = MCMC_fields vocabulary
    init_cond_path = "..."
    measurement_path = "..."
    output_path = "..."
    num_iters = 1000
    solver = ["sdirk"]               # or ["solveivp"] / ["NN", path, sc]
    hmax = 48.0
    model = "std"
    model_uncertainty = 1.0          # or { TRPL = 1.0, TRTS = 0.1 }
    log_y = true
    hard_bounds = true
    checkpoint_freq = 1000
    # parallel_tempering = [1.0, 2.0, 4.0]
    # scale_factor = { trial_move = 0.1, inds = [0, 1],
    #                  groups = [[0, 1]], guesses = [1.0, 1.0] }

Booleans map to the reference's 0/1 ints; fittable specs
(``scale_factor`` / ``fittable_fluences`` / ``fittable_absps``) are
inline tables with optional ``groups``/``guesses`` (defaults match the
text parser: no groups -> independent factors, no guesses -> 1.0).
"""

import os
import tomllib

import numpy as np

from metrotrpl_tpu_torch.config.script_io import finalize_config

_BOOL_KEYS = ("log_y", "hard_bounds", "force_min_y")
_FITTABLE_KEYS = ("scale_factor", "fittable_fluences", "fittable_absps")


def _fittable_from_table(tbl):
    """{trial_move, inds, groups?, guesses?} -> the text parser's
    [trial_move, inds, c_grps, guesses] contract."""
    if tbl is None:
        return None
    inds = np.asarray(tbl["inds"], dtype=int)
    grps = tbl.get("groups")
    if grps is not None:
        grps = [tuple(int(i) for i in g) for g in grps]
    guesses = tbl.get("guesses")  # None when omitted: finalize_config
    # fills the per-measurement default [1]*num_meas
    if guesses is not None:
        guesses = list(guesses)
    return [float(tbl["trial_move"]), inds, grps, guesses]


def read_config_toml(path):
    """Read a native TOML config; returns the same
    (grid, param_info, meas_flags, MCMC_fields) as
    ``read_config_script_file``, via the same finalize pipeline."""
    return finalize_config(*parse_config_toml(path))


def parse_config_toml(path):
    """Parse a native TOML config WITHOUT the finalize pipeline (raw
    pre-validation dicts, the writers' input contract)."""
    with open(path, "rb") as f:
        doc = tomllib.load(f)

    g = doc["grid"]
    grid = {
        "lengths": [float(x) for x in g["lengths"]],
        "nx": [int(x) for x in g["nx"]],
        "meas_types": list(g["meas_types"]),
        "num_meas": len(g["lengths"]),
    }

    params = doc["params"]
    names = list(params)  # tomllib preserves document order
    param_info = {
        "names": names,
        "unit_conversions": {n: float(params[n].get("unit_conversion", 1))
                             for n in names},
        "do_log": {n: int(bool(params[n].get("do_log", True)))
                   for n in names},
        "active": {n: int(bool(params[n].get("active", True)))
                   for n in names},
        "init_guess": {n: float(params[n]["guess"]) for n in names},
        "prior_dist": {n: tuple(float(b) for b in
                                params[n].get("prior", (-np.inf, np.inf)))
                       for n in names},
        "trial_move": {n: float(params[n].get("trial_move", 0.0))
                       for n in names},
    }
    mu = doc.get("mu_constraint")
    if mu is not None:
        param_info["do_mu_constraint"] = [float(x) for x in mu]

    m = doc.get("measurement", {})
    meas_flags = {
        "time_cutoff": [float(x) for x in m.get("time_cutoff",
                                                (0.0, np.inf))],
        "select_obs_sets": (None if m.get("select_obs_sets") is None
                            else [int(i) for i in m["select_obs_sets"]]),
    }

    mc = dict(doc["mcmc"])
    if "solver" in mc:
        mc["solver"] = tuple(mc["solver"])
    for k in _BOOL_KEYS:
        if k in mc:
            mc[k] = int(bool(mc[k]))
    for k in _FITTABLE_KEYS:
        if k in mc:
            mc[k] = _fittable_from_table(mc[k])
    if "irf_convolution" in mc and mc["irf_convolution"] is not None:
        mc["irf_convolution"] = [float(x) for x in mc["irf_convolution"]]
    for k in ("init_cond_path", "measurement_path", "output_path"):
        if k in mc:
            mc[k] = os.path.join(mc[k])
    # per-meastype dict form comes through TOML tables directly
    MCMC_fields = mc

    return grid, param_info, meas_flags, MCMC_fields


def _toml_scalar(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        x = float(v)
        if np.isinf(x):
            return "inf" if x > 0 else "-inf"
        return repr(x)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    raise TypeError(f"unsupported TOML scalar: {v!r}")


def _toml_value(v):
    if isinstance(v, dict):
        items = ", ".join(f"{k} = {_toml_value(x)}" for k, x in v.items()
                          if x is not None)
        return "{ " + items + " }"
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return _toml_scalar(v)


def write_config_toml(path, grid, param_info, meas_flags, MCMC_fields):
    """Write the native TOML format from the standard config dicts
    (accepts either pre- or post-``finalize_config`` dicts; synthetic
    ``_s*/_f*/_a*`` params are skipped — they are re-derived on read)."""
    lines = ["# metrotrpl_tpu native config (read_config_toml)", ""]
    # Top-level keys must precede the first [table] or tomllib folds them
    # into that table.
    if param_info.get("do_mu_constraint") is not None:
        lines += [f"mu_constraint = "
                  f"{_toml_value(list(param_info['do_mu_constraint']))}", ""]
    lines += ["[grid]",
              f"lengths = {_toml_value([float(x) for x in grid['lengths']])}",
              f"nx = {_toml_value([int(x) for x in grid['nx']])}",
              f"meas_types = {_toml_value(list(grid['meas_types']))}", ""]

    for n in param_info["names"]:
        if n.startswith(("_s", "_f", "_a")):
            continue  # synthetic, re-derived from the fittable specs
        lines += [f"[params.{n}]"]
        uc = param_info.get("unit_conversions", {}).get(n, 1)
        if uc != 1:
            lines.append(f"unit_conversion = {_toml_scalar(float(uc))}")
        lines += [
            f"do_log = {_toml_scalar(bool(param_info['do_log'][n]))}",
            f"active = {_toml_scalar(bool(param_info['active'][n]))}",
            f"guess = {_toml_scalar(float(param_info['init_guess'][n]))}",
            f"prior = {_toml_value(param_info['prior_dist'][n])}",
            f"trial_move = "
            f"{_toml_scalar(float(param_info['trial_move'].get(n, 0.0)))}",
            ""]

    lines += ["[measurement]",
              f"time_cutoff = {_toml_value(meas_flags['time_cutoff'])}"]
    sel = meas_flags.get("select_obs_sets")
    if sel is not None:
        lines.append(f"select_obs_sets = "
                     f"{_toml_value([int(i) for i in sel])}")
    lines.append("")

    lines.append("[mcmc]")
    for k, v in MCMC_fields.items():
        if k.startswith("_") or v is None:
            continue
        if k == "solver":
            v = list(v)
        elif k in _BOOL_KEYS:
            v = bool(v)
        elif k in _FITTABLE_KEYS:
            v = {"trial_move": float(v[0]),
                 "inds": [int(i) for i in v[1]],
                 "groups": (None if v[2] is None
                            else [list(map(int, gg)) for gg in v[2]]),
                 "guesses": (None if v[3] is None
                             else [float(x) for x in v[3]])}
        lines.append(f"{k} = {_toml_value(v)}")
    lines.append("")

    with open(path, "w") as f:
        f.write("\n".join(lines))
