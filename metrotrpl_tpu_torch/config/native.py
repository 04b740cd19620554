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
