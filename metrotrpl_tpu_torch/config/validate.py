"""Config validation.

Same contracts as the reference validators (reference bayes_validate.py) but
written as compact rule tables. Raises on invalid configs with actionable
messages.
"""

import numpy as np

SUPPORTED_MEAS_TYPES = ("TRPL", "TRTS", "pa")
SUPPORTED_SOLVERS = ("odeint", "solveivp", "sdirk", "NN", "diagnostic")
SUPPORTED_MODELS = ("std", "traps", "pa")
SUPPORTED_INI_MODES = ("density", "fluence")

_PROHIBITED_PATH_CHARS = ("<", ">", "*", "?", ":", '"', "|")


def check_valid_filename(file_name):
    """Screen file_name for prohibited characters (slashes allowed)."""
    return not any(c in file_name for c in _PROHIBITED_PATH_CHARS)


def _is_num(x):
    return isinstance(x, (int, float, np.integer, np.floating))


def _is_int(x):
    return isinstance(x, (int, np.integer))


def check_fittable_fluence(spec, num_measurements=None):
    """Validate a fittable_fluences / fittable_absps / scale_factor spec:
    None or [move_size, inds, c_grps(|None), guesses(|None)?].

    When ``num_measurements`` is given, the fittable indices are also
    range-checked — an out-of-range index would otherwise be silently
    dropped by remap_fittable_inds, disabling the fit with no error."""
    if spec is None:
        return True
    if not isinstance(spec, (list, tuple)) or not 3 <= len(spec) <= 4:
        return False
    if not _is_num(spec[0]):
        return False
    if not isinstance(spec[1], (list, tuple, np.ndarray)) or len(spec[1]) == 0:
        return False
    if any(not _is_int(i) or i < 0 for i in spec[1]):
        return False
    if num_measurements is not None and any(
            i >= num_measurements for i in spec[1]):
        return False
    if spec[2] is not None:
        if not isinstance(spec[2], (list, tuple)):
            return False
        for grp in spec[2]:
            if not isinstance(grp, (list, tuple)):
                return False
            if any(not _is_int(c) or c < 0 for c in grp):
                return False
    if len(spec) == 4 and spec[3] is not None:
        if not isinstance(spec[3], (list, tuple, np.ndarray)) or len(spec[3]) == 0:
            return False
        if any(not _is_num(g) or g < 0 for g in spec[3]):
            return False
    return True


def validate_grid(grid, supported_meas_types=SUPPORTED_MEAS_TYPES):
    if not isinstance(grid, dict):
        raise TypeError("MCMC simPar must be type 'dict'")
    for k in ("lengths", "nx", "meas_types", "num_meas"):
        if k not in grid:
            raise ValueError(f"MCMC simPar missing entry '{k}'")
    n = grid["num_meas"]
    if not (_is_int(n) and n > 0):
        raise ValueError("Invalid number of measurements")
    if not (
        isinstance(grid["lengths"], (list, np.ndarray))
        and len(grid["lengths"]) == n
        and all(x > 0 for x in grid["lengths"])
    ):
        raise ValueError(
            "MCMC simPar entry 'Length' must be a list with one positive "
            "length value per measurement"
        )
    if not (
        isinstance(grid["nx"], (list, np.ndarray))
        and len(grid["nx"]) == n
        and all(x > 0 for x in grid["nx"])
    ):
        raise ValueError(
            "MCMC simPar entry 'nx' must be a list with one positive integer "
            "number of nodes per measurement"
        )
    if not (
        isinstance(grid["meas_types"], (list, np.ndarray))
        and len(grid["meas_types"]) == n
        and all(m in supported_meas_types for m in grid["meas_types"])
    ):
        raise ValueError(
            "MCMC simPar entry 'meas_types' must be a list with one supported "
            f"type per measurement. Supported types are {supported_meas_types}"
        )


def validate_param_info(param_info):
    if not isinstance(param_info, dict):
        raise TypeError("MCMC param_info must be type 'dict'")
    required = (
        "names", "active", "unit_conversions", "do_log",
        "init_guess", "trial_move", "prior_dist",
    )
    for k in required:
        if k not in param_info:
            raise ValueError(f"MCMC param_info missing entry '{k}'")

    names = param_info["names"]
    if not (isinstance(names, list) and len(names) > 0):
        raise ValueError("Invalid number of param names in param_info")
    if len(names) != len(set(names)):
        raise ValueError("Duplicate param names not allowed")
    for k in names:
        if not k.replace("_", "").isalnum():
            raise ValueError(f"Param name {k} is invalid - must be alphanumeric")
        if k.startswith("_"):
            raise ValueError(
                f"Param name {k} is invalid - names must not start with _, "
                "which is reserved for synthetic scale/fluence params"
            )

    for k, v in param_info["unit_conversions"].items():
        if not _is_num(v):
            raise ValueError(f"Invalid unit conversion {v} for param {k}")

    if "do_mu_constraint" in param_info:
        mu = param_info["do_mu_constraint"]
        if not (isinstance(mu, (list, tuple, np.ndarray)) and len(mu) == 2):
            raise ValueError(
                "mu_constraint must be a list with center and width values, "
                "e.g. [100, 10] to restrict ambipolar mu between 90 and 110."
            )

    for k in names:
        for table in ("do_log", "active", "init_guess", "prior_dist", "trial_move"):
            if k not in param_info[table]:
                raise KeyError(f"{table} missing param {k}")
        if param_info["do_log"][k] not in (0, 1):
            raise ValueError(f"do_log param {k} invalid - must be 0 or 1")
        if param_info["active"][k] not in (0, 1):
            raise ValueError(f"param_info's 'active' param {k} invalid - must be 0 or 1")
        if not _is_num(param_info["init_guess"][k]):
            raise ValueError(f"init_guess param {k} invalid")
        pd = param_info["prior_dist"][k]
        if not isinstance(pd, (tuple, list)):
            raise ValueError(f"prior_dist param {k} must be tuple or list")
        if len(pd) != 2:
            raise ValueError(f"prior_dist param {k} must be length 2")
        if not (_is_num(pd[0]) and _is_num(pd[1])):
            raise ValueError(f"prior_dist param {k} must contain two numeric bounds")
        if not pd[0] < pd[1]:
            raise ValueError(
                f"prior_dist param {k} lower bound must be smaller than upper bound"
            )
        tm = param_info["trial_move"][k]
        if not (_is_num(tm) and tm >= 0):
            raise ValueError(f"trial_move param {k} invalid - must be non-negative")


def validate_meas_flags(meas_flags, num_measurements):
    if not isinstance(meas_flags, dict):
        raise TypeError("MCMC meas_flags must be type 'dict'")
    for k in ("time_cutoff", "select_obs_sets"):
        if k not in meas_flags:
            raise ValueError(f"MCMC meas_flags missing entry '{k}'")
    tc = meas_flags["time_cutoff"]
    if not (isinstance(tc, (list, np.ndarray)) and len(tc) == 2):
        raise ValueError(
            "meas_flags time_cutoff must be a list with 2 cutoff values, "
            "e.g. [0, np.inf] to allow all non-negative times."
        )
    if not (_is_num(tc[0]) and _is_num(tc[1])):
        raise ValueError("Invalid time_cutoff bound")
    if tc[1] < tc[0]:
        raise ValueError("time_cutoff upper bound smaller than lower bound")
    select = meas_flags["select_obs_sets"]
    if select is not None:
        if not isinstance(select, (list, np.ndarray)):
            raise TypeError("select_obs_sets must be None or a list type")
        if not all(0 <= x < num_measurements for x in select):
            raise ValueError(
                "Invalid select value - must be ints between 0 and num_measurements - 1"
            )


def validate_MCMC_fields(
    MCMC_fields, num_measurements, supported_solvers=SUPPORTED_SOLVERS
):
    if not isinstance(MCMC_fields, dict):
        raise TypeError("MCMC control flags must be type 'dict'")
    required = (
        "init_cond_path", "measurement_path", "output_path", "num_iters",
        "solver", "model", "ini_mode", "log_y", "checkpoint_freq",
    )
    for k in required:
        if k not in MCMC_fields:
            raise ValueError(f"MCMC control flags missing entry '{k}'")
    if "likel2move_ratio" not in MCMC_fields and "model_uncertainty" not in MCMC_fields:
        raise ValueError(
            "Either likel2move_ratio or model_uncertainty must be defined "
            "under MCMC_fields"
        )
    for pkey in ("init_cond_path", "measurement_path", "output_path"):
        if not isinstance(MCMC_fields[pkey], str):
            raise ValueError(f"{pkey} must be a valid path")
    if not check_valid_filename(MCMC_fields["output_path"]):
        raise ValueError("Invalid char in output_path")
    if not (_is_int(MCMC_fields["num_iters"]) and MCMC_fields["num_iters"] > 0):
        raise ValueError("Invalid number of iterations")
    if "starting_iter" in MCMC_fields:
        si = MCMC_fields["starting_iter"]
        if not (_is_int(si) and si >= 0):
            raise ValueError("Invalid starting iteration")
    if not (
        isinstance(MCMC_fields["model"], str)
        and MCMC_fields["model"] in SUPPORTED_MODELS
    ):
        raise ValueError(
            f"MCMC control 'model' must be one of {list(SUPPORTED_MODELS)}"
        )
    if (not isinstance(MCMC_fields["solver"], tuple)
            or len(MCMC_fields["solver"]) == 0):
        raise ValueError(
            "MCMC control 'solver' must be a tuple with at least one element "
            f"- one solver name from {supported_solvers}"
        )
    if MCMC_fields["solver"][0] not in supported_solvers:
        raise ValueError(
            "MCMC control 'solver' must be a supported solver. "
            f"Supported solvers are {supported_solvers}"
        )
    if MCMC_fields["ini_mode"] not in SUPPORTED_INI_MODES:
        raise ValueError(
            "MCMC control 'ini_mode' must be a supported initial condition "
            "mode: density or fluence"
        )
    for tolkey in ("rtol", "atol", "hmax", "newton_div_tol"):
        if tolkey in MCMC_fields:
            v = MCMC_fields[tolkey]
            # hmax 0 is the odeint "no step limit" sentinel and is legal;
            # rtol/atol must be strictly positive
            ok = (_is_num(v) and (v > 0 or (tolkey == "hmax" and v == 0)))
            if not ok:
                raise ValueError(f"{tolkey} must be a positive value"
                                 + (" (or 0 for no step limit)"
                                    if tolkey == "hmax" else ""))
    if "newton_div_tol" in MCMC_fields:
        # the trust-region damping caps reported Newton residuals at
        # solver.sdirk.NEWTON_DAMP, so a tolerance at/above the cap can
        # never flag a diverged solve — it would silently disable the
        # dynamic failure predicate (ADVICE r4 #3)
        from metrotrpl_tpu_torch.solver.sdirk import NEWTON_DAMP
        if NEWTON_DAMP is not None and \
                MCMC_fields["newton_div_tol"] >= NEWTON_DAMP:
            raise ValueError(
                "newton_div_tol must be below the Newton damping cap "
                f"{NEWTON_DAMP} (damped residuals never exceed the cap, "
                "so a threshold at or above it can never flag a diverged "
                "solve)")
    for ckey in ("refactor_every", "ramp_block", "newton_plateau"):
        if ckey in MCMC_fields:
            v = MCMC_fields[ckey]
            if not (isinstance(v, (int, np.integer)) and v >= 1):
                raise ValueError(f"{ckey} must be an integer >= 1")
    for skey in ("likel2move_ratio", "model_uncertainty"):
        if skey in MCMC_fields:
            v = MCMC_fields[skey]
            if _is_num(v):
                if v < 0:
                    raise ValueError(f"{skey} must be non-negative value")
            elif isinstance(v, dict):
                for mt, val in v.items():
                    if not (isinstance(mt, str) and _is_num(val) and val >= 0):
                        raise ValueError(
                            f"{mt}: {skey} must have one non-negative value "
                            "per measurement type"
                        )
            else:
                raise ValueError(f"Invalid {skey}")
    if MCMC_fields["log_y"] not in (0, 1):
        raise ValueError("log_y invalid - must be 0 or 1")
    for fkey in ("scale_factor", "fittable_fluences", "fittable_absps"):
        if fkey in MCMC_fields and not check_fittable_fluence(
                MCMC_fields[fkey], num_measurements):
            raise ValueError(
                f"Invalid {fkey} - must be None, or a "
                "[move_size, indices, constraint_groups, guesses] spec"
            )
    for bkey in ("hard_bounds", "force_min_y"):
        if bkey in MCMC_fields and MCMC_fields[bkey] not in (0, 1):
            raise ValueError(f"{bkey} invalid - must be 0 or 1")
    if "irf_convolution" in MCMC_fields:
        irf = MCMC_fields["irf_convolution"]
        if irf is not None:
            if not (
                isinstance(irf, (list, np.ndarray))
                and len(irf) == num_measurements
                and all(x >= 0 for x in irf)
            ):
                raise ValueError(
                    "MCMC control 'irf_convolution' must be None, or a list "
                    "with one positive wavelength value per measurement"
                )
    if "parallel_tempering" in MCMC_fields:
        pt = MCMC_fields["parallel_tempering"]
        if not (
            isinstance(pt, (list, np.ndarray))
            and len(pt) > 0
            and all(x > 0 for x in pt)
        ):
            raise ValueError(
                "MCMC control 'parallel_tempering' must be a list with at "
                "least one positive temperature value"
            )
    if "temper_freq" in MCMC_fields:
        tf = MCMC_fields["temper_freq"]
        if not (_is_int(tf) and tf > 0):
            raise ValueError("temper_freq must be positive integer")
    cf = MCMC_fields["checkpoint_freq"]
    if not (_is_int(cf) and cf > 0):
        raise ValueError("checkpoint_freq must be positive integer")
    if "load_checkpoint" in MCMC_fields:
        lc = MCMC_fields["load_checkpoint"]
        if lc is not None and not isinstance(lc, str):
            raise ValueError("Invalid name of checkpoint to load")
