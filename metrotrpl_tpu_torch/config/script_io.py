"""MCMC config-script reader/writer.

File-format compatible with the reference's custom text format
(reference bayes_io.py:259-541 reader, :543-966 writer):

* header line containing ``$$ MCMC CONFIG CREATED``
* four sections opened by ``p$ Space Grid`` / ``p$ Param Info`` /
  ``p$ Measurement handling flags`` / ``p$ MCMC Control flags``
* ``key: value`` lines; tab-separated lists; ``(a, b)|(c, d)`` tuple lists
* ``#`` comment lines.

The reader returns the same four dicts (``grid``, ``param_info``,
``meas_flags``, ``MCMC_fields``) with the same keys so downstream code and
user configs interoperate with the reference.
"""

import datetime
import os

import numpy as np

from metrotrpl_tpu_torch.config.validate import (
    validate_grid,
    validate_MCMC_fields,
    validate_meas_flags,
    validate_param_info,
)

HEADER_TOKEN = "$$ MCMC CONFIG CREATED"

SECTION_TOKENS = {
    "p$ Space Grid": "grid",
    "p$ Param Info": "param",
    "p$ Measurement handling flags": "meas",
    "p$ MCMC Control flags": "mcmc",
}


def _split_key_value(line):
    """Split on the first ':' and strip whitespace from both halves."""
    parts = line.split(":")
    return [p.strip() for p in parts]


def parse_values(text, delimiter="\t", dtype=float):
    """Parse a delimited string into a numpy array of ``dtype``."""
    return np.array(text.split(delimiter), dtype=dtype)


def parse_tuples(text, delimiter="\t", dtype=float):
    """Parse ``(a, b)<delim>(c, d)`` into a list of tuples.

    ``inf`` / ``-inf`` entries are honored; unparseable entries stay strings
    (matches reference bayes_io.py:36-68 semantics).
    """
    out = []
    for chunk in text.split(delimiter):
        vals = []
        for raw in chunk.strip("()").split(", "):
            if raw == "inf":
                vals.append(np.inf)
            elif raw == "-inf":
                vals.append(-np.inf)
            else:
                try:
                    vals.append(dtype(raw))
                except (ValueError, TypeError):
                    vals.append(raw)
        out.append(tuple(vals))
    return out


def _parse_per_meastype(text, grid, cast=float):
    """Parse a scalar-or-'(type, val)|(type, val)' field into a dict keyed by
    measurement type (reference bayes_io.py:380-393)."""
    try:
        v = float(text)
        return {m: cast(v) for m in grid.get("meas_types", [])}
    except ValueError:
        tups = parse_tuples(text, delimiter="|", dtype=float)
        return {t[0]: cast(t[1]) for t in tups}


def _parse_fittable(text):
    """Parse a fittable-fluence/absorption/scale-factor spec:
    ``trial_move \t [inds] \t c_grps|... [\t [guesses]]`` or ``None``
    (reference bayes_io.py:396-472).
    Returns ``[trial_move, inds, c_grps, guesses]`` or ``None``.
    """
    if text == "None":
        return None
    fields = text.split("\t")
    if len(fields) == 3:
        move_size, inds_s, cgrp_s = fields
        guesses = None
    elif len(fields) == 4:
        move_size, inds_s, cgrp_s, guess_s = fields
        guesses = parse_values(guess_s.strip("([])"), delimiter=", ", dtype=float)
    else:
        raise ValueError(f"Invalid fittable spec: {text!r}")
    inds = parse_values(inds_s.strip("([])"), delimiter=", ", dtype=int)
    # guesses stays None when omitted; finalize_config fills the
    # per-MEASUREMENT default [1]*num_meas. (The reference defaults to
    # [1]*len(inds) here, bayes_io.py:403/428/454, then subsets by
    # measurement id — an IndexError whenever len(inds) < num_meas.)
    c_grps = None if cgrp_s == "None" else parse_tuples(cgrp_s, delimiter="|", dtype=int)
    return [float(move_size), inds, c_grps, guesses]


def _put_param_table(param_info, vals, key):
    if "names" not in param_info:
        raise KeyError(
            'Entry "Param names" not found in MCMC config file. It must come '
            "FIRST in the Param Info section."
        )
    param_info[key] = {n: vals[i] for i, n in enumerate(param_info["names"])}


def read_config_script_file(path):
    """Read an MCMC config script.

    Returns (grid, param_info, meas_flags, MCMC_fields) dicts with the same
    key vocabulary as the reference reader (bayes_io.py:259-541), including
    select_obs_sets remapping and synthetic ``_s*/_f*/_a*`` param insertion.
    """
    return finalize_config(*parse_config_script_file(path))


def parse_config_script_file(path):
    """Parse an MCMC config script WITHOUT the finalize pipeline: raw
    as-written dicts, no validation, no select_obs_sets subsetting, no
    synthetic param insertion.  This is what config converters need —
    the writers expect pre-finalize dicts, so parse->write is lossless."""
    grid = {}
    param_info = {}
    meas_flags = {}
    MCMC_fields = {}

    with open(path, "r") as f:
        first = next(f)
        if HEADER_TOKEN not in first:
            raise OSError("Error: this file is not a valid MCMC config file")

        section = None
        for raw in f:
            line = raw.strip("\n")
            if "#" in line or not line.strip():
                continue
            matched_section = False
            for token, sec in SECTION_TOKENS.items():
                if token in line:
                    section = sec
                    matched_section = True
                    break
            if matched_section and section == "grid":
                continue

            kv = _split_key_value(line)
            if len(kv) < 2:
                continue
            key, value = kv[0], kv[1]
            # File paths may contain ':' (drive letters); rejoin remainder.
            if len(kv) > 2:
                value = ":".join(kv[1:])

            if section == "grid":
                if key.startswith("Length(s)"):
                    grid["lengths"] = parse_values(value)
                elif key.startswith("nx"):
                    grid["nx"] = parse_values(value, dtype=int)
                elif key.startswith("Measurement type(s)"):
                    grid["meas_types"] = value.split("\t")
                elif key.startswith("Number of measurements"):
                    grid["num_meas"] = int(value)

            elif section == "param":
                if key.startswith("Param Names"):
                    param_info["names"] = value.split("\t")
                elif key.startswith("Unit conversions"):
                    _put_param_table(param_info, parse_values(value), "unit_conversions")
                elif key.startswith("Do logscale"):
                    _put_param_table(param_info, parse_values(value, dtype=int), "do_log")
                elif key.startswith("Active"):
                    _put_param_table(param_info, parse_values(value, dtype=int), "active")
                elif key.startswith("Initial guess"):
                    _put_param_table(param_info, parse_values(value), "init_guess")
                elif key.startswith("Prior"):
                    _put_param_table(param_info, parse_tuples(value), "prior_dist")
                elif key.startswith("Trial move size"):
                    _put_param_table(param_info, parse_values(value), "trial_move")
                elif key.startswith("Mu constraint"):
                    param_info["do_mu_constraint"] = parse_values(value)

            elif section == "meas":
                if key.startswith("Time cutoffs"):
                    meas_flags["time_cutoff"] = parse_values(value)
                elif key.startswith("Select measurement"):
                    if value == "None":
                        meas_flags["select_obs_sets"] = None
                    else:
                        meas_flags["select_obs_sets"] = list(
                            parse_values(value, dtype=int)
                        )

            elif section == "mcmc":
                if key.startswith("Num iters"):
                    MCMC_fields["num_iters"] = int(value)
                elif key.startswith("Starting iter"):
                    MCMC_fields["starting_iter"] = int(value)
                elif key.startswith("Solver name"):
                    MCMC_fields["solver"] = tuple(value.split("\t"))
                elif key.startswith("Model name"):
                    MCMC_fields["model"] = value
                elif key.startswith("Solver rtol"):
                    MCMC_fields["rtol"] = float(value)
                elif key.startswith("Solver atol"):
                    MCMC_fields["atol"] = float(value)
                elif key.startswith("Solver hmax"):
                    MCMC_fields["hmax"] = float(value)
                elif key.startswith("Solver refactor_every"):
                    MCMC_fields["refactor_every"] = int(value)
                elif key.startswith("Solver ramp_block"):
                    MCMC_fields["ramp_block"] = int(value)
                elif key.startswith("Solver newton_plateau"):
                    MCMC_fields["newton_plateau"] = int(value)
                elif key.startswith("Solver newton_div_tol"):
                    MCMC_fields["newton_div_tol"] = float(value)
                elif key.startswith("Init mode"):
                    MCMC_fields["ini_mode"] = value
                elif key.startswith("Likelihood-to-trial-move"):
                    MCMC_fields["likel2move_ratio"] = _parse_per_meastype(value, grid)
                elif key.startswith("Model uncertainty"):
                    MCMC_fields["model_uncertainty"] = _parse_per_meastype(value, grid)
                elif key.startswith("Use log of measurements"):
                    MCMC_fields["log_y"] = int(value)
                elif key.startswith("Scale factor"):
                    MCMC_fields["scale_factor"] = _parse_fittable(value)
                elif key.startswith("Fittable fluences"):
                    MCMC_fields["fittable_fluences"] = _parse_fittable(value)
                elif key.startswith("Fittable absorptions"):
                    MCMC_fields["fittable_absps"] = _parse_fittable(value)
                elif key.startswith("Use hard boundaries"):
                    MCMC_fields["hard_bounds"] = int(value)
                elif key.startswith("Force min y"):
                    MCMC_fields["force_min_y"] = int(value)
                elif key.startswith("IRF"):
                    MCMC_fields["irf_convolution"] = (
                        None if value == "None" else parse_values(value)
                    )
                elif key.startswith("Parallel tempering"):
                    MCMC_fields["parallel_tempering"] = parse_values(value)
                elif key.startswith("Tempering frequency"):
                    MCMC_fields["temper_freq"] = int(value)
                elif key.startswith("Checkpoint freq"):
                    MCMC_fields["checkpoint_freq"] = int(value)
                elif key.startswith("Load checkpoint"):
                    MCMC_fields["load_checkpoint"] = None if value == "None" else value
                elif key.startswith("Initial condition path"):
                    MCMC_fields["init_cond_path"] = os.path.join(value)
                elif key.startswith("Measurement path"):
                    MCMC_fields["measurement_path"] = os.path.join(value)
                elif key.startswith("Output path"):
                    MCMC_fields["output_path"] = os.path.join(value)

    return grid, param_info, meas_flags, MCMC_fields


def finalize_config(grid, param_info, meas_flags, MCMC_fields):
    """Validate + post-process parsed config dicts (shared by the
    reference text reader and the native TOML reader): select_obs_sets
    remapping, synthetic ``_s*/_f*/_a*`` param insertion, and measurement
    subsetting (reference bayes_io.py:511-529)."""
    # Optional keys that readers may emit as an explicit None (text format
    # writes e.g. "Load checkpoint: None") or omit entirely (TOML has no
    # null): normalize to present-as-None so both formats parse identically.
    for k in ("scale_factor", "fittable_fluences", "fittable_absps",
              "irf_convolution", "load_checkpoint"):
        MCMC_fields.setdefault(k, None)

    validate_grid(grid)
    validate_param_info(param_info)
    validate_meas_flags(meas_flags, grid["num_meas"])
    validate_MCMC_fields(MCMC_fields, grid["num_meas"])

    # Keep fittable indices consistent after subsetting with
    # select_obs_sets (reference bayes_io.py:511-529).
    if meas_flags.get("select_obs_sets", None) is None:
        meas_flags["select_obs_sets"] = np.arange(grid["num_meas"])
    else:
        meas_flags["select_obs_sets"] = np.array(
            meas_flags["select_obs_sets"], dtype=int
        )

    for fi in ("fittable_fluences", "fittable_absps", "scale_factor"):
        spec = MCMC_fields.get(fi, None)
        if spec is not None:
            if spec[3] is None:  # omitted guesses: one per MEASUREMENT
                spec[3] = [1] * grid["num_meas"]
            spec[1] = remap_fittable_inds(spec[1], meas_flags["select_obs_sets"])
            if spec[2] is not None:
                spec[2] = remap_constraint_grps(spec[2], meas_flags["select_obs_sets"])
            spec[3] = list(np.array(spec[3])[meas_flags["select_obs_sets"]])

    insert_param(param_info, MCMC_fields, mode="scale_f")
    insert_param(param_info, MCMC_fields, mode="fluences")
    insert_param(param_info, MCMC_fields, mode="absorptions")

    # Subset simulation info to the selected measurements.  The reference
    # (bayes_io.py:531-539) forgets grid["nx"] here, silently pairing wrong
    # spatial resolutions with the selected measurements when nx is
    # heterogeneous; we subset it like the rest of the grid.
    sel = meas_flags["select_obs_sets"]
    grid["meas_types"] = [grid["meas_types"][i] for i in sel]
    grid["lengths"] = [grid["lengths"][i] for i in sel]
    grid["nx"] = [int(grid["nx"][i]) for i in sel]
    grid["num_meas"] = len(sel)
    if MCMC_fields.get("irf_convolution", None) is not None:
        MCMC_fields["irf_convolution"] = [
            MCMC_fields["irf_convolution"][i] for i in sel
        ]

    return grid, param_info, meas_flags, MCMC_fields


def remap_fittable_inds(fittables, select_obs_sets):
    """Reindex fittable measurement indices after a select_obs_sets subset.

    Ordered intersection: position i of select_obs_sets becomes new index i
    (reference bayes_io.py:206-227).
    """
    return np.array(
        [i for i, s in enumerate(select_obs_sets) if s in list(fittables)], dtype=int
    )


def remap_constraint_grps(c_grps, select_obs_sets):
    """Reindex constraint groups after a select_obs_sets subset, dropping
    singleton groups (reference bayes_io.py:230-256)."""
    sel = list(select_obs_sets)
    new_grps = []
    for grp in c_grps:
        remapped = tuple(sel.index(v) for v in grp if v in sel)
        if len(remapped) > 1:
            new_grps.append(remapped)
    return new_grps


def insert_param(param_info, MCMC_fields, mode="fluences"):
    """Create synthetic log-scale parameters (``_f*``, ``_a*``, ``_s*``) for
    fittable fluences / absorptions / scale factors.

    Only the first member of each constraint group receives a parameter; the
    rest share it (reference bayes_io.py:167-203).
    """
    key, base = {
        "fluences": ("fittable_fluences", "_f"),
        "absorptions": ("fittable_absps", "_a"),
        "scale_f": ("scale_factor", "_s"),
    }[mode]
    spec = MCMC_fields.get(key, None)
    if spec is None:
        return

    move_size, inds, c_grps, guesses = spec
    dependents = []
    if c_grps:
        for grp in c_grps:
            dependents += list(grp)[1:]

    for i in inds:
        if i in dependents:
            continue
        name = f"{base}{i}"
        if name in param_info["names"]:
            # already present (e.g. a config written from an already-read
            # config carries the synthetic params) — don't double-insert
            continue
        param_info["names"].append(name)
        param_info["do_log"][name] = 1
        param_info["prior_dist"][name] = (0, np.inf)
        param_info["init_guess"][name] = guesses[i]
        param_info["trial_move"][name] = move_size
        param_info["active"][name] = 1


def _fmt(v):
    """Format a value for the config format. numpy scalars stringify via
    .item() (numpy 2.x tuple reprs would otherwise emit
    ``(np.float64(1.5), inf)``, which the reader cannot parse back)."""
    if isinstance(v, np.generic):
        return str(v.item())
    if isinstance(v, tuple):
        return "(" + ", ".join(_fmt(x) for x in v) + ")"
    return str(v)


def _write_row(f, label, values, sep="\t"):
    f.write(f"{label}: " + sep.join(_fmt(v) for v in values) + "\n")


def _write_per_meastype(f, label, value):
    if isinstance(value, (int, float, np.integer, np.floating)):
        f.write(f"{label}: {value}\n")
    else:
        f.write(
            f"{label}: " + "|".join(f"({m}, {v})" for m, v in value.items()) + "\n"
        )


def _fmt_list(values):
    """Format a sequence as ``[a, b, c]`` regardless of whether it is a list
    or a numpy array. ``str(ndarray)`` space-separates (``[0 1 2]``), which
    :func:`_parse_fittable` cannot re-read — this keeps write→read→write
    idempotent (the reference shares that bug; we fix it)."""
    return "[" + ", ".join(str(v) for v in np.asarray(values).tolist()) + "]"


def _write_fittable(f, label, spec):
    if spec is None:
        f.write(f"{label}: {spec}\n")
        return
    f.write(f"{label}: {spec[0]}\t{_fmt_list(spec[1])}\t")
    if spec[2] is None:
        f.write(f"{spec[2]}")
    else:
        f.write("|".join(str(tuple(g)) for g in spec[2]))
    if len(spec) == 4 and spec[3] is not None:
        f.write(f"\t{_fmt_list(spec[3])}")
    f.write("\n")


# Deprecated keys the reference's writer warns about or rejects
# (bayes_io.py:649-650, 682-683, 738-739, 791-793, 801-805, 880-935).
_REJECTED_KEYS = {
    "init_variance": "trial_move",
    "likel2variance_ratio": "likel2move_ratio or model_uncertainty",
    "log_pl": "log_y",
}
_IGNORED_KEYS = (
    "one_param_at_a_time",
    "self_normalize",
    "proposal_function",
    "checkpoint_dirname",
    "checkpoint_header",
    "resample",
)


def generate_config_script_file(
    path, simPar, param_info, measurement_flags, MCMC_fields, verbose=False
):
    """Write an MCMC config script readable by :func:`read_config_script_file`
    and by the reference reader (format: reference bayes_io.py:543-966).

    ``verbose`` adds explanatory comment lines.
    """
    # Synthetic _s*/_f*/_a* params are re-created by the reader from the
    # fittable specs; writing them back would (a) fail validation and
    # (b) duplicate on the next read. Filter them out so a read config can
    # be re-written verbatim (write -> read -> write is a fixed point).
    if any(n.startswith("_") for n in param_info["names"]):
        param_info = dict(param_info)
        param_info["names"] = [n for n in param_info["names"]
                               if not n.startswith("_")]
    validate_grid(simPar)
    validate_param_info(param_info)
    validate_meas_flags(measurement_flags, simPar["num_meas"])
    validate_MCMC_fields(MCMC_fields, simPar["num_meas"])

    for old, new in _REJECTED_KEYS.items():
        if old in param_info or old in MCMC_fields:
            raise KeyError(f"Outdated key {old} - please replace with {new}")
    for old in _IGNORED_KEYS:
        if old in MCMC_fields or old in measurement_flags:
            print(
                f"Script generator warning: setting \"{old}\" is deprecated "
                "and will have no effect."
            )

    if not path.endswith(".txt"):
        path += ".txt"

    def comment(f, text):
        if verbose:
            f.write(f"# {text}\n")

    names = param_info["names"]
    with open(path, "w+") as f:
        now = datetime.datetime.now()
        f.write(f"{HEADER_TOKEN} {now.date()} AT {now.time()}\n")
        f.write("##\n")
        f.write("p$ Space Grid:\n")
        comment(f, "List of material/system thicknesses - one per measurement")
        _write_row(f, "Length(s)", simPar["lengths"])
        comment(f, "Number of space nodes used by solver discretization")
        _write_row(f, "nx", simPar["nx"])
        comment(f, "Model to use to simulate each measurement")
        _write_row(f, "Measurement type(s)", simPar["meas_types"])
        f.write(f"Number of measurements: {simPar['num_meas']}\n")

        f.write("##\n")
        f.write("p$ Param Info:\n")
        comment(f, "List of names of parameters used in the model")
        _write_row(f, "Param Names", names)
        comment(f, "Conversion from entry units to model units")
        _write_row(
            f, "Unit conversions",
            [param_info["unit_conversions"].get(n, 1) for n in names],
        )
        comment(f, "Whether the MCMC works with the log of each param")
        _write_row(f, "Do logscale", [param_info["do_log"].get(n, 0) for n in names])
        comment(f, "Whether the MCMC proposes moves for this parameter")
        _write_row(f, "Active", [param_info["active"].get(n, 0) for n in names])
        comment(f, "Bounds of prior distribution for each parameter")
        _write_row(
            f, "Prior",
            [param_info["prior_dist"].get(n, (-np.inf, np.inf)) for n in names],
        )
        comment(f, "Initial values for each parameter")
        _write_row(f, "Initial guess", [param_info["init_guess"].get(n, 0) for n in names])
        comment(f, "Trial move size for each parameter")
        _write_row(f, "Trial move size", [param_info["trial_move"].get(n, 0) for n in names])
        if "do_mu_constraint" in param_info:
            comment(f, "Restrict ambipolar mobility within A +/- B")
            mu = param_info["do_mu_constraint"]
            f.write(f"Mu constraint: {mu[0]}\t{mu[1]}\n")

        f.write("##\n")
        f.write("p$ Measurement handling flags:\n")
        comment(f, "Truncate measurements to this time range")
        tc = measurement_flags["time_cutoff"]
        f.write(f"Time cutoffs: {tc[0]}\t{tc[1]}\n")
        comment(f, "Which measurements in a sequence to keep (None = all)")
        select = measurement_flags["select_obs_sets"]
        if select is None:
            f.write(f"Select measurement: {select}\n")
        else:
            _write_row(f, "Select measurement", select)

        f.write("##\n")
        f.write("p$ MCMC Control flags:\n")
        comment(f, "How many samples to propose")
        f.write(f"Num iters: {MCMC_fields['num_iters']}\n")
        if "starting_iter" in MCMC_fields:
            comment(f, "Iteration to continue from when loading a checkpoint")
            f.write(f"Starting iter: {MCMC_fields['starting_iter']}\n")
        comment(f, "Solver engine (solveivp | odeint | sdirk | NN | diagnostic)")
        _write_row(f, "Solver name", MCMC_fields["solver"])
        comment(f, "Physics model (std | traps)")
        f.write(f"Model name: {MCMC_fields['model']}\n")
        if "rtol" in MCMC_fields:
            f.write(f"Solver rtol: {MCMC_fields['rtol']}\n")
        if "atol" in MCMC_fields:
            f.write(f"Solver atol: {MCMC_fields['atol']}\n")
        if "hmax" in MCMC_fields:
            comment(f, "Solver maximum time stepsize")
            f.write(f"Solver hmax: {MCMC_fields['hmax']}\n")
        if "refactor_every" in MCMC_fields:
            comment(f, "Chord-mode Newton refactorization period "
                       "(sdirk constant-dt plateau)")
            f.write("Solver refactor_every: "
                    f"{MCMC_fields['refactor_every']}\n")
        if "ramp_block" in MCMC_fields:
            comment(f, "Chord-mode Newton refactorization period inside "
                       "the early-time dt ramp (stepped ramp)")
            f.write(f"Solver ramp_block: {MCMC_fields['ramp_block']}\n")
        if "newton_plateau" in MCMC_fields:
            comment(f, "Newton iterations per stage on the constant-dt "
                       "plateau (ramp keeps the full count)")
            f.write("Solver newton_plateau: "
                    f"{MCMC_fields['newton_plateau']}\n")
        if "newton_div_tol" in MCMC_fields:
            comment(f, "Newton-convergence failure threshold (O(1)-scaled "
                       "residual above which a solve escalates/fails)")
            f.write("Solver newton_div_tol: "
                    f"{MCMC_fields['newton_div_tol']}\n")
        comment(f, "Initial condition mode: density | fluence")
        f.write(f"Init mode: {MCMC_fields['ini_mode']}\n")
        if "likel2move_ratio" in MCMC_fields and "model_uncertainty" in MCMC_fields:
            print(
                "Script generator warning: both likel2move_ratio and "
                "model_uncertainty were defined. likel2move_ratio values will "
                "be ignored!"
            )
        if "likel2move_ratio" in MCMC_fields:
            comment(f, "Model uncertainty = this ratio x trial move size")
            _write_per_meastype(
                f, "Likelihood-to-trial-move", MCMC_fields["likel2move_ratio"]
            )
        if "model_uncertainty" in MCMC_fields:
            comment(f, "Model uncertainty (sampling selectivity)")
            _write_per_meastype(f, "Model uncertainty", MCMC_fields["model_uncertainty"])
        comment(f, "Compare log of measurements and simulations")
        f.write(f"Use log of measurements: {MCMC_fields['log_y']}\n")
        if "fittable_fluences" in MCMC_fields:
            comment(f, "Fit initial-excitation fluences (see scale_factor docs)")
            _write_fittable(f, "Fittable fluences", MCMC_fields["fittable_fluences"])
        if "fittable_absps" in MCMC_fields:
            comment(f, "Fit absorption coefficients")
            _write_fittable(f, "Fittable absorptions", MCMC_fields["fittable_absps"])
        if "scale_factor" in MCMC_fields:
            comment(f, "Per-measurement multiplicative scale factors to fit")
            _write_fittable(f, "Scale factor", MCMC_fields["scale_factor"])
        if "hard_bounds" in MCMC_fields:
            comment(f, "Coerce params to stay within prior bounds")
            f.write(f"Use hard boundaries: {MCMC_fields['hard_bounds']}\n")
        if "force_min_y" in MCMC_fields:
            comment(f, "Raise simulated values to at least the measurement minimum")
            f.write(f"Force min y: {MCMC_fields['force_min_y']}\n")
        if "irf_convolution" in MCMC_fields:
            comment(f, "IRF wavelengths per measurement (None = no convolution)")
            irf = MCMC_fields["irf_convolution"]
            if irf is None:
                f.write(f"IRF: {irf}\n")
            else:
                _write_row(f, "IRF", irf)
        if "parallel_tempering" in MCMC_fields:
            comment(f, "Temperatures of the parallel-tempering ensemble")
            _write_row(f, "Parallel tempering", MCMC_fields["parallel_tempering"])
        if "temper_freq" in MCMC_fields:
            comment(f, "Swap attempt interval in iterations")
            f.write(f"Tempering frequency: {MCMC_fields['temper_freq']}\n")
        comment(f, "Checkpoint saved every this many samples")
        f.write(f"Checkpoint freq: {MCMC_fields['checkpoint_freq']}\n")
        if "load_checkpoint" in MCMC_fields:
            f.write(f"Load checkpoint: {MCMC_fields['load_checkpoint']}\n")
        f.write(f"Initial condition path: {MCMC_fields['init_cond_path']}\n")
        f.write(f"Measurement path: {MCMC_fields['measurement_path']}\n")
        f.write(f"Output path: {MCMC_fields['output_path']}\n")
