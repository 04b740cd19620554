"""Measurement / initial-condition CSV loading.

Same semantics as the reference loaders (reference bayes_io.py:71-149):
measurement files are (t, y, uncertainty) rows with a new measurement starting
at every t == 0 row; optional time cutoffs, log10 transform (with uncertainty
propagated as u/(y ln 10)), and measurement subset selection.
"""

import csv
import os
import sys

import numpy as np

from metrotrpl_tpu_torch.runtime import load_csv


def get_data(exp_file, ic_flags, MCMC_fields, rng=None):
    """Load and preprocess measurement data.

    Parameters
    ----------
    exp_file : str
        CSV path with rows (time, value, uncertainty). Rows with time == 0
        delimit successive measurements.
    ic_flags : dict
        Needs 'time_cutoff' (pair or None) and 'select_obs_sets'
        (list or None); optional 'noise_level'.
    MCMC_fields : dict
        Needs 'log_y'.
    rng : np.random.Generator, optional
        Source for optional synthetic noise injection.

    Returns
    -------
    (times, vals, uncs) : tuple of lists of 1D arrays, one per measurement.
    """
    time_range = ic_flags["time_cutoff"]
    select = ic_flags["select_obs_sets"]
    noise_level = ic_flags.get("noise_level", 0)
    log_y = MCMC_fields["log_y"]
    bval_cutoff = sys.float_info.min

    data = load_csv(exp_file)  # native parser with np.loadtxt fallback
    data = np.atleast_2d(data)  # single-row files load as 1D
    times, y, unc = data[:, 0], data[:, 1].copy(), data[:, 2].copy()

    if noise_level:
        if rng is None:
            rng = np.random.default_rng()
        y = y + noise_level * rng.standard_normal(len(y))

    starts = list(np.where(times == 0)[0]) + [None]
    if len(starts) == 1:
        raise ValueError(
            f"No measurements found in {exp_file}: measurement boundaries "
            "are rows with time == 0, and the file contains none")
    t_list, y_list, u_list = [], [], []
    for lo, hi in zip(starts[:-1], starts[1:]):
        t_list.append(times[lo:hi])
        y_list.append(y[lo:hi])
        u_list.append(unc[lo:hi])

    if time_range is not None:
        t_low, t_high = time_range[0], time_range[1]
        for i in range(len(t_list)):
            keep_l = np.searchsorted(t_list[i], t_low, side="left")
            keep_r = np.searchsorted(t_list[i], t_high, side="right")
            t_list[i] = t_list[i][keep_l:keep_r]
            y_list[i] = y_list[i][keep_l:keep_r]
            u_list[i] = u_list[i][keep_l:keep_r]

    if log_y:
        for i in range(len(t_list)):
            y_abs = np.abs(y_list[i])
            y_abs[y_abs < bval_cutoff] = bval_cutoff
            u_list[i] = u_list[i] / y_abs / np.log(10)
            y_list[i] = np.log10(y_abs)

    if select is not None:
        # Honor select ORDER (and duplicates), matching get_initpoints and
        # finalize_config's grid subsetting. (The reference filters in
        # file order here, bayes_io.py:124-131, while its get_initpoints
        # fancy-indexes — internally inconsistent for unsorted selects,
        # silently pairing data with the wrong grid/initial condition.)
        for i in select:
            if not 0 <= i < len(t_list):
                raise ValueError(
                    f"select_obs_sets index {i} out of range: {exp_file} "
                    f"contains {len(t_list)} measurements")
        t_list = [t_list[i] for i in select]
        y_list = [y_list[i] for i in select]
        u_list = [u_list[i] for i in select]

    return (t_list, y_list, u_list)


def get_initpoints(init_file, ic_flags):
    """Load per-measurement initial conditions (density profiles of length nx,
    or [fluence, absorption, direction] triples)."""
    select = ic_flags["select_obs_sets"]
    rows = []
    with open(init_file, newline="", encoding=None) as f:
        for row in csv.reader(f):
            if len(row) == 0:
                continue
            rows.append(row)
    if select is not None:
        rows = np.array(rows)[select]
    return np.array(rows, dtype=float)


def make_dir(dirname):
    if not os.path.isdir(dirname):
        os.makedirs(dirname, exist_ok=True)
