"""Shared staub-MAPI workload constants (reference MCMC_script_writer.py
:46-156 settings). Copy of ``metrotrpl_tpu/workloads.py``, plus the
shallow-trap parameters of the JAX package's traps workload.
"""

import numpy as np

#: entry-unit -> internal-unit conversions
STAUB_UC = {"n0": 1e-21, "p0": 1e-21, "mu_n": 1e5, "mu_p": 1e5,
            "ks": 1e12, "Cn": 1e33, "Cp": 1e33, "Sf": 1e-2, "Sb": 1e-2}

STAUB_NAMES = ["n0", "p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Sf", "Sb",
               "tauN", "tauP", "eps", "Tm"]

#: true parameters of the synthetic staub fit (entry units)
STAUB_TRUE = {"n0": 1e8, "p0": 3e15, "mu_n": 20, "mu_p": 20, "ks": 4.8e-11,
              "Cn": 4.4e-29, "Cp": 4.4e-29, "Sf": 10, "Sb": 10,
              "tauN": 511, "tauP": 871, "eps": 10, "Tm": 300}

STAUB_PRIOR = {"n0": (0, np.inf), "p0": (1e14, 1e16),
               "mu_n": (1, 100), "mu_p": (1, 100),
               "ks": (1e-11, 1e-9), "Cn": (1e-29, 1e-27),
               "Cp": (1e-29, 1e-27), "Sf": (1e-1, 1e4),
               "Sb": (1e-1, 1e4), "tauN": (1, 2e3),
               "tauP": (1, 1e4), "eps": (0, np.inf),
               "Tm": (0, np.inf)}

#: shallow-trap parameters of the traps fit, in MODEL units (unit
#: conversion 1): capture coefficient [nm^3/ns], trap density [nm^-3],
#: detrapping time [ns] (scripts/probe_traps_ll.py TRAPS_TRUE, validated
#: against LSODA in tests/test_forward_solver.py)
TRAPS_TRUE = {"kC": 5.0, "Nt": 1e-6, "tauE": 300.0}

#: frozen parameters in the standard fit
STAUB_INACTIVE = ("n0", "eps", "Tm")


def staub_param_info(trial_move=0.01, inactive=STAUB_INACTIVE):
    """The standard staub param_info dict (all-log, given move width)."""
    names = list(STAUB_NAMES)
    return {
        "names": names,
        "unit_conversions": dict(STAUB_UC),
        "do_log": {n: 1 for n in names},
        "active": {n: (0 if n in inactive else 1) for n in names},
        "init_guess": dict(STAUB_TRUE),
        "prior_dist": dict(STAUB_PRIOR),
        "trial_move": {n: trial_move for n in names},
    }
