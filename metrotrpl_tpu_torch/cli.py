"""Command-line entry points of the port.

    python -m metrotrpl_tpu_torch.cli mcmc <config.txt> [--ensembles E]
    python -m metrotrpl_tpu_torch.cli dense <config.txt>
    python -m metrotrpl_tpu_torch.cli mle <config.txt> [--maxiter N]
    python -m metrotrpl_tpu_torch.cli write-example <out.txt> [--fast]

The inference commands take ``--device`` (default cuda) and read the
reference config-script format with the port's ``config`` package.
``mcmc`` writes ``CPU{j}-final.pik`` per replica into the config's output
path; ``dense`` writes ``CPU{jobid}_P.npy`` / ``_X.npy``; ``mle`` writes
``MLE{jobid}-final.pik``. ``write-example`` writes the staub-MAPI
example config, as ``metrotrpl_tpu.cli write-example`` does, and
synthesizes its data with the port's float64 LSODA oracle.
:func:`write_example_config` also writes the same example under the
shallow-trap model.
"""

import argparse
import os
import sys

import numpy as np


def _load_common(script_path):
    from metrotrpl_tpu_torch.config import (
        get_data,
        get_initpoints,
        read_config,
    )

    sim_info, param_info, meas_flags, MCMC_fields = read_config(script_path)
    iniPar = get_initpoints(MCMC_fields["init_cond_path"], meas_flags)
    e_data = get_data(MCMC_fields["measurement_path"], meas_flags,
                      MCMC_fields)
    return sim_info, param_info, meas_flags, MCMC_fields, iniPar, e_data


def _resolve_jobid(args):
    """Reference main.py:18-24: when no explicit --jobid is given, fall
    back to the SLURM array task id (0 outside SLURM)."""
    if args.jobid is not None:
        return args.jobid
    try:
        return int(os.environ["SLURM_ARRAY_TASK_ID"])
    except (KeyError, ValueError):
        return 0


def _resolve_config(path, jobid):
    """Reference main.py:27 semantics: the config argument may be a script
    HEADER, resolved as ``{header}{jobid}.txt`` (the MCMC_script_writer
    per-array-task convention). An existing literal path always wins."""
    if not os.path.exists(path):
        cand = f"{path}{jobid}.txt"
        if os.path.exists(cand):
            return cand
    return path


def _resolve_out(args):
    """Reference MCMC_script_writer.py:41: an ``out`` argument without a
    .txt suffix is a script header; the file written is
    ``{header}{jobid}.txt`` (one config per SLURM array task)."""
    if args.out.endswith(".txt"):
        return args.out
    return f"{args.out}{_resolve_jobid(args)}.txt"


def cmd_mcmc(args):
    from metrotrpl_tpu_torch.inference.metropolis import metro

    if args.mesh:
        raise NotImplementedError(
            "--mesh (the sharded multi-device walk) is not ported yet")
    jobid = _resolve_jobid(args)
    (sim_info, param_info, _meas, MCMC_fields,
     iniPar, e_data) = _load_common(_resolve_config(args.config, jobid))
    n_ens = args.ensembles
    # as metrotrpl_tpu.cli: array task J covers replica jobids
    # J*E .. J*E+E-1, each seeded args.seed + j and written to
    # CPU{j}-final.pik, so array tasks sharing an output path get
    # disjoint streams and files
    jobids = [jobid * n_ens + e for e in range(n_ens)]
    seeds = [args.seed + j if args.seed is not None
             else (j or 235817049752375780) for j in jobids]
    export_paths = [f"CPU{j}-final.pik" for j in jobids]
    metro(sim_info, iniPar, e_data, MCMC_fields, param_info,
          verbose=args.verbose, export_path=export_paths[0],
          device=args.device, logger_name=f"Ensemble{jobid}", seed=seeds[0],
          seeds=seeds, export_paths=export_paths, irf_dir=args.irf_dir,
          n_ensembles=n_ens)
    print(f"Done. Outputs in {MCMC_fields['output_path']}: "
          f"{', '.join(export_paths)}")


def _start_mode(args, name):
    """The job id, parsed config and data, and run logger of a ``dense`` or
    ``mle`` run, with the config's IRF tables loaded into MCMC_fields."""
    from metrotrpl_tpu_torch.io.logging import start_logging
    from metrotrpl_tpu_torch.ops.convolve import load_irf_tables

    jobid = _resolve_jobid(args)
    (sim_info, param_info, _meas, MCMC_fields,
     iniPar, e_data) = _load_common(_resolve_config(args.config, jobid))
    logger, handler = start_logging(
        log_dir=MCMC_fields["output_path"], name=f"{name}{jobid}",
        verbose=args.verbose)
    if MCMC_fields.get("irf_convolution", None) is not None:
        MCMC_fields["_IRF_tables"] = load_irf_tables(
            MCMC_fields["irf_convolution"], args.irf_dir)
    return jobid, sim_info, param_info, MCMC_fields, iniPar, e_data, \
        logger, handler


def cmd_dense(args):
    from metrotrpl_tpu_torch.inference.dense import bayes, export
    from metrotrpl_tpu_torch.io.logging import stop_logging

    (jobid, sim_info, param_info, MCMC_fields, iniPar, e_data, logger,
     handler) = _start_mode(args, "Dense")
    N, P, X = bayes(None, None, iniPar, sim_info, e_data, MCMC_fields,
                    param_info, logger=logger, seed=jobid,
                    device=args.device)
    out = os.path.join(MCMC_fields["output_path"], f"CPU{jobid}")
    export(out, P, X, logger=logger)
    stop_logging(logger, handler)
    print(f"Done. Output: {out}_P.npy / {out}_X.npy")


def cmd_mle(args):
    from metrotrpl_tpu_torch.inference.mle import mle
    from metrotrpl_tpu_torch.io.logging import stop_logging

    (jobid, sim_info, param_info, MCMC_fields, iniPar, e_data, logger,
     handler) = _start_mode(args, "MLE")
    mle(e_data, sim_info, param_info, iniPar, MCMC_fields,
        f"MLE{jobid}-final.pik", logger, maxiter=args.maxiter,
        device=args.device)
    stop_logging(logger, handler)
    print("Done.")


def synthesize_measurements(mpath, ipath, lengths, nx, params, model="std",
                            t_end=2000.0, nt=501):
    """Write TRPL curves solved by the float64 LSODA oracle at the
    model-unit ``params`` for the fluences in ``ipath`` (t, PL, 2 % of PL
    per row, a new curve at every t = 0), as ``write-example`` does."""
    from metrotrpl_tpu_torch.oracle import solve_reference
    from metrotrpl_tpu_torch.oracle.scipy_reference import beer_lambert

    flu = np.loadtxt(ipath, delimiter=",")
    t = np.linspace(0, t_end, nt)
    rows = []
    for m, th in enumerate(lengths):
        dx = th / nx[m]
        x = np.linspace(dx / 2, th - dx / 2, nx[m])
        ic = beer_lambert(flu[m, 0] * 1e-14, flu[m, 1] * 1e-7, x)
        pl = solve_reference(ic, th, nx[m], t, params, model=model)
        rows.append(np.stack([t, pl, 0.02 * pl], axis=1))
    os.makedirs(os.path.dirname(mpath) or ".", exist_ok=True)
    np.savetxt(mpath, np.concatenate(rows), delimiter=",")


def write_example_config(out, model="std", fast=False, num_iters=100,
                         init_cond=None, measurement=None, output=None,
                         checkpoint_freq=1000, verbose=False):
    """Write the staub-MAPI example config to ``out`` (reference
    MCMC_script_writer.py:46-156 settings) and synthesize its data with
    the float64 LSODA oracle where the files are missing.

    ``model="std"`` writes the config of
    ``metrotrpl_tpu.cli.cmd_write_example``; ``model="traps"`` the same
    geometry and solver under the shallow-trap model, with kC, Nt and
    tauE added at their truth in model units (priors truth x 1e-3 ..
    1e3). ``fast`` selects the sdirk fast mode (hmax 48, chord blocks of
    4) instead of the reference's solveivp."""
    from metrotrpl_tpu_torch.config import generate_config_script_file
    from metrotrpl_tpu_torch.workloads import TRAPS_TRUE

    names = ["n0", "p0", "mu_n", "mu_p", "ks", "Cn", "Cp", "Sf", "Sb",
             "tauN", "tauP", "eps", "Tm"]
    simPar = {"lengths": [311, 2000, 311, 2000, 311, 2000],
              "nx": [128] * 6, "meas_types": ["TRPL"] * 6, "num_meas": 6}
    param_info = {
        "names": names,
        "unit_conversions": {"n0": 1e-21, "p0": 1e-21, "mu_n": 1e5,
                             "mu_p": 1e5, "ks": 1e12, "Cn": 1e33,
                             "Cp": 1e33, "Sf": 1e-2, "Sb": 1e-2, "Tm": 1},
        "do_log": {n: 1 for n in names},
        "active": {n: (0 if n in ("n0", "eps", "Tm") else 1) for n in names},
        "init_guess": {"n0": 1e8, "p0": 3e15, "mu_n": 20, "mu_p": 20,
                       "ks": 4.8e-11, "Cn": 4.4e-29, "Cp": 4.4e-29,
                       "Sf": 10, "Sb": 10, "tauN": 511, "tauP": 871,
                       "eps": 10, "Tm": 300},
        "prior_dist": {"n0": (0, np.inf), "p0": (1e14, 1e16),
                       "mu_n": (1e0, 1e2), "mu_p": (1e0, 1e2),
                       "ks": (1e-11, 1e-9), "Cn": (1e-29, 1e-27),
                       "Cp": (1e-29, 1e-27), "Sf": (1e-1, 1e4),
                       "Sb": (1e-1, 1e4), "tauN": (1, 2e3),
                       "tauP": (1, 1e4), "eps": (0, np.inf),
                       "Tm": (0, np.inf)},
        "trial_move": {n: 0.003 for n in names},
    }
    if model == "traps":
        for n, v in TRAPS_TRUE.items():
            names.append(n)
            param_info["do_log"][n] = 1
            param_info["active"][n] = 1
            param_info["init_guess"][n] = v
            param_info["prior_dist"][n] = (v * 1e-3, v * 1e3)
            param_info["trial_move"][n] = 0.003
    elif model != "std":
        raise ValueError(f"no example config for model {model!r}")
    # data is synthesized at the TRUE parameters below; the walk starts
    # from randomized guesses (reference MCMC_script_writer.py:120-122)
    true_guess = dict(param_info["init_guess"])
    rng = np.random.default_rng(42)
    for n in names:
        if param_info["active"][n]:
            param_info["init_guess"][n] *= 10.0 ** rng.uniform(-0.3, 0.3)

    meas_fields = {"time_cutoff": [0, 2000], "select_obs_sets": None}
    MCMC_fields = {
        "init_cond_path": init_cond or os.path.join(
            "Inputs", "staub_MAPI_threepower_twothick_fluences.csv"),
        "measurement_path": measurement or os.path.join(
            "Inputs", "staub_MAPI_threepower_twothick_nonoise.csv"),
        "output_path": output or os.path.join("bay_outputs", "run0"),
        "ini_mode": "fluence",
        "num_iters": num_iters,
        # fast: the fast integration mode at the hmax validated for this
        # workload; the default keeps the reference writer's solver choice
        **({"solver": ("sdirk",), "hmax": 48.0, "refactor_every": 4}
           if fast else {"solver": ("solveivp",)}),
        "model": model,
        "model_uncertainty": 1,
        "log_y": 1,
        "scale_factor": None,
        "irf_convolution": None,
        "parallel_tempering": [1., 2., 4., 8., 16., 32., 64., 128.],
        "temper_freq": 10,
        "hard_bounds": 1,
        "force_min_y": 0,
        "checkpoint_freq": checkpoint_freq,
        "load_checkpoint": None,
    }
    generate_config_script_file(out, simPar, param_info, meas_fields,
                                MCMC_fields, verbose=verbose)
    print(f"Wrote {out}")

    # Turnkey: synthesize the measurement data with the float64 LSODA
    # oracle at the (pre-randomization) true parameters if it's missing
    # (the reference's staub 'nonoise' dataset is synthetic and unshipped).
    mpath = MCMC_fields["measurement_path"]
    ipath = MCMC_fields["init_cond_path"]
    if not os.path.exists(ipath):
        os.makedirs(os.path.dirname(ipath) or ".", exist_ok=True)
        flu = np.array([[2.12e11, 6e4, 1], [2.12e11, 6e4, 1],
                        [6.36e11, 6e4, 1], [6.36e11, 6e4, 1],
                        [1.91e12, 6e4, 1], [1.91e12, 6e4, 1]])
        np.savetxt(ipath, flu, delimiter=",")
        print(f"Wrote synthetic fluences: {ipath}")
    if not os.path.exists(mpath):
        uc = param_info["unit_conversions"]
        pm = {k: v * uc.get(k, 1) for k, v in true_guess.items()}
        synthesize_measurements(mpath, ipath, simPar["lengths"],
                                simPar["nx"], pm, model=model)
        print(f"Wrote synthetic measurement data: {mpath}")
    return out


def cmd_write_example(args):
    """Generate the staub-MAPI example config (std model); the settings
    of ``metrotrpl_tpu.cli.cmd_write_example``."""
    write_example_config(_resolve_out(args), fast=args.fast,
                         num_iters=args.num_iters, init_cond=args.init_cond,
                         measurement=args.measurement, output=args.output,
                         verbose=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="metrotrpl_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    for name, fn in (("mcmc", cmd_mcmc), ("dense", cmd_dense),
                     ("mle", cmd_mle)):
        sp = sub.add_parser(name)
        sp.add_argument("config",
                        help="MCMC config script path, or a script header "
                             "resolved as {header}{jobid}.txt")
        sp.add_argument("--jobid", type=int, default=None,
                        help="defaults to $SLURM_ARRAY_TASK_ID, else 0")
        sp.add_argument("--verbose", action="store_true")
        sp.add_argument("--irf-dir", default="IRFs")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch solver)")
        if name == "mcmc":
            sp.add_argument("--seed", type=int, default=None)
            sp.add_argument(
                "--ensembles", type=int, default=1,
                help="independent MH replicas fused into one solve batch; "
                     "replica j gets seed+j and its own CPU{j}-final.pik")
            sp.add_argument("--mesh", default=None,
                            help="the sharded multi-device walk: not "
                                 "ported yet")
        if name == "mle":
            sp.add_argument("--maxiter", type=int, default=None)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("write-example")
    sp.add_argument("out",
                    help="config path (*.txt), or a script header written "
                         "as {header}{jobid}.txt")
    sp.add_argument("--jobid", type=int, default=None)
    sp.add_argument("--num-iters", type=int, default=100)
    sp.add_argument("--fast", action="store_true",
                    help="sdirk fast solver config (hmax 48, chord "
                         "refactor_every 4) instead of reference solveivp")
    sp.add_argument("--init-cond", default=None)
    sp.add_argument("--measurement", default=None)
    sp.add_argument("--output", default=None)
    sp.set_defaults(fn=cmd_write_example)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
