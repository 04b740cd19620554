"""Command-line entry points of the port.

    python -m metrotrpl_tpu_torch.cli mcmc <config.txt> [--ensembles E]
                                            [--mesh ExC [--mesh-devices ...]]
    python -m metrotrpl_tpu_torch.cli dense <config.txt>
    python -m metrotrpl_tpu_torch.cli mle <config.txt> [--maxiter N]
    python -m metrotrpl_tpu_torch.cli write-example <out.txt> [--fast]
    python -m metrotrpl_tpu_torch.cli write-real-example <out.txt> [--fast]
                                                          [--irf]
    python -m metrotrpl_tpu_torch.cli write-pa-example <out.txt>
    python -m metrotrpl_tpu_torch.cli convert-config <src> <dst>

The inference commands take ``--device`` (default cuda) and read the
reference config-script format with the port's ``config`` package.
``mcmc`` writes ``CPU{j}-final.pik`` per replica into the config's output
path; ``dense`` writes ``CPU{jobid}_P.npy`` / ``_X.npy``; ``mle`` writes
``MLE{jobid}-final.pik``. ``write-example`` writes the staub-MAPI
example config, as ``metrotrpl_tpu.cli write-example`` does, and
synthesizes its data with the port's float64 LSODA oracle.
:func:`write_example_config` also writes the same example under the
shallow-trap model. ``write-real-example`` writes the config that fits
the measured staub MAPI data in ``Inputs/`` (density-mode initial
profiles, optionally the 745 nm IRF), ``write-pa-example`` the toy
``pa`` config and its two data files, and ``convert-config`` converts
between the text and the TOML format; each writes the file the JAX
package's command of the same name writes.
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

    mesh_shape = None
    if args.mesh:
        d_e, _, d_c = args.mesh.lower().partition("x")
        mesh_shape = (int(d_e), int(d_c))
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
          n_ensembles=n_ens, mesh_shape=mesh_shape,
          devices=(args.mesh_devices.split(",") if args.mesh_devices
                   else None))
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


#: the priors of ``write-example`` (reference MCMC_script_writer.py)
_EXAMPLE_PRIOR = {"n0": (0, np.inf), "p0": (1e14, 1e16),
                  "mu_n": (1e0, 1e2), "mu_p": (1e0, 1e2),
                  "ks": (1e-11, 1e-9), "Cn": (1e-29, 1e-27),
                  "Cp": (1e-29, 1e-27), "Sf": (1e-1, 1e4),
                  "Sb": (1e-1, 1e4), "tauN": (1, 2e3), "tauP": (1, 1e4),
                  "eps": (0, np.inf), "Tm": (0, np.inf)}


def _example_param_info(trial_move, **prior):
    """The staub parameters of the example configs: the reference
    initial guesses (Inputs/mcmc0.txt), n0, eps and Tm frozen, every
    parameter log-scaled, ``write-example``'s priors with ``prior``
    overriding them."""
    from metrotrpl_tpu_torch.workloads import staub_param_info

    pi = staub_param_info(trial_move=trial_move)
    pi["prior_dist"] = {**_EXAMPLE_PRIOR, **prior}
    return pi


def _example_mcmc(fast, **fields):
    """``fields`` and the MCMC fields the example configs share: 8
    chains at T = 1..128 swapping every 10th iteration, hard bounds,
    model uncertainty 1 on log-y data, and the solver: ``fast`` is the
    sdirk fast mode at the hmax validated for the staub workload (48,
    chord blocks of 4), else the reference writer's solveivp."""
    return {**fields,
            **({"solver": ("sdirk",), "hmax": 48.0, "refactor_every": 4}
               if fast else {"solver": ("solveivp",)}),
            "model_uncertainty": 1, "log_y": 1, "scale_factor": None,
            "parallel_tempering": [1., 2., 4., 8., 16., 32., 64., 128.],
            "temper_freq": 10, "hard_bounds": 1, "force_min_y": 0,
            "load_checkpoint": None}


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

    simPar = {"lengths": [311, 2000, 311, 2000, 311, 2000],
              "nx": [128] * 6, "meas_types": ["TRPL"] * 6, "num_meas": 6}
    param_info = _example_param_info(0.003)
    names = param_info["names"]
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
    MCMC_fields = _example_mcmc(
        fast,
        init_cond_path=init_cond or os.path.join(
            "Inputs", "staub_MAPI_threepower_twothick_fluences.csv"),
        measurement_path=measurement or os.path.join(
            "Inputs", "staub_MAPI_threepower_twothick_nonoise.csv"),
        output_path=output or os.path.join("bay_outputs", "run0"),
        ini_mode="fluence", num_iters=num_iters, model=model,
        irf_convolution=None, checkpoint_freq=checkpoint_freq)
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


def cmd_write_real_example(args):
    """Generate a config fitting the vendored REAL measured staub MAPI
    dataset (the reference's actual scientific use case):
    `Inputs/real_staub_aug_corr_renoised.csv` — 3 excitation powers at
    311 nm, 141 points to 4248 ns each, absolute-units TRPL — with
    density-mode initial profiles from `Inputs/real_staub_input.csv`
    (reference Inputs/ assets; see docs/REAL_DATA.md walkthrough).

    --irf adds detector-IRF convolution with the vendored 745 nm table
    (near the MAPI emission wavelength). The dataset's ~30 ns binning
    makes the 4.7 ns-wide IRF numerically almost an identity, so it is
    off by default; the flag exists to exercise the full pipeline on
    real data."""
    from metrotrpl_tpu_torch.config import generate_config_script_file

    args.out = _resolve_out(args)
    n_meas = 3
    simPar = {"lengths": [311] * n_meas, "nx": [128] * n_meas,
              "meas_types": ["TRPL"] * n_meas, "num_meas": n_meas}
    param_info = _example_param_info(
        0.01, Sf=(1e-4, 1e4), Sb=(1e-4, 1e4), tauN=(1, 1500),
        tauP=(1, 3000))
    meas_fields = {"time_cutoff": [0, np.inf], "select_obs_sets": None}
    MCMC_fields = _example_mcmc(
        args.fast,
        init_cond_path=args.init_cond or os.path.join(
            "Inputs", "real_staub_input.csv"),
        measurement_path=args.measurement or os.path.join(
            "Inputs", "real_staub_aug_corr_renoised.csv"),
        output_path=args.output or os.path.join("bay_outputs", "real0"),
        ini_mode="density", num_iters=args.num_iters, model="std",
        irf_convolution=[745] * n_meas if args.irf else None,
        checkpoint_freq=1000)
    generate_config_script_file(args.out, simPar, param_info, meas_fields,
                                MCMC_fields, verbose=True)
    print(f"Wrote {args.out}")


def cmd_write_pa_example(args):
    """Generate the 'pa' toy-problem config (reference pa_toy_writer.py:
    1D multi-well potential, tempering ladder [0.05, 0.3, 2])."""
    from metrotrpl_tpu_torch.config import generate_config_script_file

    args.out = _resolve_out(args)
    simPar = {"lengths": [1], "nx": [1], "meas_types": ["pa"],
              "num_meas": 1}
    param_info = {
        "names": ["x0"],
        "unit_conversions": {},
        "do_log": {"x0": 0},
        "active": {"x0": 1},
        "init_guess": {"x0": 0.2},
        "prior_dist": {"x0": (-2, 2)},
        "trial_move": {"x0": 0.2},
    }
    meas_fields = {"time_cutoff": [0, np.inf], "select_obs_sets": None}
    MCMC_fields = {
        "init_cond_path": args.init_cond or "pa_ic.csv",
        "measurement_path": args.measurement or "pa_data.csv",
        "output_path": args.output or os.path.join("bay_outputs", "pa0"),
        "ini_mode": "density",
        "num_iters": args.num_iters,
        "solver": ("solveivp",),
        "model": "pa",
        "model_uncertainty": 1,
        "log_y": 1,
        "hard_bounds": 1,
        "parallel_tempering": [0.05, 0.3, 2.0],
        "temper_freq": 10,
        "checkpoint_freq": 1000,
        "load_checkpoint": None,
    }
    generate_config_script_file(args.out, simPar, param_info, meas_fields,
                                MCMC_fields, verbose=True)
    # minimal companion data files so the config runs out of the box
    base = os.path.dirname(args.out) or "."
    ic = MCMC_fields["init_cond_path"]
    mp = MCMC_fields["measurement_path"]
    for path, content in ((os.path.join(base, os.path.basename(ic)),
                           "0\n"),
                          (os.path.join(base, os.path.basename(mp)),
                           "0,1,1\n")):
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(content)
    print(f"Wrote {args.out}")


def cmd_convert_config(args):
    """Convert between the reference text format and the native TOML
    format (direction chosen by the output extension)."""
    import copy

    from metrotrpl_tpu_torch.config import (
        finalize_config,
        generate_config_script_file,
        parse_config,
        write_config_toml,
    )

    # Writers expect RAW (pre-finalize) dicts: finalize subsets the grid
    # under select_obs_sets, which must not be baked into the written file
    # (the written config still references the full measurement CSVs).
    raw = parse_config(args.src)
    finalize_config(*copy.deepcopy(raw))  # validate without mutating
    dst = args.dst
    if dst.endswith(".toml"):
        write_config_toml(dst, *raw)
    else:
        generate_config_script_file(dst, *raw)
        if not dst.endswith(".txt"):
            dst += ".txt"  # the text writer enforces the extension
    print(f"Wrote {dst}")


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
            sp.add_argument(
                "--mesh", default=None, metavar="ExC",
                help="the sharded walk: E x C processes, splitting the "
                     "ensembles E ways and the tempered chains C ways; "
                     "the same replicas and result as --ensembles alone")
            sp.add_argument(
                "--mesh-devices", default=None, metavar="DEV,DEV,...",
                help="one device per mesh rank, e.g. cuda:0,cuda:0 for "
                     "ranks that share a card (default: a card of its own "
                     "per rank, or the CPU with --device cpu)")
        if name == "mle":
            sp.add_argument("--maxiter", type=int, default=None)
        sp.set_defaults(fn=fn)

    for name, fn, iters in (
            ("write-example", cmd_write_example, 100),
            ("write-real-example", cmd_write_real_example, 8000),
            ("write-pa-example", cmd_write_pa_example, 5000)):
        sp = sub.add_parser(name)
        sp.add_argument("out",
                        help="config path (*.txt), or a script header "
                             "written as {header}{jobid}.txt")
        sp.add_argument("--jobid", type=int, default=None,
                        help="defaults to $SLURM_ARRAY_TASK_ID, else 0")
        sp.add_argument("--num-iters", type=int, default=iters)
        if name in ("write-example", "write-real-example"):
            sp.add_argument("--fast", action="store_true",
                            help="sdirk fast solver config (hmax 48, chord "
                                 "refactor_every 4) instead of reference "
                                 "solveivp")
        if name == "write-real-example":
            sp.add_argument(
                "--irf", action="store_true",
                help="convolve with the vendored 745 nm detector IRF "
                     "(~identity at this dataset's 30 ns binning; "
                     "exercises the full pipeline)")
        sp.add_argument("--init-cond", default=None)
        sp.add_argument("--measurement", default=None)
        sp.add_argument("--output", default=None)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser(
        "convert-config",
        help="convert between the reference text config format and the "
             "native TOML format (by output extension)")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.set_defaults(fn=cmd_convert_config)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
