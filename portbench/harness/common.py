"""What every cell shares: where the benchmark's files are, the lookup of
a cell's configuration and traffic mix by name, the measured curves, and
the program's inputs as its command line would read them.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` names its configuration
file there and its mix in ``traffic/<mix>.json``; nothing here knows a
cell by name.
"""

import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = BENCH_DIR.parent
#: everything a run makes (curves, the program's config scripts, caches,
#: traces): listed in portbench/.gitignore
CACHE_DIR = BENCH_DIR / ".cache"


def log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def pin_cache_dirs():
    """Point every build and kernel cache at fixed directories inside the
    checkout, before torch is imported."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE_DIR / sub)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)


def _inf(o):
    """The configuration files write infinity as the string "inf"."""
    if isinstance(o, dict):
        return {k: _inf(v) for k, v in o.items()}
    if isinstance(o, list):
        return [_inf(v) for v in o]
    return float("inf") if o == "inf" else o


def load_json(path):
    return _inf(json.loads(Path(path).read_text()))


class Cell:
    """One entry of BENCHMARK.json's workloads, resolved: its configuration
    file, its traffic mix ``portbench/traffic/<mix>.json`` and the metrics
    that apply to it. ``root`` is the checkout."""

    def __init__(self, workload, root=REPO_DIR):
        root = Path(root)
        bench = json.loads((root / "BENCHMARK.json").read_text())
        hits = [w for w in bench["workloads"] if w["name"] == workload]
        if not hits:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = hits[0]
        self.root = root
        self.name = workload
        self.chips = int(w["chips"])
        conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
        self.config_path = root / conf["file"]
        self.config = load_json(self.config_path)
        self.traffic_name = w["traffic"]
        self.traffic = load_json(root / BENCH_DIR.name / "traffic"
                                 / f"{w['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]

    @property
    def reference(self):
        """The plain reference of the cell's configuration: the module its
        file names under "reference", with load_setup(config file,
        curves) -> setup (.cfg, .temps, .fast and .rung plans) and
        loglik(setup, states, temps, fast_dtype=, rung_dtype=,
        cmp_dtype=, device=, block=) -> (ll (K, len(temps)), rows sent to
        the rung)."""
        import importlib

        return importlib.import_module(self.config["reference"])

    def setup(self):
        """The reference's set-up of the cell's configuration."""
        return self.reference.load_setup(self.config_path,
                                         curves_path(self.config))

    def reader(self, metric):
        """The per-layer metric's reader, ``read(ctx)`` of
        portbench/metrics/<metric>.py, or where there is none, of the
        reader its base name shares (``mfu.walk`` and ``mfu.dense`` read
        the same quantity through metrics/mfu.py)."""
        import importlib.util

        folder = self.root / BENCH_DIR.name / "metrics"
        path = folder / f"{metric}.py"
        if not path.is_file():
            path = folder / f"{metric.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def curves_path(cfg):
    """The measured curves of a configuration: its data file, or for a
    configuration with a ``synthesize`` block the curves made from it,
    once per checkout, into the cache."""
    mc = cfg["MCMC_fields"]
    path = BENCH_DIR / mc["measurement_path"]
    if "synthesize" not in cfg:
        return path
    if path.is_file():
        log(f"curves loaded from the cache: {path.relative_to(REPO_DIR)}")
        return path
    import numpy as np

    from portbench.harness.synth import synthesize

    path.parent.mkdir(parents=True, exist_ok=True)
    flu = np.atleast_2d(np.loadtxt(BENCH_DIR / mc["init_cond_path"],
                                   delimiter=","))
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    synthesize(cfg, flu, tmp)
    os.replace(tmp, path)
    log(f"curves synthesised into the cache: {path.relative_to(REPO_DIR)}")
    return path


def program_inputs(cell):
    """(sim_info, param_info, MCMC_fields, e_data, iniPar, irf_tables) as
    ``cli mcmc`` / ``cli dense`` read them: the configuration written as
    the port's config script and read back by the port's reader."""
    from metrotrpl_tpu_torch.config import (
        generate_config_script_file,
        get_data,
        get_initpoints,
        read_config,
    )
    from metrotrpl_tpu_torch.ops.convolve import load_irf_tables

    cfg = cell.config
    mc = dict(cfg["MCMC_fields"])
    mc["measurement_path"] = str(curves_path(cfg))
    mc["init_cond_path"] = str(BENCH_DIR / mc["init_cond_path"])
    mc["output_path"] = str(CACHE_DIR / "out")
    mc["num_iters"] = 1
    mc["checkpoint_freq"] = 1
    mc["solver"] = tuple(mc["solver"])
    pinfo = dict(cfg["param_info"])
    pinfo["prior_dist"] = {k: tuple(v)
                           for k, v in pinfo["prior_dist"].items()}
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    script = CACHE_DIR / f"{cfg['name']}.txt"
    generate_config_script_file(str(script), cfg["simPar"], pinfo,
                                cfg["meas_fields"], mc)
    sim_info, param_info, meas_flags, MCMC_fields = read_config(str(script))
    iniPar = get_initpoints(MCMC_fields["init_cond_path"], meas_flags)
    e_data = get_data(MCMC_fields["measurement_path"], meas_flags,
                      MCMC_fields)
    irf_tables = {}
    if MCMC_fields.get("irf_convolution") is not None:
        irf_tables = load_irf_tables(MCMC_fields["irf_convolution"],
                                     str(BENCH_DIR / "data"))
    return sim_info, param_info, MCMC_fields, e_data, iniPar, irf_tables
