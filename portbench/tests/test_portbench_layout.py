"""The benchmark's files: BENCHMARK.json against its contract, every cell
resolved by name from data files, a cell added by files alone, the
frozen yardstick against the port's count, and the import rules."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import common, yardstick
from portbench.reference import likelihood as rl

ROOT = common.REPO_DIR
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    import importlib

    cell = common.Cell(workload)
    assert cell.config["name"] == workload.split(".")[0]
    mode = importlib.import_module(
        f"portbench.harness.{cell.traffic['mode']}")
    assert callable(mode.run)
    assert cell.per_layer and any(m["name"] == "setup_s"
                                  for m in cell.end_to_end)
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert callable(cell.reference.loglik)
    for m in cell.end_to_end:
        assert workload in m.get("workloads", [workload])


def test_a_cell_added_as_files_only_is_found(tmp_path):
    """A later change adds a traffic file, a metric reader and their
    entries; the harness finds them with no edit of its code."""
    shutil.copytree(ROOT / "portbench" / "configs",
                    tmp_path / "portbench" / "configs")
    shutil.copytree(ROOT / "portbench" / "traffic",
                    tmp_path / "portbench" / "traffic")
    shutil.copytree(ROOT / "portbench" / "metrics",
                    tmp_path / "portbench" / "metrics")
    mix = json.loads((ROOT / "portbench/traffic/walk-e8.json").read_text())
    mix["ensembles"] = 1
    (tmp_path / "portbench/traffic/walk-e1.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/window_s.walk.py").write_text(
        "def read(ctx):\n    return ctx['trace'].window_s\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "staub-flagship.walk-e1",
                               "config": "staub-flagship",
                               "traffic": "walk-e1", "chips": 1,
                               "why": "one ensemble"})
    bench["per_layer"].append({"name": "window_s.walk", "unit": "s",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "walker_steps_per_s",
                               "workloads": ["staub-flagship.walk-e1"]})
    for m in bench["end_to_end"]:
        if m["name"] == "walker_steps_per_s":
            m["workloads"].append("staub-flagship.walk-e1")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = common.Cell("staub-flagship.walk-e1", root=tmp_path)
    assert cell.traffic["ensembles"] == 1
    names = [m["name"] for m in cell.per_layer]
    assert "window_s.walk" in names

    class T:
        window_s = 2.5
    assert cell.reader("window_s.walk")({"trace": T}) == 2.5


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted((ROOT / "portbench").rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    """Top-level names compared whole: the port's name begins with the
    JAX package's."""
    bad = {"jax", "jaxlib", "flax", "metrotrpl_tpu"}
    assert not set(_imports(path)) & bad


#: the yardstick: the reference, the frozen count, the comparison, the
#: synthesis and the readers take nothing of the program
YARDSTICK = (sorted((ROOT / "portbench/reference").glob("*.py"))
             + [ROOT / "portbench/harness" / f for f in (
                 "yardstick.py", "check.py", "synth.py", "readers.py")]
             + sorted((ROOT / "portbench/metrics").glob("*.py")))


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "metrotrpl_tpu_torch" not in set(_imports(path))


def test_yardstick_loads_without_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "sys.modules['metrotrpl_tpu_torch'] = None; "
            "import portbench.reference.likelihood, portbench.reference.mh,"
            " portbench.harness.yardstick, portbench.harness.check, "
            "portbench.harness.synth, portbench.harness.readers; "
            "print('ok')" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_frozen_count_equals_the_ports(config, tmp_path):
    """The frozen operation count equals the port's solve_flops, and the
    reference's plans the port's, at each configuration's fast and rung
    plans as the walk and the dense sampler build them."""
    from metrotrpl_tpu_torch.inference.likelihood import (
        build_likelihood_plan,
        resolve_solver_mode,
    )
    from metrotrpl_tpu_torch.inference.metropolis import plans_from_config
    from metrotrpl_tpu_torch.solver.solve_kernel import solve_flops

    cell = common.Cell(f"{config}.walk-e8")
    setup = rl.load_setup(cell.config_path, _curves(cell, tmp_path))
    sim_info, param_info, mc, e_data, iniPar, irf = _inputs(cell, tmp_path)
    walk_plan, _ = plans_from_config(sim_info, param_info, dict(mc), e_data,
                                     iniPar, irf_tables=irf)
    hm, align = resolve_solver_mode(mc, 1.0)
    dense_plan = build_likelihood_plan(
        sim_info, param_info, mc, e_data, iniPar, irf_tables=irf, hmax=hm,
        align_outputs=align, refactor_every=int(mc.get("refactor_every", 1)))
    for lp in (walk_plan, dense_plan):
        (_, fast, rung), = lp.fwd
        for fp, ref in ((fast, setup.fast), (rung, setup.rung)):
            assert (fp.n_steps, fp.n_ramp) == (ref.n_steps, ref.n_ramp)
            np.testing.assert_allclose(fp.dt, ref.dt, rtol=1e-12)
            assert solve_flops(
                fp.model, fp.nx, fp.n_steps, scheme_name=fp.scheme,
                newton_iters=fp.newton_iters,
                refactor_every=fp.refactor_every, n_ramp=fp.n_ramp,
                ramp_block=fp.ramp_block,
                newton_plateau=fp.newton_plateau) == \
                yardstick.solve_flops(ref)


def _curves(cell, tmp_path):
    """The cell's curves; synthesised ones at the truth by the frozen
    synthesis, into tmp_path (slow at nx=128: a cheap stand-in of the
    same grid does for plan tests)."""
    cfg = cell.config
    if "synthesize" not in cfg:
        return common.BENCH_DIR / cfg["MCMC_fields"]["measurement_path"]
    sp = cfg["synthesize"]
    t = np.linspace(0, float(sp["t_end"]), int(sp["nt"]))
    rows = [np.stack([t, np.exp(-t / 300.0) + 1e-3, np.full_like(t, .02)], 1)
            for _ in cfg["simPar"]["lengths"]]
    path = tmp_path / "curves.csv"
    np.savetxt(path, np.concatenate(rows), delimiter=",")
    return path


def _inputs(cell, tmp_path):
    curves = _curves(cell, tmp_path)
    cell.config = dict(cell.config)
    cell.config.pop("synthesize", None)
    mc = dict(cell.config["MCMC_fields"])
    mc["measurement_path"] = str(curves)
    cell.config["MCMC_fields"] = mc
    return common.program_inputs(cell)


#: the numbers each mode's check compares against a limit of the
#: configuration's (moves_wrong is exact)
LIMITED = {"walk": {"ll_off_share", "accepts_missed", "swaps_wrong"},
           "dense": {"ll_off_share"}}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_limits(workload):
    cell = common.Cell(workload)
    mode = cell.traffic["mode"]
    lim = cell.config["limits"][mode]
    assert set(lim) == LIMITED[mode]
    assert all(0 < v < 1 for v in lim.values())
    assert cell.setup().cfg["limits"] == cell.config["limits"]
