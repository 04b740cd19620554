"""PyTorch port end to end: metro() on the CPU writes checkpoints the JAX
package loads, with the JAX metro's History layout; resume repeats the
uninterrupted walk; the port imports and builds the flagship and traps
plans with jax and the JAX package unimportable; asking for CUDA where
there is none raises."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_parity import REPO, walk_setup

from metrotrpl_tpu.io.ensemble import load_checkpoint



def test_metro_pickle_loads_with_reference_layout(tmp_path):
    """The port's metro(device='cpu') checkpoint loads through
    metrotrpl_tpu.io.ensemble.load_checkpoint with the same History
    shapes, fields and initial log-likelihood (float64, within 1e-6) as
    the JAX metro's on the same config."""
    from metrotrpl_tpu.inference import metro as jmetro
    from metrotrpl_tpu_torch.inference.metropolis import metro as tmetro

    sim_info, iniPar, e_data, mcmc, pi = walk_setup(tmp_path / "j", 6)
    jmetro(sim_info, iniPar, e_data, dict(mcmc), pi, export_path="f.pik",
           seed=3, trap_signals=False)
    sim_info, iniPar, e_data, mcmc, pi = walk_setup(tmp_path / "t", 6)
    tmetro(sim_info, iniPar, e_data, dict(mcmc), pi, export_path="f.pik",
           seed=3, device="cpu", trap_signals=False)
    ej = load_checkpoint(str(tmp_path / "j" / "f.pik"))
    et = load_checkpoint(str(tmp_path / "t" / "f.pik"))
    for a in ("states", "accept", "loglikelihood", "swap_attempts",
              "swap_accept"):
        assert getattr(et.H, a).shape == getattr(ej.H, a).shape, a
        assert getattr(et.H, a).dtype == getattr(ej.H, a).dtype, a
    assert et.ensemble_fields.keys() == ej.ensemble_fields.keys()
    assert et.latest_iter == ej.latest_iter == 6
    assert np.isfinite(et.H.loglikelihood).all()
    np.testing.assert_allclose(et.H.loglikelihood[:, 0],
                               ej.H.loglikelihood[:, 0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(et.H.states[:, :, 0], ej.H.states[:, :, 0])
    assert et.H.swap_attempts.sum() == ej.H.swap_attempts.sum() > 0
    assert hasattr(et.H, "mean_mu_n")      # GUI views attached


def test_metro_resume_repeats_uninterrupted_walk(tmp_path):
    """6 straight iterations == 3 + checkpoint + resume to 6, bit for bit:
    the production draws are keyed by iteration and the carried ll is
    restored."""
    from metrotrpl_tpu_torch.inference.metropolis import metro as tmetro

    args = walk_setup(tmp_path / "a", 6)
    a = tmetro(*args, export_path="f.pik", seed=9, device="cpu",
               trap_signals=False)
    args = walk_setup(tmp_path / "b", 3)
    tmetro(*args, export_path="c.pik", seed=9, device="cpu",
           trap_signals=False)
    args = walk_setup(tmp_path / "b", 6, load_checkpoint="c.pik")
    b = tmetro(*args, export_path="f.pik", seed=9, device="cpu",
               trap_signals=False)
    np.testing.assert_array_equal(a.H.states, b.H.states)
    np.testing.assert_array_equal(a.H.loglikelihood, b.H.loglikelihood)
    np.testing.assert_array_equal(a.H.accept[:, 3:], b.H.accept[:, 3:])


def test_port_imports_and_builds_flagship_plans_without_jax(tmp_path):
    """With jax and the JAX package unimportable, every port module (the
    surrogate, the IRF oracle, the GUI and the native runtime included),
    chip_smoke.py and scripts/posterior_torch.py, flagship_torch.py and
    esc_validation_torch.py import, the native CSV
    parser loads a file,
    write-example writes the flagship config (with stand-in data),
    write_example_config the traps config, the port reads both and builds
    their likelihood and move plans, and the evaluation tensors are made
    on the CPU; a seeded surrogate saved to .npz runs the NN likelihood
    and write-pa-example's config the pa likelihood."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        sys.modules["metrotrpl_tpu"] = None    # and of the JAX package
        import importlib, pkgutil
        import numpy as np
        import metrotrpl_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            metrotrpl_tpu_torch.__path__, "metrotrpl_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        assert "metrotrpl_tpu_torch.solver.solve_kernel" in names
        assert "metrotrpl_tpu_torch.config.validate" in names
        assert "metrotrpl_tpu_torch.inference.dense" in names
        assert "metrotrpl_tpu_torch.inference.mle" in names
        assert "metrotrpl_tpu_torch.surrogate" in names
        assert "metrotrpl_tpu_torch.oracle.irf_reference" in names
        for m in ("gui", "gui.main", "gui.plots", "gui.popups",
                  "gui.quicksim", "gui.rclickmenu",
                  "gui.secondary_parameters", "gui.styles", "gui.window",
                  "runtime", "parallel", "parallel.mesh",
                  "parallel.sharded_mh"):
            assert "metrotrpl_tpu_torch." + m in names, m
        import chip_smoke
        sys.path.insert(0, "scripts")
        import posterior_torch
        import flagship_torch
        import esc_validation_torch
        import extend_oracle_torch
        from metrotrpl_tpu_torch.runtime import load_csv, native_available
        assert native_available()
        assert load_csv("Inputs/real_staub_input.csv").shape[0] > 0
        from metrotrpl_tpu_torch.cli import main, write_example_config
        d = {str(tmp_path)!r}
        t = np.linspace(0, 2000, 501)
        rows = [np.stack([t, 1e17 * np.exp(-t / 400), 1e15 + 0 * t], 1)
                for _ in range(6)]
        np.savetxt(d + "/meas.csv", np.concatenate(rows), delimiter=",")
        flu = "Inputs/staub_MAPI_threepower_twothick_fluences.csv"
        main(["write-example", d + "/cfg.txt", "--fast", "--init-cond",
              flu, "--measurement", d + "/meas.csv", "--output",
              d + "/out"])
        write_example_config(d + "/traps.txt", model="traps", fast=True,
                             num_iters=10, init_cond=flu,
                             measurement=d + "/meas.csv",
                             output=d + "/out_t", checkpoint_freq=5)
        from metrotrpl_tpu_torch.config import (
            get_data, get_initpoints, read_config)
        from metrotrpl_tpu_torch.inference.likelihood import (
            build_likelihood_plan, make_eval_logll, resolve_solver_mode)
        from metrotrpl_tpu_torch.inference.moves import build_move_plan
        for cfg, model in (("/cfg.txt", "std"), ("/traps.txt", "traps")):
            sim, pi, flags, mc = read_config(d + cfg)
            ini = get_initpoints(mc["init_cond_path"], flags)
            data = get_data(mc["measurement_path"], flags, mc)
            hm, al = resolve_solver_mode(mc, 4.0)
            plan = build_likelihood_plan(sim, pi, mc, data, ini, hmax=hm,
                                         align_outputs=al,
                                         refactor_every=mc["refactor_every"])
            assert plan.fwd[0][1].nx == 128
            assert plan.fwd[0][1].model == model
            assert plan.fwd[0][2].solve_dtype == "float64"
            build_move_plan(pi, mc)
            make_eval_logll(plan, device="cpu")
        import torch
        from metrotrpl_tpu_torch.surrogate import NeuralNetwork
        rng = np.random.default_rng(1)
        net = NeuralNetwork()
        net.set_params([(rng.standard_normal((14, 8)) * 0.3, np.zeros(8)),
                        (rng.standard_normal((8, 4)) * 0.3, np.zeros(4))])
        scales = np.array([np.zeros(14), np.ones(14) * 20, np.zeros(4),
                           np.ones(4)], dtype=object)
        net.save_npz(d + "/w.npz")
        np.save(d + "/s.npy", scales, allow_pickle=True)
        sim, pi, flags, mc = read_config(d + "/cfg.txt")
        data = get_data(mc["measurement_path"], flags, mc)
        mc["solver"] = ("NN", d + "/w.npz", d + "/s.npy")
        plan = build_likelihood_plan(
            sim, pi, mc, data, get_initpoints(mc["init_cond_path"], flags))
        st = torch.tensor([[pi["init_guess"][n] for n in pi["names"]]],
                          dtype=torch.float64)
        one = torch.ones(1, dtype=torch.float64)
        assert plan.kind == "nn" and plan.fwd is None
        assert make_eval_logll(plan, device="cpu")(
            st, one)["per_meas"].shape == (1, 6, 1)
        main(["write-pa-example", d + "/pa.txt", "--init-cond",
              d + "/pa_ic.csv", "--measurement", d + "/pa_data.csv"])
        sim, pi, flags, mc = read_config(d + "/pa.txt")
        plan = build_likelihood_plan(
            sim, pi, mc, get_data(mc["measurement_path"], flags, mc),
            get_initpoints(mc["init_cond_path"], flags))
        assert plan.kind == "pa" and plan.fwd is None
        assert torch.isfinite(make_eval_logll(plan, device="cpu")(
            torch.tensor([[0.2]], dtype=torch.float64), one)["logll_T"]).all()
        assert sys.modules["jax"] is None
        assert sys.modules["metrotrpl_tpu"] is None
        assert not any(m.startswith(("jax.", "metrotrpl_tpu."))
                       or m == "jaxlib" for m in sys.modules)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_cuda_request_without_cuda_raises(monkeypatch):
    """device='cuda' never silently becomes the CPU."""
    import metrotrpl_tpu_torch as port
    from metrotrpl_tpu_torch.inference.metropolis import build_mh_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_mh_kernel(None, None, [1.0], [0.1], 10, False, device="cuda")
    assert port.resolve_device("cpu").type == "cpu"
    assert port.default_walk_dtype("cpu") == torch.float64
    assert port.default_walk_dtype("cuda") == torch.float32
