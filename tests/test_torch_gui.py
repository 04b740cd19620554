"""The port's GUI (metrotrpl_tpu_torch/gui): the counterparts of
tests/test_gui.py and tests/test_gui_widgets.py on the recording tkinter
stand-in (tests/tkstub.py), and quicksim's std solve against the JAX
package's at float64 and the oracle (its traps case, background manager
and default device: tests/test_torch_quicksim.py)."""

import os

import numpy as np
import pytest
from torch_parity import (
    TRAPS_TRUTH,
    assert_run_tasks_equal_jax,
    quicksim_tasks,
)

from metrotrpl_tpu.gui import secondary_parameters as jsp
from metrotrpl_tpu.io import ensemble as jens
from metrotrpl_tpu.oracle import solve_reference
from metrotrpl_tpu.oracle.scipy_reference import beer_lambert as bl
from metrotrpl_tpu.workloads import STAUB_TRUE
from metrotrpl_tpu_torch.gui import quicksim as tqs
from metrotrpl_tpu_torch.gui.plots import chain_diffusion, equilibration_index
from metrotrpl_tpu_torch.gui.secondary_parameters import (
    SecondaryParameters,
    hi_tau_srh,
    li_tau_eff,
    li_tau_srh,
)
from metrotrpl_tpu_torch.gui.window import (
    diffusion_report,
    export_histogram,
    export_traces,
    load_ensemble_chains,
)
from tests import tkstub

STAUB = dict(STAUB_TRUE)


# ---- secondary parameters (pinned reference values) ----

def test_secondary_parameters_pinned_values():
    """The port's li_tau_eff, li_tau_srh and hi_tau_srh at the reference
    suite's limits and pinned realism values (test_secondary_params.py)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        p = {"ks": np.zeros(1), "p0": 1, "tauN": np.full(1, np.inf),
             "Sf": np.ones(1), "Sb": 0, "Cp": np.zeros(1), "thickness": 1,
             "mu_n": np.full(1, np.inf), "mu_p": np.full(1, np.inf)}
        assert li_tau_eff(p)[0] == pytest.approx(100)
        p.update(Sf=np.full(1, np.inf), mu_n=np.ones(1), mu_p=np.ones(1))
        assert li_tau_eff(p)[0] == pytest.approx(3.9424585074839604e-05)
        p = {"ks": np.full(1, 4.8e-11), "p0": 3e15,
             "tauN": np.full(1, 511.0), "Sf": np.full(1, 10.0), "Sb": 10,
             "Cp": np.zeros(1), "thickness": 2000,
             "mu_n": np.full(1, 20.0), "mu_p": np.full(1, 20.0)}
        assert li_tau_eff(p)[0] == pytest.approx(454.36610893)
        assert li_tau_srh(p)[0] == pytest.approx(486.1759809086)
        p = {"tauN": 450.0, "tauP": 500.0, "Sf": np.zeros(1), "Sb": 0,
             "thickness": 1, "mu_n": np.zeros(1), "mu_p": np.zeros(1)}
        assert np.asarray(hi_tau_srh(p)).reshape(-1)[0] == \
            pytest.approx(950)
    p = {"tauN": np.full(1, 511.0), "tauP": np.full(1, 871.0),
         "Sf": np.full(1, 10), "Sb": 10, "thickness": 2000,
         "mu_n": np.full(1, 20.0), "mu_p": np.full(1, 20.0)}
    assert hi_tau_srh(p)[0] == pytest.approx(1292.807646, rel=1e-8)


def test_secondary_registry_equals_jax():
    """Every registered quantity of the port's registry equals the JAX
    package's on the same samples; the thickness and missing-key errors
    are the same."""
    rng = np.random.default_rng(5)
    base = {"ks": 4.8e-11, "p0": 3e15, "tauN": 511.0, "tauP": 871.0,
            "Sf": 10.0, "Sb": 10.0, "Cn": 4.4e-29, "Cp": 4.4e-29,
            "mu_n": 20.0, "mu_p": 20.0, "lambda": 0.1, "kC": 1e-10,
            "Nt": 1e14, "tauE": 200.0}
    mine = {n: v * 10 ** rng.uniform(-1, 1, 6) for n, v in base.items()}
    ref = {n: v.copy() for n, v in mine.items()}
    sp, jp = SecondaryParameters(), jsp.SecondaryParameters()
    assert list(sp.func) == list(jp.func)
    for name in sp.func:
        sp.get(mine, name, "311")
        jp.get(ref, name, "311")
        np.testing.assert_array_equal(mine[name], ref[name], err_msg=name)
        assert np.isfinite(mine[name]).all(), name
    with pytest.raises(ValueError):
        sp.get({k: np.ones(2) for k in ("Sf", "Sb", "mu_n", "mu_p",
                                         "tauN")}, "LI_tau_srh", "x")
    with pytest.raises(KeyError):
        sp.get({"ks": np.ones(1)}, "t_rad", "311")


# ---- the data layer on pickles of both packages ----

def _pa_inputs(out, num_iters):
    """pa toy problem (reference pa_toy_writer.py settings), 3 chains."""
    sim_info = {"lengths": [1], "nx": [1], "meas_types": ["pa"],
                "num_meas": 1}
    pi = {"names": ["x0"], "unit_conversions": {}, "do_log": {"x0": 0},
          "active": {"x0": 1}, "init_guess": {"x0": 0.2},
          "prior_dist": {"x0": (-2, 2)}, "trial_move": {"x0": 0.2}}
    mcmc = {"init_cond_path": "x", "measurement_path": "x",
            "output_path": str(out), "ini_mode": "density",
            "num_iters": num_iters, "solver": ("sdirk",), "model": "std",
            "model_uncertainty": 1, "log_y": 1, "hard_bounds": 1,
            "checkpoint_freq": num_iters,
            "parallel_tempering": [0.05, 0.3, 2.0], "temper_freq": 5,
            "load_checkpoint": None}
    e_data = ([np.array([0.0])], [np.array([0.0])], [np.array([1.0])])
    return sim_info, pi, mcmc, e_data, np.zeros((1, 1))


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    """A pickle the port's metro wrote (pa walk, 30 iterations, on the
    CPU) and one the JAX package's Ensemble wrote (a traps run's History,
    13 named parameters plus the trap ones)."""
    from metrotrpl_tpu_torch.inference.metropolis import metro

    d = tmp_path_factory.mktemp("gui_pickles")
    sim_info, pi, mcmc, e_data, ini = _pa_inputs(d / "port", 30)
    metro(sim_info, ini, e_data, mcmc, pi, export_path="final.pik", seed=4,
          device="cpu", trap_signals=False)
    names = list(TRAPS_TRUTH)
    jpi = {"names": names, "unit_conversions": {"p0": 1e-21},
           "do_log": {n: 1 for n in names},
           "active": {n: int(n not in ("n0", "eps", "Tm")) for n in names},
           "init_guess": dict(TRAPS_TRUTH),
           "prior_dist": {n: (0, np.inf) for n in names},
           "trial_move": {n: 0.01 for n in names}}
    jmc = {"output_path": str(d), "init_cond_path": "x",
           "measurement_path": "x", "checkpoint_freq": 5,
           "ini_mode": "fluence", "solver": ("sdirk",), "model": "traps",
           "num_iters": 12, "log_y": 1, "model_uncertainty": 0.05,
           "parallel_tempering": [1.0, 4.0]}
    ens = jens.Ensemble(jpi, {"lengths": [311.0], "nx": [8],
                              "meas_types": ["TRPL"], "num_meas": 1},
                        jmc, 12)
    base = np.array([TRAPS_TRUTH[n] for n in names])
    ens.H.states[:] = base[None, :, None] * 10 ** np.random.default_rng(
        2).uniform(-0.1, 0.1, ens.H.states.shape)
    ens.H.loglikelihood[:] = -np.arange(12.0)[None]
    jpath = str(d / "jax.pik")
    ens.checkpoint(jpath)
    return str(d / "port" / "final.pik"), jpath


def test_load_chains_and_exports_of_a_port_pickle(pickles, tmp_path):
    """A pickle the port wrote: chains, exports and the diffusion report,
    as tests/test_gui.py holds them for the JAX package."""
    chains, meta = load_ensemble_chains(pickles[0])
    assert len(chains) == 3 and meta["names"] == ["x0"]
    assert len(chains[0].data["x0"]) == 30 and "accept" in chains[0].data
    out = export_traces(str(tmp_path / "trace"), chains, "x0", burn=5)
    assert len(open(out).read().strip().splitlines()) == 26
    arr = np.load(export_traces(str(tmp_path / "trace.npy"), chains, "x0",
                                fmt="npy"))
    assert arr.shape == (3, 30)
    hist = export_histogram(str(tmp_path / "hist"),
                            np.abs(chains[0].data["x0"]) + 1.0, bins=16)
    assert len(open(hist).read().strip().splitlines()) == 17
    rep = diffusion_report(chains, meta)
    assert len(rep) == 3 and all(v >= 0 for v in rep.values())


def test_port_gui_loads_a_jax_pickle_like_the_jax_gui(pickles):
    """A pickle the JAX package wrote: the port's data layer gives the JAX
    GUI's chains, metadata and diffusion report."""
    from metrotrpl_tpu.gui import window as jwin
    from metrotrpl_tpu_torch.gui import window as twin

    mine, mmeta = twin.load_ensemble_chains(pickles[1])
    ref, rmeta = jwin.load_ensemble_chains(pickles[1])
    assert mmeta["names"] == rmeta["names"] == list(TRAPS_TRUTH)
    np.testing.assert_array_equal(mmeta["active"], rmeta["active"])
    assert len(mine) == len(ref) == 2
    for a, b in zip(mine, ref):
        assert a.data.keys() == b.data.keys()
        for k in a.data:
            np.testing.assert_array_equal(a.data[k], b.data[k])
    assert twin.diffusion_report(mine, mmeta) == \
        jwin.diffusion_report(ref, rmeta)


def test_equilibration_index_and_frozen_chain_diffusion():
    ll = np.concatenate([np.linspace(-1000, -10, 200), np.full(300, -10.0)])
    assert 100 < equilibration_index(ll) < 260
    assert chain_diffusion(np.zeros((3, 50)),
                           np.array([True, True, False])) == 0.0


# ---- quicksim (its traps case, manager and device: test_torch_quicksim) ----

@pytest.mark.parametrize("model", ["std"])
def test_run_tasks_equals_jax_run_tasks(model):
    """run_tasks(device="cpu") at float64 and nx=16 against the JAX
    package's (torch_parity.assert_run_tasks_equal_jax)."""
    assert_run_tasks_equal_jax(model)


def test_run_tasks_matches_the_oracle():
    """The std task against the LSODA oracle (|d log10| < 1e-4, as
    tests/test_gui.py holds the JAX quicksim)."""
    task = quicksim_tasks(tqs, "std", 24)[0]
    (t, sol), = tqs.run_tasks([task], device="cpu")
    pm = {k: v * tqs.DEFAULT_UNITS.get(k, 1) for k, v in STAUB.items()}
    dx = 311 / 24
    x = np.linspace(dx / 2, 311 - dx / 2, 24)
    ref = solve_reference(bl(2.12e11 * 1e-14, 6e4 * 1e-7, x), 311, 24, t,
                          pm)
    assert np.abs(np.log10(sol) - np.log10(ref)).max() < 1e-4
    with pytest.raises(NotImplementedError):
        tqs.run_tasks(quicksim_tasks(tqs, "std", 8)[:1] + quicksim_tasks(tqs, "std", 16),
                      device="cpu")
    assert tqs.run_tasks([], device="cpu") == []


def test_quicksim_settings_roundtrip(tmp_path):
    from metrotrpl_tpu_torch.gui.popups import (
        EXT_DEFAULTS,
        load_ext_vars,
        save_ext_vars,
    )

    path = str(tmp_path / "qs.txt")
    save_ext_vars(dict(EXT_DEFAULTS, thickness=2000, nt=750), path)
    back = load_ext_vars(path)
    assert back["thickness"] == 2000 and back["nt"] == 750
    assert back["fluence"] == EXT_DEFAULTS["fluence"]
    assert EXT_DEFAULTS["nx"] == 128


def test_gui_styles_palette():
    import re

    from metrotrpl_tpu_torch.gui import styles

    for c in (styles.WHITE, styles.LIGHT_GREY, styles.GREY,
              styles.DARK_GREY, styles.BLACK, styles.RED, styles.GREEN):
        assert re.fullmatch(r"#[0-9a-f]{6}", c)
    assert styles.LIGHT_GREY == "#bfbfbf"
    assert styles.LABEL_KWARGS == {"width": 14,
                                   "background": styles.LIGHT_GREY}
    cycle = styles.plot_color_cycle()
    assert len(cycle) >= 6 and all(c.startswith("#") for c in cycle)


# ---- the widget layer on the tkinter stand-in ----

@pytest.fixture
def win(monkeypatch, tmp_path, pickles):
    _, fd = tkstub.install(monkeypatch)
    from metrotrpl_tpu_torch.gui.window import Window

    w = Window(device="cpu")
    w.loadfile(pickles[0])
    return w, fd, tmp_path


def _button(root, label):
    found = []

    def walk(widget):
        for c in getattr(widget, "children", []):
            if c.kw.get("text") == label:
                found.append(c)
            walk(c)
    walk(root)
    assert found, f"no button labeled {label!r}"
    return found[0]


def test_window_constructs_loads_and_draws(win):
    w, _, _ = win
    assert w.device == "cpu"
    assert w.chain_list.size() == 3 and w.xparam.get() == "x0"
    labels = [e[1] for e in w.xmenu["menu"].entries]
    assert "x0" in labels and "log likelihood" in labels and "t_rad" in labels
    assert "loaded 3 chains" in w.status.get()
    w.log_var.set(0)   # pa samples are signed
    for mode in w.PLOT_MODES:
        w.mode_var.set(mode)
        w.yparam.set("log likelihood")
        w.draw()
    w.combined_var.set(1)
    w.mode_var.set("1D Histogram")
    w.draw()
    _button(w.root, "auto").invoke()
    assert "auto burn-in" in w.status.get()


def test_window_loads_a_jax_pickle_after_a_port_one(win, pickles):
    """A different parameter set clears the session; the JAX pickle's
    chains then load."""
    w, _, _ = win
    w.loadfile(pickles[1])
    assert w.chain_list.size() == 2
    assert "previous chains cleared" in w.status.get()
    assert w.xparam.get() == "p0"


def test_export_buttons(win, tmp_path):
    from metrotrpl_tpu_torch.gui.window import export_all

    w, fd, tmp = win
    for i, mode in enumerate(w.PLOT_MODES):
        w.mode_var.set(mode)
        w.yparam.set("x0")
        out = str(tmp / f"exp{i}.csv")
        fd.next_answers.append(out)
        _button(w.root, "Export plotted...").invoke()
        assert os.path.exists(out) and "exported" in w.status.get(), mode
    w.burn_var.set("5")
    _button(w.root, "Export all (per-chain CSVs)").invoke()
    assert "Export complete" in w.status.get()
    out_dir = w.status.get().split(" - ")[1]
    files = sorted(os.listdir(out_dir))
    assert len(files) == 3
    arr = np.loadtxt(os.path.join(out_dir, files[0]), delimiter=",")
    assert arr.shape[1] == 2 and arr[0, 0] == 5
    d = tmp_path / "export-fixed"
    d.mkdir()
    (d / "junk.txt").write_text("x")
    with pytest.raises(FileExistsError):
        export_all(w.chains, w.meta, out_parent=str(tmp_path), tstamp="fixed")


def test_export_trace2d_and_histogram2d(tmp_path):
    from metrotrpl_tpu_torch.gui.window import (
        export_histogram2d,
        export_trace2d,
    )

    xs, ys = np.linspace(1, 2, 50), np.linspace(3, 4, 50)
    arr = np.loadtxt(export_trace2d(str(tmp_path / "t2d"), xs, ys, burn=10),
                     delimiter=",")
    assert arr.shape == (40, 3) and arr[0, 0] == 10
    mat = np.loadtxt(export_histogram2d(str(tmp_path / "h2d"), xs, ys,
                                        bins=8), delimiter=",")
    assert mat.shape == (9, 9) and mat[1:, 1:].sum() == 50
    assert np.all(np.diff(mat[1:, 0]) > 0)


def test_activate_chain_popup(win):
    from metrotrpl_tpu_torch.gui.popups import ActivateChainPopup

    w, _, _ = win
    pop = ActivateChainPopup(w)
    assert len(pop.flags) == 3
    pop.flags[1].set(0)
    pop.apply()
    assert w.chain_list.curselection() == (0, 2)
    assert len(w._selected_chains()) == 2


def test_quicksim_entry_popup_builds_tasks_and_launches_on_the_window_device(
        win, monkeypatch):
    """Settings save and load; build_tasks makes one task per chain at the
    entered variables; launch hands the window's device to the manager."""
    from metrotrpl_tpu_torch.gui import popups

    w, fd, tmp = win
    pop = popups.QuicksimEntryPopup(w)
    pop.vars["thickness"].set("1234")
    path = str(tmp / "keybind.txt")
    fd.next_answers.append(path)
    pop.save_settings()
    pop.vars["thickness"].set("1")
    fd.next_answers.append(path)
    pop.load_settings()
    assert float(pop.vars["thickness"].get()) == 1234
    tasks = pop.build_tasks()
    assert len(tasks) == 3 and tasks[0].thickness == 1234
    assert tasks[0].nt == popups.EXT_DEFAULTS["nt"]

    made = []

    class Recorder:
        def __init__(self, device="cuda"):
            made.append(device)

        def simulate(self, tasks, scale_factors=None, units=None):
            self.tasks = tasks

        def poll(self):
            return [], True

        def join(self, timeout=None):
            pass

    monkeypatch.setattr(popups, "QuicksimManager", Recorder)
    pop.launch()
    assert made == ["cpu"]


def test_figure_clickmenu_save_and_copy(win, tmp_path):
    w, _, _ = win
    assert [e[1] for e in w.clickmenu.menu.entries] == [
        "Copy", "Save as PNG", "Save as SVG"]
    out = w.clickmenu.save_fig("png", fname=str(tmp_path / "fig"))
    assert out.endswith(".png") and os.path.getsize(out) > 0
    assert w.clickmenu.figure_png_bytes(dpi=72)[:4] == b"\x89PNG"
    from metrotrpl_tpu_torch.gui.rclickmenu import _clipboard_backend
    if _clipboard_backend() is None:
        with pytest.raises(NotImplementedError):
            w.clickmenu.copy_fig()


def test_quicksim_result_popup_scales_overlay_and_export(win):
    """Per-sim scale factors prepopulated from the chains' fitted _s
    factors, visibility toggles, the measurement overlay and the scaled
    CSV export (reference quicksim_result_popup.py:141-183)."""
    from metrotrpl_tpu_torch.gui.popups import QuicksimResultPopup

    w, _, tmp = win
    chains = w._selected_chains()[:2]
    chains[0].data["_s0"] = np.array([2.5, 3.0])
    t = np.linspace(0, 10, 11)
    y0, y1 = np.exp(-t), 2 * np.exp(-t)

    class FakeQS:
        fired = False

        def poll(self):
            if self.fired:
                return [], True
            self.fired = True
            return [(0, t, y0, ""), (1, t, y1, "")], True

        def join(self, timeout=None):
            pass

    task = tqs.QuicksimTask(thickness=311, nx=16, final_time=10, nt=11,
                            fluence=1e11, absp=6e4, direction=1, params={})
    pop = QuicksimResultPopup(w, FakeQS(), [task, task], chains=chains)
    assert float(pop.scale_vars[0].get()) == 3.0
    assert float(pop.scale_vars[1].get()) == 1.0
    pop.top.run_after()
    csv = str(tmp / "meas.csv")
    np.savetxt(csv, np.stack([t, 5 * np.exp(-t), 0.1 * np.ones(11)], 1),
               delimiter=",")
    pop.load_data(csv)
    pop.scale_vars[0].set("2.0")
    pop.scale_vars[1].set("0.5")
    pop.redraw()
    lines = pop.ax.get_lines()
    assert len(lines) == 2 and len(pop.ax.collections) == 1
    np.testing.assert_allclose(lines[0].get_ydata(), 2.0 * y0)
    np.testing.assert_allclose(lines[1].get_ydata(), 0.5 * y1)
    pop.vis_vars[1].set(0)
    pop.redraw()
    assert len(pop.ax.get_lines()) == 1
    arr = np.loadtxt(pop.export_sims(str(tmp / "sims.csv")), delimiter=",")
    assert arr.shape == (11, 4)
    np.testing.assert_allclose(arr[:, 1], 2.0 * y0)
    np.testing.assert_allclose(arr[:, 3], 0.5 * y1)


def test_history_shapes_truncate_extend():
    """The port's History contract (reference test_sim_utils_History.py),
    dtypes kept through extend."""
    from metrotrpl_tpu_torch.io.ensemble import History

    H = History(2, 10, ["a", "b", "c"])
    dts = (H.accept.dtype, H.loglikelihood.dtype, H.states.dtype)
    assert H.states.shape == (2, 3, 10) and H.accept.shape == (2, 10)
    H.truncate(4)
    assert H.states.shape == (2, 3, 4)
    H.extend(12)
    assert H.states.shape == (2, 3, 12) and H.loglikelihood.shape == (2, 12)
    H.extend(6)
    assert H.accept.shape == (2, 6)
    assert (H.accept.dtype, H.loglikelihood.dtype, H.states.dtype) == dts
    H.update(["a", "b", "c"])
    assert H.mean_b.shape == (2, 6)
