"""Dialog popups (reference GUI/popup.py, quicksim_entry_popup.py,
quicksim_result_popup.py, activate_chain_popup.py equivalents)."""

import numpy as np

from metrotrpl_tpu_torch.gui.plots import sim_plot
from metrotrpl_tpu_torch.gui.quicksim import QuicksimManager, QuicksimTask

# the reference's quicksim "external variables"
# (GUI/quicksim_entry_popup.py keybind set)
EXT_VARS = ("thickness", "nx", "final_time", "nt", "fluence", "absp",
            "direction")
EXT_DEFAULTS = {"thickness": 311, "nx": 128, "final_time": 2000, "nt": 500,
                "fluence": 2.12e11, "absp": 6e4, "direction": 1}


class Popup:
    """Base modal popup."""

    def __init__(self, parent, title):
        import tkinter as tk

        from metrotrpl_tpu_torch.gui.styles import LIGHT_GREY

        self.tk = tk
        self.parent = parent
        self.top = tk.Toplevel(parent.root)
        self.top.title(title)
        # standard popup background (reference GUI/popup.py:15)
        self.top.configure(background=LIGHT_GREY)


def save_ext_vars(values, path):
    """Persist quicksim external variables to a keybind-style text file
    (reference quicksim_entry_popup.py:264-313 save/load feature)."""
    with open(path, "w") as f:
        for name in EXT_VARS:
            f.write(f"{name}: {values[name]}\n")


def load_ext_vars(path):
    values = dict(EXT_DEFAULTS)
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            k = k.strip()
            if k in values:
                values[k] = float(v.strip())
    return values


class QuicksimEntryPopup(Popup):
    """Collect external sim variables and launch the quicksim process
    against the mean posterior state of each selected chain."""

    def __init__(self, parent):
        super().__init__(parent, "Quicksim")
        tk = self.tk
        self.vars = {}
        for i, name in enumerate(EXT_VARS):
            tk.Label(self.top, text=name).grid(row=i, column=0, sticky="w")
            v = tk.StringVar(value=str(EXT_DEFAULTS[name]))
            tk.Entry(self.top, textvariable=v).grid(row=i, column=1)
            self.vars[name] = v
        row = len(EXT_VARS)
        tk.Button(self.top, text="Simulate",
                  command=self.launch).grid(row=row, column=0)
        tk.Button(self.top, text="Save...",
                  command=self.save_settings).grid(row=row, column=1)
        tk.Button(self.top, text="Load...",
                  command=self.load_settings).grid(row=row + 1, column=1)

    def save_settings(self):
        from tkinter import filedialog
        path = filedialog.asksaveasfilename(defaultextension=".txt")
        if path:
            save_ext_vars({k: v.get() for k, v in self.vars.items()}, path)

    def load_settings(self):
        from tkinter import filedialog
        path = filedialog.askopenfilename()
        if path:
            for k, v in load_ext_vars(path).items():
                self.vars[k].set(str(v))

    def build_tasks(self, burn=0):
        if self.parent.meta is None:
            raise RuntimeError(
                "Load an output file before running quicksim")
        ext = {k: float(v.get()) for k, v in self.vars.items()}
        # Re-simulate with the MODEL the posterior was fit with (a traps
        # run silently re-simulated as std would ignore kC/Nt/tauE)
        ef = self.parent.meta["ensemble"].ensemble_fields
        model = ef.get("model", "std")
        tasks = []
        for c in self.parent._selected_chains():
            params = {
                p: float(np.mean(np.asarray(c.data[p])[burn:]))
                for p in self.parent.meta["names"] if not p.startswith("_")}
            tasks.append(QuicksimTask(
                thickness=ext["thickness"], nx=int(ext["nx"]),
                final_time=ext["final_time"], nt=int(ext["nt"]),
                fluence=ext["fluence"], absp=ext["absp"],
                direction=ext["direction"], params=params, model=model))
        return tasks

    def _run_units(self):
        """The run's own unit-conversion table (ensemble_fields['units']),
        not the default staub vocabulary."""
        ef = self.parent.meta["ensemble"].ensemble_fields
        names = self.parent.meta["names"]
        units = ef.get("units")
        if units is None:
            return None
        return {n: float(u) for n, u in zip(names, units)}

    def launch(self):
        burn = int(float(self.parent.burn_var.get() or 0))
        tasks = self.build_tasks(burn)
        qs = QuicksimManager(device=self.parent.device)
        qs.simulate(tasks, units=self._run_units())
        QuicksimResultPopup(self.parent, qs, tasks,
                            chains=self.parent._selected_chains())
        self.top.destroy()


class QuicksimResultPopup(Popup):
    """Poll the quicksim queue with tk.after and overlay results
    (reference GUI/window.py:171-208 poll pattern) with the reference
    result-popup feature set (quicksim_result_popup.py:55-280):
    PER-SIMULATION scale-factor entries prepopulated from each chain's
    fitted ``_s{i}`` factors, per-sim visibility toggles, measurement-data
    overlay (Load, gray scatter), and scaled CSV export (Export sims).

    tasks are chain-major (reference group_results_by_chain convention):
    result index j maps to chain j // n_sims, sim j % n_sims."""

    def __init__(self, parent, qs, tasks, chains=None):
        super().__init__(parent, "Quicksim results")
        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
        from matplotlib.figure import Figure

        tk = self.tk
        self.qs = qs
        self.tasks = tasks
        self.chains = list(chains or [])
        self.n_sims = (len(tasks) // len(self.chains) if self.chains
                       else len(tasks))
        self.results = []
        self.exp_data = []
        self.fig = Figure(figsize=(6, 5), dpi=100)
        self.ax = self.fig.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.fig, master=self.top)
        self.canvas.get_tk_widget().pack(fill=tk.BOTH, expand=True)

        # per-simulation scale factor + visibility grid
        # (reference draw_s_frame, quicksim_result_popup.py:144-183)
        grid = tk.Frame(self.top)
        grid.pack()
        self.scale_vars = []
        self.vis_vars = []
        for j, task in enumerate(self.tasks):
            tk.Label(grid, text=self._row_label(j)).grid(
                row=j, column=0, sticky="w")
            v = tk.IntVar(value=1)
            tk.Checkbutton(grid, variable=v,
                           command=self.redraw).grid(row=j, column=1)
            s = tk.StringVar(value="1.0")
            tk.Entry(grid, textvariable=s, width=10).grid(row=j, column=2)
            self.vis_vars.append(v)
            self.scale_vars.append(s)
        self.populate_scale_factors()

        row = tk.Frame(self.top)
        row.pack()
        tk.Button(row, text="redraw", command=self.redraw).pack(side=tk.LEFT)
        tk.Button(row, text="Load data...",
                  command=self.load_data).pack(side=tk.LEFT)
        tk.Button(row, text="Export sims...",
                  command=self.export_sims).pack(side=tk.LEFT)
        self.top.after(500, self.poll)

    def _row_label(self, j):
        if not self.chains:
            return f"sim {j}"
        c, i = divmod(j, self.n_sims)
        return f"{self.chains[c].label} sim {i}"

    def populate_scale_factors(self):
        """Prepopulate each entry from the originating chain's FITTED
        scale factor: the last walked ``_s{i}`` state (reference
        populate_scale_factors, quicksim_result_popup.py:176-183;
        1.0 when the run fitted no scale factors)."""
        for j in range(len(self.tasks)):
            if not self.chains:
                break
            c, i = divmod(j, self.n_sims)
            data = self.chains[c].data
            if f"_s{i}" in data:
                val = float(np.asarray(data[f"_s{i}"]).ravel()[-1])
                self.scale_vars[j].set(f"{val:.2e}")

    def load_data(self, path=None):
        """Overlay a measurement CSV (the MCMC input format) for visual
        comparison (reference load_exp_data, quicksim_result_popup.py:
        196-223; linear y — quicksim curves are not log-transformed)."""
        from metrotrpl_tpu_torch.config.data_io import get_data

        if path is None:
            from tkinter import filedialog
            path = filedialog.askopenfilename(
                filetypes=[("CSV File", "*.csv")],
                title="Select Measurement Data")
        if not path:
            return
        ic_flags = {"time_cutoff": None, "select_obs_sets": None}
        exp = get_data(path, ic_flags, {"log_y": False})
        self.exp_data = list(zip(exp[0], exp[1]))
        self.redraw()

    def export_sims(self, path=None):
        """Scaled-sims CSV export (reference export_sims,
        quicksim_result_popup.py:225-256: time/y column pair per sim,
        ragged rows padded with -1)."""
        import itertools

        if path is None:
            from tkinter import filedialog
            path = filedialog.asksaveasfilename(
                filetypes=[("CSV file", "*.csv")], defaultextension=".csv",
                title="Export sims")
        if not path:
            return
        cols, header = [], []
        for idx, t, s in sorted(self.results):
            cols.append(t)
            cols.append(s * self._scale(idx))
            header.append(f"{self._row_label(idx)} - time")
            header.append(f"{self._row_label(idx)} - y")
        rows = np.array(list(map(list,
                                 itertools.zip_longest(*cols,
                                                       fillvalue=-1))))
        np.savetxt(path, rows, header=",".join(header), delimiter=",")
        return path

    def poll(self):
        items, done = self.qs.poll()
        for idx, t, s, msg in items:
            if idx >= 0:
                self.results.append((idx, t, s))
            else:
                print(msg)
        if items:
            self.redraw()
        if not done:
            self.top.after(500, self.poll)
        else:
            self.qs.join()

    def _scale(self, idx):
        try:
            return float(self.scale_vars[idx].get())
        except (ValueError, IndexError):
            return 1.0

    def redraw(self):
        self.ax.clear()
        for t, y in self.exp_data:
            self.ax.scatter(t, y, s=2, color="gray", zorder=0)
        for idx, t, s in self.results:
            if not self.vis_vars[idx].get():
                continue
            sim_plot(self.ax, t, s * self._scale(idx),
                     label=self._row_label(idx))
        self.canvas.draw()


class ActivateChainPopup(Popup):
    """Toggle which chains are plotted (reference
    activate_chain_popup.py)."""

    def __init__(self, parent):
        super().__init__(parent, "Chains")
        tk = self.tk
        self.flags = []
        for i, c in enumerate(parent.chains):
            v = tk.IntVar(value=1)
            tk.Checkbutton(self.top, text=c.label, variable=v).pack(
                anchor="w")
            self.flags.append(v)
        tk.Button(self.top, text="Apply", command=self.apply).pack()

    def apply(self):
        lb = self.parent.chain_list
        lb.selection_clear(0, self.tk.END)
        for i, v in enumerate(self.flags):
            if v.get():
                lb.selection_set(i)
        self.top.destroy()
