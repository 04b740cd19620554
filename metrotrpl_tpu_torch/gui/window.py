"""Main posterior-visualization window (reference GUI/window.py equivalent).

Separation of concerns: everything data-shaped (loading, per-chain sample
dicts, export, diagnostics) is module-level and headless-testable; the
``Window`` class is a thin tkinter/matplotlib shell over it.
"""

import csv
import os

import numpy as np

from metrotrpl_tpu_torch.gui.plots import (
    chain_diffusion,
    equilibration_index,
    histogram_1d,
    histogram_2d,
    sim_plot,
    traceplot_1d,
    traceplot_2d,
)
from metrotrpl_tpu_torch.gui.secondary_parameters import SecondaryParameters
from metrotrpl_tpu_torch.io.ensemble import load_checkpoint

ACC_BIN_SIZE = 100  # acceptance-rate binning (reference GUI/window.py)


class ChainData:
    """Per-chain posterior record: param name -> sample array, plus
    'log likelihood' and binned 'accept' (reference Chain contract,
    GUI/window.py:45-59, 274-313)."""

    def __init__(self, fname, chain_index, data):
        self.fname = fname
        self.chain_index = chain_index
        self.data = data

    @property
    def label(self):
        return f"{os.path.basename(self.fname)}#{self.chain_index}"


def load_ensemble_chains(fname):
    """Load a pickled Ensemble (ours or the reference's) into ChainData
    objects."""
    ens = load_checkpoint(fname)
    names = ens.ensemble_fields["names"]
    states = ens.H.states
    logll = ens.H.loglikelihood
    accept = ens.H.accept
    chains = []
    for m in range(states.shape[0]):
        data = {p: states[m, i] for i, p in enumerate(names)}
        data["log likelihood"] = logll[m]
        n_bins = max(len(accept[m]) // ACC_BIN_SIZE, 1)
        usable = n_bins * ACC_BIN_SIZE
        binned = accept[m][:usable].reshape(n_bins, -1).mean(axis=1) \
            if usable else np.array([accept[m].mean()])
        data["accept"] = binned
        chains.append(ChainData(fname, m, data))
    meta = {
        "names": names,
        "active": np.asarray(ens.ensemble_fields.get(
            "active", np.ones(len(names), dtype=bool))),
        "do_log": np.asarray(ens.ensemble_fields.get(
            "do_log", np.ones(len(names), dtype=bool))),
        "ensemble": ens,
    }
    return chains, meta


def export_traces(path, chains, param, fmt="csv", burn=0, samples_fn=None):
    """Export one parameter's samples for all chains (reference
    GUI/window.py:586-873 export feature).

    samples_fn : optional chain -> samples callable (burn already
    applied) — lets the Window route secondary parameters through its
    computing accessor rather than raw chain.data."""
    if samples_fn is not None:
        cols = {c.label: np.asarray(samples_fn(c)) for c in chains}
    else:
        cols = {c.label: np.asarray(c.data[param])[burn:] for c in chains}
    if fmt == "npy":
        np.save(path, np.stack(list(cols.values())))
        return path
    if not path.endswith(".csv"):
        path += ".csv"
    n = max(len(v) for v in cols.values())
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(cols))
        for i in range(n):
            w.writerow([cols[k][i] if i < len(cols[k]) else ""
                        for k in cols])
    return path


def export_histogram(path, samples, bins=96, logscale=True):
    """Export (bin_center, density) rows of a marginal histogram."""
    samples = np.asarray(samples, dtype=float)
    pos = samples[samples > 0]
    if logscale and len(pos):
        samples = pos
        edges = np.logspace(np.log10(samples.min()),
                            np.log10(samples.max()), bins + 1)
    else:
        # linear fallback covers all-nonpositive data (e.g. log
        # likelihood) that log bins cannot represent
        edges = np.linspace(samples.min(), samples.max(), bins + 1)
    dens, edges = np.histogram(samples, bins=edges, density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    if not path.endswith(".csv"):
        path += ".csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["bin_center", "density"])
        w.writerows(zip(centers, dens))
    return path


def export_all(chains, meta, burn=0, out_parent=None, tstamp=None):
    """Export every model parameter of every chain to per-chain CSVs in a
    fresh ``export-<timestamp>`` directory (reference "all" export,
    GUI/window.py:586-636): columns Index + log10(param), one file per
    chain. Returns the directory path."""
    import datetime

    if not chains:
        raise ValueError("no chains loaded")
    if out_parent is None:
        out_parent = os.path.dirname(chains[0].fname)
    if tstamp is None:
        tstamp = str(datetime.datetime.now()).replace(":", "-")
    out_dir = os.path.join(out_parent, f"export-{tstamp}")
    os.makedirs(out_dir, exist_ok=True)
    if os.listdir(out_dir):
        raise FileExistsError(f"dir {out_dir} must be empty")

    names = meta["names"]
    for c in chains:
        cols = [np.arange(len(np.asarray(c.data[names[0]])[burn:])) + burn]
        header = ["Index"]
        for p in names:
            # signed params (e.g. the pa toy coordinate) yield NaN columns,
            # same as the reference's unconditional log10 export
            with np.errstate(divide="ignore", invalid="ignore"):
                cols.append(np.log10(np.asarray(c.data[p])[burn:]))
            header.append(p)
        np.savetxt(os.path.join(out_dir, f"{c.label}.csv"),
                   np.stack(cols).T, delimiter=",",
                   header=",".join(header))
    return out_dir


def export_trace2d(path, xs, ys, burn=0, fmt="csv"):
    """Export paired samples as (N, x, y) rows (reference 2D Trace export,
    GUI/window.py:716-753)."""
    xs = np.asarray(xs)[burn:]
    ys = np.asarray(ys)[burn:]
    data = np.vstack((np.arange(len(xs)) + burn, xs, ys)).T
    if fmt == "npy":
        np.save(path, data)
        return path
    if not path.endswith(".csv"):
        path += ".csv"
    np.savetxt(path, data, delimiter=",", header="N,x,y")
    return path


def export_histogram2d(path, xs, ys, bins=96, fmt="csv"):
    """Export a 2D histogram as a (bins+1, bins+1) matrix whose first
    row/column hold the bin centers (reference 2D Histogram export,
    GUI/window.py:825-873)."""
    xs, ys = np.asarray(xs, dtype=float), np.asarray(ys, dtype=float)
    freq, bx, by = np.histogram2d(xs, ys, bins)
    cx = 0.5 * (bx[1:] + bx[:-1])
    cy = 0.5 * (by[1:] + by[:-1])
    mat = np.zeros((len(cx) + 1, len(cy) + 1))
    mat[0, 1:] = cy
    mat[1:, 0] = cx
    mat[1:, 1:] = freq
    if fmt == "npy":
        np.save(path, mat)
        return path
    if not path.endswith(".csv"):
        path += ".csv"
    np.savetxt(path, mat, delimiter=",")
    return path


def diffusion_report(chains, meta):
    """Chain-diffusion diagnostic per chain (log10 displacement metric)."""
    out = {}
    names = meta["names"]
    active = meta["active"]
    for c in chains:
        st = np.stack([np.asarray(c.data[p], dtype=float) for p in names])
        with np.errstate(divide="ignore"):
            st = np.where(st > 0, np.log10(np.maximum(st, 1e-300)), st)
        out[c.label] = chain_diffusion(st, active)
    return out


class Window:
    """tkinter shell: file loading, chain toggles, plot modes, burn-in,
    export, quicksim.

    device : where quicksim solves ("cuda", the default, or "cpu");
        asking for the card where there is none raises here."""

    PLOT_MODES = ("1D Trace Plot", "2D Trace Plot",
                  "1D Histogram", "2D Histogram")

    def __init__(self, width=1100, height=800, master=None, device="cuda"):
        import tkinter as tk
        from matplotlib.backends.backend_tkagg import (
            FigureCanvasTkAgg,
            NavigationToolbar2Tk,
        )
        from matplotlib.figure import Figure

        from metrotrpl_tpu_torch import resolve_device
        from metrotrpl_tpu_torch.gui.styles import PANEL_KWARGS

        self.device = str(resolve_device(device))
        self.tk = tk
        self.root = master or tk.Tk()
        self.root.title("metrotrpl_tpu_torch — posterior viewer")
        self.root.geometry(f"{width}x{height}")
        self.root.configure(**PANEL_KWARGS)
        self.chains = []
        self.meta = None
        self.sp = SecondaryParameters()
        self.qs = None

        side = tk.Frame(self.root)
        side.pack(side=tk.LEFT, fill=tk.Y, padx=4, pady=4)

        tk.Button(side, text="Load pickle(s)...",
                  command=self._on_load).pack(fill=tk.X)
        self.chain_list = tk.Listbox(side, selectmode=tk.MULTIPLE, height=8,
                                     exportselection=False)
        self.chain_list.pack(fill=tk.X, pady=2)

        self.mode_var = tk.StringVar(value=self.PLOT_MODES[0])
        tk.OptionMenu(side, self.mode_var, *self.PLOT_MODES).pack(fill=tk.X)
        tk.Label(side, text="X parameter").pack(anchor="w")
        self.xparam = tk.StringVar()
        self.xmenu = tk.OptionMenu(side, self.xparam, "")
        self.xmenu.pack(fill=tk.X)
        tk.Label(side, text="Y parameter (2D)").pack(anchor="w")
        self.yparam = tk.StringVar()
        self.ymenu = tk.OptionMenu(side, self.yparam, "")
        self.ymenu.pack(fill=tk.X)

        row = tk.Frame(side)
        row.pack(fill=tk.X)
        tk.Label(row, text="Burn-in").pack(side=tk.LEFT)
        self.burn_var = tk.StringVar(value="0")
        tk.Entry(row, textvariable=self.burn_var, width=8).pack(side=tk.LEFT)
        tk.Button(row, text="auto", command=self._auto_burn).pack(side=tk.LEFT)

        row2 = tk.Frame(side)
        row2.pack(fill=tk.X)
        tk.Label(row2, text="Bins").pack(side=tk.LEFT)
        self.bins_var = tk.StringVar(value="96")
        tk.Entry(row2, textvariable=self.bins_var, width=6).pack(side=tk.LEFT)
        self.log_var = tk.IntVar(value=1)
        tk.Checkbutton(row2, text="log", variable=self.log_var).pack(
            side=tk.LEFT)
        self.combined_var = tk.IntVar(value=0)
        tk.Checkbutton(side, text="combine chains",
                       variable=self.combined_var).pack(anchor="w")

        tk.Label(side, text="Thickness (nm, for derived)").pack(anchor="w")
        self.thickness_var = tk.StringVar(value="311")
        tk.Entry(side, textvariable=self.thickness_var).pack(fill=tk.X)

        tk.Button(side, text="Draw", command=self.draw).pack(fill=tk.X,
                                                             pady=4)
        tk.Button(side, text="Export plotted...",
                  command=self._on_export).pack(fill=tk.X)
        tk.Button(side, text="Export all (per-chain CSVs)",
                  command=self._on_export_all).pack(fill=tk.X)
        tk.Button(side, text="Toggle chains...",
                  command=self._on_activate_chains).pack(fill=tk.X)
        tk.Button(side, text="Chain diffusion",
                  command=self._on_diffusion).pack(fill=tk.X)
        tk.Button(side, text="Quicksim...",
                  command=self._on_quicksim).pack(fill=tk.X)
        self.status = tk.StringVar(value="no data")
        tk.Label(side, textvariable=self.status, wraplength=200,
                 justify="left").pack(fill=tk.X, pady=4)

        self.fig = Figure(figsize=(7, 6), dpi=100)
        self.ax = self.fig.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.fig, master=self.root)
        widget = self.canvas.get_tk_widget()
        widget.pack(side=tk.RIGHT, fill=tk.BOTH, expand=True)
        NavigationToolbar2Tk(self.canvas, self.root, pack_toolbar=True)

        # right-click copy/save menu on the chart (reference
        # GUI/rclickmenu.py FigureClickmenu)
        from metrotrpl_tpu_torch.gui.rclickmenu import CLICK_EVENTS, FigureClickmenu
        self.clickmenu = FigureClickmenu(self, self.root, self.canvas,
                                         widget)
        widget.bind(CLICK_EVENTS["click"]["right"], self.clickmenu.show)

    def set_status(self, text):
        self.status.set(text)

    # ---- actions --------------------------------------------------------
    def loadfile(self, fname):
        chains, meta = load_ensemble_chains(fname)
        cleared = False
        if (self.meta is not None
                and list(meta["names"]) != list(self.meta["names"])):
            # chains accumulate across loadfile calls but meta is
            # per-file; a different parameter set cannot be co-plotted,
            # so start a fresh session instead of mixing
            self.chains.clear()
            self.chain_list.delete(0, self.tk.END)
            cleared = True
        self.chains.extend(chains)
        self.meta = meta
        for c in chains:
            self.chain_list.insert(self.tk.END, c.label)
        options = (list(meta["names"]) + ["log likelihood", "accept"]
                   + list(self.sp.func))
        for menu_widget, var in ((self.xmenu, self.xparam),
                                 (self.ymenu, self.yparam)):
            menu = menu_widget["menu"]
            menu.delete(0, "end")
            for o in options:
                menu.add_command(
                    label=o, command=self.tk._setit(var, o))
        self.xparam.set(meta["names"][1] if len(meta["names"]) > 1
                        else meta["names"][0])
        self.yparam.set(meta["names"][0])
        note = (" (parameter set changed; previous chains cleared)"
                if cleared else "")
        self.status.set(f"loaded {len(chains)} chains from "
                        f"{os.path.basename(fname)}{note}")

    def _selected_chains(self):
        sel = self.chain_list.curselection()
        return [self.chains[i] for i in sel] if sel else self.chains

    def _samples(self, chain, param, burn):
        data = dict(chain.data)
        if param in self.sp.func and param not in data:
            self.sp.get(data, param, self.thickness_var.get())
        return np.asarray(data[param])[burn:]

    def draw(self):
        mode = self.mode_var.get()
        burn = int(float(self.burn_var.get() or 0))
        bins = int(self.bins_var.get() or 96)
        scale = "log" if self.log_var.get() else "linear"
        xp, yp = self.xparam.get(), self.yparam.get()
        self.ax.clear()
        chains = self._selected_chains()
        if not chains:
            self.status.set("no chains loaded")
            return
        if mode == "1D Trace Plot":
            for c in chains:
                traceplot_1d(self.ax, self._samples(c, xp, burn), xp,
                             scale=scale)
        elif mode == "2D Trace Plot":
            for c in chains:
                traceplot_2d(self.ax, self._samples(c, xp, burn),
                             self._samples(c, yp, burn), xp, yp, scale=scale)
        elif mode == "1D Histogram":
            if self.combined_var.get():
                allsamp = np.concatenate(
                    [self._samples(c, xp, burn) for c in chains])
                histogram_1d(self.ax, allsamp, xp, bins=bins, scale=scale)
            else:
                for c in chains:
                    histogram_1d(self.ax, self._samples(c, xp, burn), xp,
                                 bins=bins, scale=scale)
        elif mode == "2D Histogram":
            c = chains[0]
            histogram_2d(self.ax, self._samples(c, xp, burn),
                         self._samples(c, yp, burn), xp, yp, bins=bins,
                         scale=scale)
        self.canvas.draw()

    def _auto_burn(self):
        chains = self._selected_chains()
        if chains:
            k = equilibration_index(chains[0].data["log likelihood"])
            self.burn_var.set(str(k))
            self.status.set(f"auto burn-in: {k}")

    def _on_load(self):
        from tkinter import filedialog
        for fname in filedialog.askopenfilenames(
                filetypes=[("Ensemble pickles", "*.pik"), ("all", "*")]):
            self.loadfile(fname)

    def _on_export(self):
        """Export whatever the current plot mode shows (reference
        "this_variable" export, GUI/window.py:639-873)."""
        from tkinter import filedialog
        path = filedialog.asksaveasfilename(defaultextension=".csv")
        if not path:
            return
        burn = int(float(self.burn_var.get() or 0))
        bins = int(self.bins_var.get() or 96)
        mode = self.mode_var.get()
        chains = self._selected_chains()
        if not chains:
            self.status.set("no chains loaded")
            return
        xp, yp = self.xparam.get(), self.yparam.get()
        if mode == "1D Trace Plot":
            out = export_traces(
                path, chains, xp,
                samples_fn=lambda c: self._samples(c, xp, burn))
        elif mode == "2D Trace Plot":
            out = export_trace2d(path, self._samples(chains[0], xp, burn),
                                 self._samples(chains[0], yp, burn),
                                 burn=0)
        elif mode == "1D Histogram":
            samples = np.concatenate(
                [self._samples(c, xp, burn) for c in chains])
            out = export_histogram(path, samples, bins=bins,
                                   logscale=bool(self.log_var.get()))
        else:  # 2D Histogram
            out = export_histogram2d(
                path, self._samples(chains[0], xp, burn),
                self._samples(chains[0], yp, burn), bins=bins)
        self.status.set(f"exported {out}")

    def _on_export_all(self):
        if not self.chains:
            self.status.set("no chains loaded")
            return
        burn = int(float(self.burn_var.get() or 0))
        try:
            out_dir = export_all(self._selected_chains(), self.meta,
                                 burn=burn)
        except (FileExistsError, ValueError) as e:
            self.status.set(f"Error - {e}")
            return
        self.status.set(f"Export complete - {out_dir}")

    def _on_activate_chains(self):
        from metrotrpl_tpu_torch.gui.popups import ActivateChainPopup
        ActivateChainPopup(self)

    def _on_diffusion(self):
        if self.meta is None:
            return
        rep = diffusion_report(self._selected_chains(), self.meta)
        self.status.set("\n".join(f"{k}: {v:.3e}" for k, v in rep.items()))

    def _on_quicksim(self):
        from metrotrpl_tpu_torch.gui.popups import QuicksimEntryPopup
        QuicksimEntryPopup(self)

    def mainloop(self):
        self.root.mainloop()
