"""Chart drawing helpers (reference GUI/mc_plot.py equivalents).

Pure matplotlib-Axes functions so they are testable headlessly and reusable
outside the tk shell.
"""

import numpy as np


def traceplot_1d(ax, samples, label, scale="log", xlims=None):
    """Parameter value vs iteration for one chain."""
    ax.plot(samples, label=label)
    ax.set_yscale(scale)
    ax.set_xlabel("Sample #")
    ax.set_ylabel(label)
    if xlims:
        ax.set_xlim(*xlims)


def traceplot_2d(ax, xs, ys, xlabel, ylabel, scale="log"):
    """Walk trajectory in a 2D parameter plane."""
    ax.plot(xs, ys, linewidth=0.7, alpha=0.8)
    ax.scatter(xs[:1], ys[:1], c="green", marker="o", label="start")
    ax.scatter(xs[-1:], ys[-1:], c="red", marker="x", label="end")
    if scale == "log":
        ax.set_xscale("log")
        ax.set_yscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()


def histogram_1d(ax, samples, label, bins=96, scale="log", density=True):
    """Posterior marginal histogram; log-spaced bins when scale='log'."""
    samples = np.asarray(samples)
    if scale == "log":
        pos = samples[samples > 0]
        if len(pos) == 0:
            # all-nonpositive data (e.g. log likelihood with the log-x
            # default on): fall back to linear bins instead of crashing
            edges = bins
        else:
            samples = pos
            edges = np.logspace(np.log10(samples.min()),
                                np.log10(samples.max()), bins + 1)
            ax.set_xscale("log")
    else:
        edges = bins
    ax.hist(samples, bins=edges, density=density, alpha=0.8)
    ax.set_xlabel(label)
    ax.set_ylabel("P(" + label + ")")


def histogram_2d(ax, xs, ys, xlabel, ylabel, bins=96, scale="log"):
    """Joint posterior density in a 2D parameter plane."""
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    keep = (xs > 0) & (ys > 0)
    if scale == "log" and np.any(keep):
        xs, ys = xs[keep], ys[keep]
        xe = np.logspace(np.log10(xs.min()), np.log10(xs.max()), bins + 1)
        ye = np.logspace(np.log10(ys.min()), np.log10(ys.max()), bins + 1)
        ax.set_xscale("log")
        ax.set_yscale("log")
    else:
        xe = ye = bins
    h = ax.hist2d(xs, ys, bins=[xe, ye], cmap="Blues")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return h


def sim_plot(ax, t, sol, label=None, scale="log"):
    """Quicksim decay curve overlay."""
    ax.plot(t, sol, label=label)
    ax.set_yscale(scale)
    ax.set_xlabel("Delay time")
    ax.set_ylabel("Signal")
    if label:
        ax.legend()


def equilibration_index(loglikelihood, window=50):
    """Suggest a burn-in cutoff: first iteration where the running-mean
    log-likelihood reaches its long-run plateau (GUI 'equi' helper)."""
    ll = np.asarray(loglikelihood, dtype=float)
    if len(ll) < 2 * window:
        return 0
    kernel = np.ones(window) / window
    smooth = np.convolve(ll, kernel, mode="valid")
    plateau = np.median(smooth[-window:])
    spread = max(np.std(smooth[-window:]), 1e-12)
    hit = np.where(smooth >= plateau - 3 * spread)[0]
    return int(hit[0]) if len(hit) else 0


def chain_diffusion(states_log10, active_mask):
    """Average squared log10 displacement per iteration per active param
    (reference GUI/window.py:875-902 diagnostic)."""
    d = np.diff(states_log10, axis=-1)
    # reference pickles store 'active' as int 0/1 — coerce to bool so this
    # masks rows instead of integer fancy-indexing them
    active_mask = np.asarray(active_mask, dtype=bool)
    n_active = max(int(np.sum(active_mask)), 1)
    return float(np.sum(d[active_mask] ** 2) / (d.shape[-1] * n_active))
