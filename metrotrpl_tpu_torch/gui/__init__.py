"""Posterior visualization GUI (tkinter + matplotlib).

Capability-equivalent to the reference's GUI package (reference GUI/window.py,
tkgui.py, mc_plot.py, quicksim.py, secondary_parameters.py, popups): loads
pickled Ensembles (ours or the reference's), draws 1D/2D trace plots and
histograms with burn-in control, computes derived secondary parameters,
exports CSV/NPY, runs quicksim re-simulations of posterior states in a
background process, and reports the chain-diffusion diagnostic.

Port of ``metrotrpl_tpu/gui``: the tk shell and its data layer are the
same numpy, tkinter and matplotlib code; quicksim solves through the
port's ``solve_forward_batch`` (the CUDA solve kernel on the card, its
plain PyTorch version on the CPU).
"""

from metrotrpl_tpu_torch.gui.secondary_parameters import SecondaryParameters  # noqa: F401
