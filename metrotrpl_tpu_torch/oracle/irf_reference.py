"""Numpy oracle of the reference IRF-convolution pipeline.

The port's own copy of the JAX package's ``oracle/irf_reference.py``. It
mirrors reference laplace.py semantics (resample at half the IRF step,
moment-method convolution, optional max-shift, post-convolution trim) for
testing the masked fixed-shape compare pipeline against.
"""

import numpy as np


def i_moment_numeric(t, y, m, n, u_spacing=1000):
    """Simpson-rule moment integral exactly as the reference computes it
    (laplace.py:129-167)."""
    from scipy.integrate import simpson

    dt = t[1] - t[0]
    u = np.linspace(0, 1, u_spacing)
    du = u[1] - u[0]
    y_intp = np.linspace(y[m + 1], y[m], u_spacing)
    return dt * simpson((u - 0.5) ** n * y_intp, dx=du)


def make_tables_numeric(t_irf, f_irf, u_spacing=1000):
    nk = len(f_irf)
    table = np.zeros((nk, 3))
    for m in range(nk - 1):
        for n in range(3):
            table[m, n] = i_moment_numeric(t_irf, f_irf, m, n, u_spacing)
    return table


def convolve_reference(resampled_y, table):
    """Reference convolve() math (laplace.py:170-212)."""
    nk_irf = len(table)
    nk = (len(resampled_y) - 1) // 2
    h = np.zeros(nk + 1)
    i2 = 2 * (resampled_y[2::2] - 2 * resampled_y[1::2] + resampled_y[:-1:2])
    i1 = resampled_y[2::2] - resampled_y[:-1:2]
    i0 = resampled_y[1::2]
    for k in range(1, nk + 1):
        lo = max(0, k - nk_irf)
        h[k] = np.sum(i0[lo:k] * table[:k, 0][::-1]
                      + i1[lo:k] * table[:k, 1][::-1]
                      + i2[lo:k] * table[:k, 2][::-1])
    return h


def do_irf_convolution_reference(t, y, table, t_irf, time_max_shift=False):
    """Reference do_irf_convolution() (laplace.py:44-85)."""
    dt_irf = np.mean(np.diff(t_irf))
    rt = np.arange(0, t[-1] + dt_irf / 4, dt_irf / 2)
    if rt[-1] > t[-1]:
        rt[-1] = t[-1]
    if len(rt) % 2 == 0:
        # convolve needs 2*nk+1 points; drop the trailing half-step like
        # the likelihood layer does (the reference omits this and its
        # slices silently misalign on even-length grids, laplace.py:178)
        rt = rt[:-1]
    ry = np.interp(rt, t, y)
    cy = convolve_reference(ry, table)
    ct = rt[::2].copy()
    success = True
    if time_max_shift:
        ct = ct - ct[np.argmax(cy)]
        if ct[-1] == 0:
            success = False
    return ct, cy, success


def post_conv_trim_reference(conv_t, conv_y, exp_t, exp_y, exp_u):
    """Reference post_conv_trim() (laplace.py:88-126)."""
    cutoff = np.where(exp_t < np.nanmax(conv_t))[0][-1]
    out = np.interp(exp_t[:cutoff + 1], conv_t, conv_y)
    return (out, exp_t[:cutoff + 1], exp_y[:cutoff + 1],
            exp_u[:cutoff + 1])
