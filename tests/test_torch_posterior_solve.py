"""The port's solve against the JAX package's at the committed posteriors'
states: the traps workload of scripts/posterior_torch.py (nx=32) on the
plan of the fast leg's ladder (hmax 4, chord-free: the gold leg's step
family), float64, at states drawn from the committed JAX gold column
(log10-normal with its mean and sigma on every active parameter)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import REPO, rel_err

from metrotrpl_tpu.physics.models import beer_lambert as j_beer_lambert
from metrotrpl_tpu.solver import forward as jf
from metrotrpl_tpu_torch.physics.models import beer_lambert as t_beer_lambert
from metrotrpl_tpu_torch.solver import forward as tf

SCRIPTS = os.path.join(REPO, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import posterior_torch as pt  # noqa: E402


def test_traps_solve_equals_jax_at_committed_posterior_states():
    """4 states x 2 curves through the port's plain solve and the JAX XLA
    solve: PL rel 1e-9."""
    model = "traps"
    w = pt.WORKLOADS[model]()
    M = len(w.lengths)
    t = np.linspace(0, w.t_end, w.nt)
    plan = pt.build_plans(w, t, [np.zeros(w.nt)] * M, 48.0, 4, 1)[0]
    idx, _, fp = plan.fwd[0]
    assert fp.nx == 32 and fp.refactor_every == 1 and len(idx) == M
    gold = pt.read_committed_gold(os.path.join(REPO, w.artifact))
    rng = np.random.default_rng(7)
    K = 4
    raw = {n: np.repeat([w.start[n] * w.uc.get(n, 1)] * K, M)
           for n in w.names}
    for n in w.active:
        m, s, _ = gold[n]
        raw[n] = np.repeat(10.0 ** rng.normal(m, s, K), M) * w.uc.get(n, 1)
    fl = np.tile([f * 1e-14 for f, _ in w.flu], K)[:, None]
    al = np.tile([a * 1e-7 for _, a in w.flu], K)[:, None]
    kw = dict(model=model, refactor_every=fp.refactor_every,
              n_ramp=fp.n_ramp, ramp_block=fp.ramp_block,
              newton_plateau=fp.newton_plateau)
    x = np.tile(fp.x_centers, (K, 1))
    dx, dt = np.tile(fp.dx, K), np.tile(fp.dt, (K, 1))
    out_idx, is_trpl = np.tile(fp.out_idx, (K, 1)), np.tile(fp.is_trpl, K)

    out_j = jax.jit(lambda i, r: jf.solve_forward_batch(
        i, r, jnp.asarray(dx), jnp.asarray(dt), jnp.asarray(out_idx),
        jnp.asarray(is_trpl), backend="xla", **kw))(
            j_beer_lambert(jnp.asarray(fl), jnp.asarray(al), jnp.asarray(x)),
            {k: jnp.asarray(v) for k, v in raw.items()})
    T = torch.as_tensor
    out_t = tf.solve_forward_batch(
        t_beer_lambert(T(fl), T(al), T(x)), {k: T(v) for k, v in raw.items()},
        T(dx), T(dt), T(out_idx), T(is_trpl), **kw)
    sj, st = np.asarray(out_j), out_t.numpy()
    assert sj.shape == (K * M, w.nt) and np.isfinite(sj).all()
    assert (sj > 0).all()
    assert rel_err(st, sj) < 1e-9
