"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each test feeds inputs made with numpy from a seed through a
``metrotrpl_tpu`` function (JAX on the CPU, x64 on — tests/conftest.py)
and its ``metrotrpl_tpu_torch`` counterpart, and compares the two at a
stated tolerance. Also: the staub-shaped configs the tests build, and a
draw source that replays the JAX walk's keyed random stream so the port
can walk the same chain draw for draw.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metrotrpl_tpu.oracle import solve_reference
from metrotrpl_tpu.oracle.scipy_reference import beer_lambert as bl_np
from metrotrpl_tpu.physics import models as jm
from metrotrpl_tpu.physics.models import beer_lambert as j_beer_lambert
from metrotrpl_tpu.solver import forward as jf
from metrotrpl_tpu.workloads import STAUB_NAMES, STAUB_TRUE, STAUB_UC
from metrotrpl_tpu_torch.physics import models as tm
from metrotrpl_tpu_torch.physics.models import beer_lambert as t_beer_lambert
from metrotrpl_tpu_torch.solver import forward as tf
from metrotrpl_tpu_torch.workloads import TRAPS_TRUE

# the suite runs under 6 xdist workers; keep each one's torch pool small
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIDGE_STATES = os.path.join(REPO, "scripts", ".probe_r14_ridge_states.npz")


#: entry-unit truth of the traps model: the staub truth plus the trap
#: parameters, whose unit conversion is 1
TRAPS_TRUTH = {**STAUB_TRUE, **TRAPS_TRUE}


def staub_raw(**over):
    """Staub true parameters in model units."""
    base = {**STAUB_TRUE, **over}
    return {k: v * STAUB_UC.get(k, 1) for k, v in base.items()}


def traps_raw(**over):
    """Traps-model true parameters in model units."""
    base = {**TRAPS_TRUTH, **over}
    return {k: v * STAUB_UC.get(k, 1) for k, v in base.items()}


def param_info(trial_move=0.01, prior=None, inactive=("n0", "eps", "Tm"),
               model="std"):
    names = list(STAUB_NAMES) + (list(TRAPS_TRUE) if model == "traps"
                                 else [])
    return {
        "names": names,
        "unit_conversions": dict(STAUB_UC),
        "do_log": {n: 1 for n in names},
        "active": {n: (0 if n in inactive else 1) for n in names},
        "init_guess": {n: TRAPS_TRUTH[n] for n in names},
        "prior_dist": prior or {n: (1e-30, 1e30) for n in names},
        "trial_move": {n: trial_move for n in names},
    }


def synth_config(nx=16, lengths=(311.0, 2000.0), nt=11, t_end=200.0,
                 fluences=None, unc=0.05, model="std", **mcmc_over):
    """A staub-shaped config: TRPL curves from the float64 LSODA oracle at
    the staub truth (plus the trap parameters for model="traps"), fluence
    initial condition, log-y data."""
    M = len(lengths)
    fluences = fluences or [2.12e11] * M
    t = np.linspace(0, t_end, nt)
    pm = traps_raw() if model == "traps" else staub_raw()
    times, vals, uncs = [], [], []
    for m in range(M):
        dx = lengths[m] / nx
        x = np.linspace(dx / 2, lengths[m] - dx / 2, nx)
        ic = bl_np(fluences[m] * 1e-14, 6e4 * 1e-7, x)
        pl = solve_reference(ic, lengths[m], nx, t, pm, model=model)
        times.append(t)
        vals.append(np.log10(pl))
        uncs.append(np.full(nt, unc))
    sim_info = {"lengths": list(lengths), "nx": [nx] * M,
                "meas_types": ["TRPL"] * M, "num_meas": M}
    mcmc = {"ini_mode": "fluence", "model": model, "log_y": 1,
            "model_uncertainty": 1.0, **mcmc_over}
    iniPar = np.array([[f, 6e4, 1] for f in fluences])
    return sim_info, mcmc, (times, vals, uncs), iniPar


def walk_setup(out, num_iters, **over):
    """A tiny walk config (nx=8, one 311 nm TRPL curve of 6 points, sdirk
    fast mode, hard bounds, 2 tempered chains swapping every 2nd
    iteration, checkpoints every 3) writing to ``out``: (sim_info,
    iniPar, e_data, MCMC_fields, param_info), metro's argument order."""
    from metrotrpl_tpu.workloads import STAUB_PRIOR

    sim_info, mcmc, e_data, iniPar = synth_config(
        nx=8, lengths=(311.0,), nt=6, t_end=50.0, model_uncertainty=0.05)
    mcmc.update({"init_cond_path": "x", "measurement_path": "x",
                 "output_path": str(out), "num_iters": num_iters,
                 "solver": ("sdirk",), "hmax": 16.0, "hard_bounds": 1,
                 "checkpoint_freq": 3, "parallel_tempering": [1.0, 4.0],
                 "temper_freq": 2, "load_checkpoint": None, **over})
    pi = param_info(trial_move=0.02, prior=dict(STAUB_PRIOR))
    return sim_info, iniPar, e_data, mcmc, pi


def staub_states(pi, n, seed, spread=0.1):
    """(n, P) entry-unit states scattered +-spread dex around the truth on
    the active parameters."""
    rng = np.random.default_rng(seed)
    names = pi["names"]
    base = np.array([TRAPS_TRUTH[nm] for nm in names], dtype=float)
    active = np.array([bool(pi["active"][nm]) for nm in names])
    return base[None, :] * 10.0 ** (
        rng.uniform(-spread, spread, (n, len(names))) * active[None, :])


def ridge_states(pi):
    """The 8 high-mobility ridge states of the flagship posterior
    (scripts/.probe_r14_ridge_states.npz) in entry units."""
    d = np.load(RIDGE_STATES)
    return np.stack([d[nm] if nm in d.files
                     else np.full(8, STAUB_TRUE[nm], dtype=float)
                     for nm in pi["names"]], axis=1)


def plane_rel(a, b):
    """max |a - b| over a plane relative to the plane's max |b| (planes
    hold exact zeros and cancelling entries, so a pointwise relative error
    is meaningless there)."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    return float(np.max(np.abs(a - b))) / scale


def params_both(raw, dx, ns):
    """ScaledParams with (B, 1) fields from the same numpy inputs, for the
    JAX package and for the port (float64)."""
    pj = jm.make_scaled_params({k: jnp.asarray(v) for k, v in raw.items()},
                               jnp.asarray(dx), jnp.asarray(ns))
    pj = jax.tree.map(lambda a: jnp.asarray(a)[..., None], pj)
    t64 = torch.float64
    pt = tm.make_scaled_params(
        {k: torch.as_tensor(v, dtype=t64) for k, v in raw.items()},
        torch.as_tensor(dx, dtype=t64), torch.as_tensor(ns, dtype=t64))
    pt = type(pt)(*(a[..., None] for a in pt))
    return pj, pt


def rel_err(a, b):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def compare_eval(out_t, out_j, dll):
    """Port vs JAX make_eval_logll outputs: logll_T and per_meas within
    |dll| with identical -inf entries, fail_states exactly."""
    for key in ("logll_T", "per_meas"):
        a = out_t[key].cpu().numpy()
        b = np.asarray(out_j[key])
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        ok = np.isfinite(b)
        assert np.max(np.abs(a[ok] - b[ok]), initial=0.0) <= dll, key
    np.testing.assert_array_equal(out_t["fail_states"].cpu().numpy(),
                                  np.asarray(out_j["fail_states"]))


def solve_traps_both(plan, raw, fl, al, dtype_np, backend, block_b=None,
                     **kw):
    """A traps batch through the JAX solve (jit, ``backend``) and the
    port's plain solve on the same numpy inputs; returns numpy (port,
    JAX) results."""
    x = np.asarray(plan.x_centers, dtype_np)
    jw = None if plan.out_w is None else jnp.asarray(plan.out_w, dtype_np)
    init_j = j_beer_lambert(jnp.asarray(fl), jnp.asarray(al), jnp.asarray(x))
    out_j = jax.jit(lambda i, r: jf.solve_forward_batch(
        i, r, jnp.asarray(plan.dx, dtype_np), jnp.asarray(plan.dt, dtype_np),
        jnp.asarray(plan.out_idx), jnp.asarray(plan.is_trpl), model="traps",
        backend=backend, block_b=block_b, out_w=jw, **kw))(
            init_j, {k: jnp.asarray(v) for k, v in raw.items()})
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    t = lambda a, d=tdt: torch.as_tensor(np.asarray(a), dtype=d)  # noqa
    init_t = t_beer_lambert(t(fl), t(al), t(x))
    out_t = tf.solve_forward_batch(
        init_t, {k: t(v) for k, v in raw.items()}, t(plan.dx), t(plan.dt),
        t(plan.out_idx, torch.int64), t(plan.is_trpl, torch.bool),
        model="traps", out_w=None if plan.out_w is None else t(plan.out_w),
        **kw)
    if isinstance(out_t, tuple):
        return ([a.numpy() for a in out_t], [np.asarray(a) for a in out_j])
    return out_t.numpy(), np.asarray(out_j)


def assert_plans_equal(mine, ref, path="plan"):
    """Recursive field-for-field equality of two NamedTuple plans (numpy
    arrays exactly equal, dtype included)."""
    if hasattr(ref, "_fields"):
        assert tuple(mine._fields) == tuple(ref._fields), path
        for f in ref._fields:
            assert_plans_equal(getattr(mine, f), getattr(ref, f),
                               f"{path}.{f}")
    elif isinstance(ref, (tuple, list)):
        assert len(mine) == len(ref), path
        for i, (a, b) in enumerate(zip(mine, ref)):
            assert_plans_equal(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(mine, np.ndarray), path
        assert mine.dtype == ref.dtype, f"{path}: {mine.dtype} vs {ref.dtype}"
        np.testing.assert_array_equal(mine, ref, err_msg=path)
    elif isinstance(ref, dict):
        assert mine.keys() == ref.keys(), path
        for k in ref:
            assert_plans_equal(mine[k], ref[k], f"{path}[{k!r}]")
    else:
        assert mine == ref, f"{path}: {mine!r} vs {ref!r}"


class JaxReplayDraws:
    """Draw source for the port's MH window that recomputes the JAX
    window's keyed stream (metrotrpl_tpu/inference/mh_core.py:147-201 and
    moves.py:145-174) with jax.random, so a port walk consumes exactly the
    numbers the JAX walk did: global ensemble ``ens`` of the stream keyed
    by ``seed`` (the single-device window's e = 0 by default; a sharded
    JAX window folds in every ensemble's global index)."""

    def __init__(self, seed, n_chains, n_params, n_cand, dtype, ens=0):
        self.base_key = jax.random.PRNGKey(seed % (2 ** 63))
        self.K, self.P, self.T = n_chains, n_params, n_cand
        self.jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
        self.tdtype = dtype
        K, P, T, jdt = self.K, self.P, self.T, self.jdtype

        def one_iter(base_key, k):
            key_iter = jax.random.fold_in(base_key, k)
            k_prop, k_acc, k_swap = jax.random.split(key_iter, 3)

            def chain_props(c):
                kk = jax.random.fold_in(jax.random.fold_in(k_prop, ens), c)

                def step(key, _):
                    key, k1, k2 = jax.random.split(key, 3)
                    u = jax.random.uniform(k1, (P,), dtype=jdt)
                    um = jax.random.uniform(k2, (), dtype=jdt)
                    return key, (u, um)

                _, (us, ums) = jax.lax.scan(step, kk, None, length=T)
                return us, ums

            us, ums = jax.vmap(chain_props)(jnp.arange(K))   # (K,T,P),(K,T)
            u_acc = jax.vmap(lambda c: jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(k_acc, ens), c), (),
                jdt))(jnp.arange(K))

            def swap_step(key, _):
                key, k1, k2 = jax.random.split(key, 3)
                i = jax.random.randint(k1, (), 0, K - 1)
                u = jax.random.uniform(k2, (), jdt)
                return key, (i, u)

            _, (si, su) = jax.lax.scan(
                swap_step, jax.random.fold_in(k_swap, ens), None,
                length=K - 1)
            return (jnp.swapaxes(us, 0, 1), jnp.swapaxes(ums, 0, 1), u_acc,
                    si, su)

        self._draw = jax.jit(one_iter)

    def draws(self, k):
        from metrotrpl_tpu_torch.inference.mh_core import IterDraws

        us, ums, ua, si, su = (np.array(a) for a in
                               self._draw(self.base_key, k))
        t = lambda a: torch.as_tensor(a, dtype=self.tdtype)  # noqa: E731
        return IterDraws(t(us), t(ums), t(ua),
                         torch.as_tensor(si, dtype=torch.int64), t(su))


def quicksim_tasks(tq, model, nx):
    """Two quicksim tasks of quicksim module tq (the port's or the JAX
    package's) at the staub truth (the trap parameters added for traps):
    different thickness, fluence, direction and length."""
    p = dict(STAUB_TRUE, **({k: TRAPS_TRUTH[k] for k in ("kC", "Nt", "tauE")}
                            if model == "traps" else {}))
    return [tq.QuicksimTask(thickness=311, nx=nx, final_time=200, nt=21,
                            fluence=2.12e11, absp=6e4, direction=1,
                            params=p, model=model),
            tq.QuicksimTask(thickness=2000, nx=nx, final_time=150, nt=16,
                            fluence=1e12, absp=3e4, direction=-1,
                            params=dict(p, mu_n=35.0, tauN=300.0),
                            model=model)]


def assert_run_tasks_equal_jax(model):
    """The port's run_tasks(device="cpu") at float64 and nx=16: each curve
    equals the JAX package's run_tasks within rel 1e-9 (two tasks in one
    batch); scale factors multiply."""
    from metrotrpl_tpu.gui import quicksim as jqs
    from metrotrpl_tpu_torch.gui import quicksim as tqs

    mine = tqs.run_tasks(quicksim_tasks(tqs, model, 16), device="cpu")
    ref = jqs.run_tasks(quicksim_tasks(jqs, model, 16))
    assert len(mine) == 2
    for (tm, sm), (tj, sj) in zip(mine, ref):
        np.testing.assert_array_equal(tm, tj)
        assert sm.shape == sj.shape and np.isfinite(sm).all()
        assert np.max(np.abs(sm - sj) / np.abs(sj)) <= 1e-9
    scaled = tqs.run_tasks(quicksim_tasks(tqs, model, 16),
                           scale_factors=[2.0, None], device="cpu")
    np.testing.assert_allclose(scaled[0][1], 2 * mine[0][1], rtol=1e-12)
    np.testing.assert_array_equal(scaled[1][1], mine[1][1])
