"""The MH window over one rank's block of a (d_e, d_c) process grid
(JAX ``parallel/sharded_mh.py``).

Every rank evaluates only its E_l * K_l proposals (E_l = E / d_e,
K_l = K / d_c): its share of the solve batch, the work, never leaves
its device. The window body is ``inference/mh_core.py``'s, shared with
the single-device kernel; this module supplies the topology. At each
tempering iteration the chains group of the rank's ensemble block
all-gathers the block's (E_l, K_l, P) states and (E_l, K_l, K)
likelihoods into the ensembles' (E_l, K, P) and (E_l, K, K), every rank
of the group runs the same swap round on them (each draw source gives
the whole ensemble's swap draws), and each keeps its own rows: the
collective form of the reference's send/recv swap. The failure counts
are summed over the chains group once per window. Each collective
runs in a span of its own (``metrotrpl.mesh.gather`` at a swap round,
``metrotrpl.mesh.history`` for a window's History rows,
``metrotrpl.mesh.fail_sum``) and adds to the rank's ``mesh.comm`` count.

Draws: ensemble e's source draws all K chains of every iteration, and
the rank keeps rows c0:c0 + K_l, so the walk does not depend on the
layout: any grid equals the fused walk at the same seeds (JAX gets the
same property from its keyed stream, folded in on the global (e, c)).
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from metrotrpl_tpu_torch.inference.likelihood import make_eval_logll
from metrotrpl_tpu_torch.inference.mh_core import (
    MHTopology,
    WalkEval,
    make_window_body,
)
from metrotrpl_tpu_torch.tracing import span


class ShardedMHKernel(NamedTuple):
    run_window: callable   # (states (E_l, K_l, P), ll_T (E_l, K_l, K), k0,
                           #  n_iters, E_l draw sources) -> (states, ll_T,
                           #  swap_att, swap_acc, nfail (E_l,), hist)
    init_ll: callable      # states (E_l, K_l, P) -> (E_l, K_l, K)
    n_ens: int
    n_chains: int
    topo: MHTopology       # the rank's block: E_l, K_l, offsets


def gather_chains(mesh, x):
    """(E_l, K_l, ...) on every rank of mesh's chains group -> (E_l,
    d_c * K_l, ...) in chain-block order, on x's device."""
    buf = x.contiguous().to(mesh.comm_device)
    parts = [torch.empty_like(buf) for _ in range(mesh.shape[1])]
    mesh.comm.add(buf)
    dist.all_gather(parts, buf, group=mesh.chains_group)
    return torch.cat(parts, dim=1).to(x.device)


def gather_history(mesh, x):
    """:func:`gather_chains` of a window's History rows (or the initial
    state's), in the span ``metrotrpl.mesh.history``."""
    with span("metrotrpl.mesh.history"):
        return gather_chains(mesh, x)


def sum_chains(mesh, x):
    """x summed over mesh's chains group, on x's device."""
    with span("metrotrpl.mesh.fail_sum"):
        buf = x.to(mesh.comm_device, copy=True)
        mesh.comm.add(buf)
        dist.all_reduce(buf, group=mesh.chains_group)
        return buf.to(x.device)


def mesh_topology(mesh, E, K, n_params):
    """MHTopology of the rank's block: its offsets, the swap's all-gather
    over the chains group and the slice back to its rows, and the
    failure counts' sum over the chains group."""
    d_e, d_c = mesh.shape
    E_l, K_l = E // d_e, K // d_c
    e0, c0 = mesh.i_e * E_l, mesh.i_c * K_l
    P = n_params

    def gather(st_l, ll_l):
        # one collective for both: (E_l, K_l, P + K) -> (E_l, K, P + K)
        with span("metrotrpl.mesh.gather"):
            both = gather_chains(mesh, torch.cat([st_l, ll_l], dim=2))
        return both[..., :P], both[..., P:]

    def scatter(st_g, ll_g, att, acc):
        rows = slice(c0, c0 + K_l)
        return st_g[:, rows], ll_g[:, rows], att[:, rows], acc[:, rows]

    return MHTopology(E_l=E_l, K_l=K_l, K=K, offsets=lambda: (e0, c0),
                      gather=gather, scatter=scatter,
                      psum_fail=lambda x: sum_chains(mesh, x))


def build_sharded_mh_kernel(like_plan, move_plan, temps, base_trial_move,
                            temper_freq, do_tempering, mesh, n_ens=1,
                            dtype=torch.float64):
    """The MH window of the rank's block on its device (``mesh.device``).

    mesh : the rank's :class:`~metrotrpl_tpu_torch.parallel.ChainMesh`;
        n_ens must divide over its d_e rows and len(temps) over its d_c
        columns.
    """
    d_e, d_c = mesh.shape
    E, K = int(n_ens), len(temps)
    if E % d_e or K % d_c:
        raise ValueError(f"(n_ens={E}, n_chains={K}) not divisible by mesh "
                         f"shape (ens={d_e}, chains={d_c})")
    device = mesh.device
    temps_t = torch.as_tensor(np.asarray(temps), dtype=dtype, device=device)
    base_move = torch.as_tensor(np.asarray(base_trial_move), dtype=dtype,
                                device=device)
    widths = torch.sqrt(temps_t)[:, None] * base_move[None, :]   # (K, P)
    eval_nf = WalkEval(make_eval_logll(like_plan, dtype=dtype,
                                       device=device), temps_t)
    topo = mesh_topology(mesh, E, K, like_plan.n_params)

    def init_ll(states_l):
        E_l, K_l, P = states_l.shape
        return eval_nf(states_l.reshape(E_l * K_l, P))[0].reshape(
            E_l, K_l, K)

    window = make_window_body(eval_nf, move_plan, widths, temper_freq,
                              do_tempering, topo)
    return ShardedMHKernel(run_window=window, init_ll=init_ll, n_ens=E,
                           n_chains=K, topo=topo)
