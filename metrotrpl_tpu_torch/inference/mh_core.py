"""Metropolis-Hastings + parallel-tempering window over E ensembles.

Counterpart of ``metrotrpl_tpu/inference/mh_core.py``: each iteration
proposes a move for every chain of every ensemble, evaluates all E * K
chains in one batched solve, accepts or rejects, and every
``temper_freq`` iterations runs one round of (K - 1) random adjacent-pair
tempering swaps in each ensemble, as row permutations of the (E, K, P)
states and the (E, K, K) chains x temperatures log-likelihood matrices.
Iterations are a Python loop; all tensors stay on the walk's device.

Random numbers come from a *draw source* per ensemble with one method,
``draws(k) -> IterDraws``, giving every uniform and integer iteration k
consumes. :class:`TorchDraws` is the production source; a test can pass
one that replays another generator's stream.

The window is written over a block of (E_l ensembles x K_l chains) of
the walk; an :class:`MHTopology` says where the block sits in the global
(E, K) walk and how the tempering swap sees the whole ensemble. The
single-device topology (:func:`single_device_topology`) is the identity:
one block holds every chain. The sharded walk
(``parallel/sharded_mh.mesh_topology``) splits the chains over processes:
there each source still draws its ensemble's whole iteration (K chains)
and the block keeps its own rows, so any layout walks the chain of the
fused walk at the same seeds.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from metrotrpl_tpu_torch.inference.moves import make_trial_move
from metrotrpl_tpu_torch.tracing import span


class IterDraws(NamedTuple):
    """The random numbers of one iteration (K chains, P parameters, T
    proposal candidates per chain)."""
    u_prop: torch.Tensor            # (T, K, P) uniform [0, 1)
    u_mu: Optional[torch.Tensor]    # (T, K) uniform [0, 1), mu constraint
    u_acc: torch.Tensor             # (K,) uniform [0, 1)
    swap_i: torch.Tensor            # (K - 1,) int64 in [0, K - 2]
    swap_u: torch.Tensor            # (K - 1,) uniform [0, 1)


class MHTopology(NamedTuple):
    """How a process's (E_l, K_l) block of ensembles x chains maps into
    the global (E, K) walk (the JAX ``mh_core.MHTopology``)."""
    E_l: int                 # local ensembles
    K_l: int                 # local chains
    K: int                   # global chains (= temperatures)
    offsets: Callable        # () -> (e0, c0) global offsets of the block
    gather: Callable         # (st_l (E_l, K_l, P), ll_l (E_l, K_l, K))
    #                          -> (st_g (E_l, K, P), ll_g (E_l, K, K))
    scatter: Callable        # (st_g, ll_g, att (E_l, K), acc (E_l, K))
    #                          -> the block's rows of each
    psum_fail: Callable      # (E_l,) local fail counts -> (E_l,) summed
    #                          over every process sharing these ensembles


def single_device_topology(E_l, K, e0=0):
    """Identity topology: one block holds all E_l ensembles x K chains.
    e0 is the block's first global ensemble (the draw sources already
    belong to the block, so the window reads only c0)."""
    return MHTopology(
        E_l=E_l, K_l=K, K=K,
        offsets=lambda: (e0, 0),
        gather=lambda st, ll: (st, ll),
        scatter=lambda st, ll, att, acc: (st, ll, att, acc),
        psum_fail=lambda x: x,
    )


class TorchDraws:
    """Production draw source: iteration k draws from a ``torch.Generator``
    on the walk's device seeded with (seed, k), so a walk resumed at
    iteration k repeats the uninterrupted one exactly."""

    def __init__(self, seed, n_chains, n_params, n_cand, with_mu, dtype,
                 device):
        self.seed = int(seed)
        self.K, self.P, self.T = n_chains, n_params, n_cand
        self.with_mu = with_mu
        self.dtype = dtype
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def draws(self, k):
        ss = np.random.SeedSequence([self.seed % 2 ** 63, int(k)])
        self.gen.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
        kw = dict(generator=self.gen, dtype=self.dtype, device=self.device)
        K = self.K
        u_prop = torch.rand((self.T, K, self.P), **kw)
        u_mu = torch.rand((self.T, K), **kw) if self.with_mu else None
        u_acc = torch.rand((K,), **kw)
        swap_i = torch.randint(0, max(K - 1, 1), (max(K - 1, 0),),
                               generator=self.gen, device=self.device)
        swap_u = torch.rand((max(K - 1, 0),), **kw)
        return IterDraws(u_prop, u_mu, u_acc, swap_i, swap_u)


def stack_draws(ds):
    """The draws of E ensembles' iteration as one batch: u_prop (T, E*K,
    P), u_mu (T, E*K), u_acc (E, K), swap_i and swap_u (E, K - 1)."""
    if len(ds) == 1:
        d = ds[0]
        return IterDraws(d.u_prop, d.u_mu, d.u_acc[None], d.swap_i[None],
                         d.swap_u[None])
    return IterDraws(
        torch.cat([d.u_prop for d in ds], dim=1),
        None if ds[0].u_mu is None else torch.cat([d.u_mu for d in ds],
                                                  dim=1),
        torch.stack([d.u_acc for d in ds]),
        torch.stack([d.swap_i for d in ds]),
        torch.stack([d.swap_u for d in ds]))


def swap_perm_round(st, ll, swap_i, swap_u):
    """One tempering swap round in each of E ensembles: (K - 1) sequential
    adjacent-pair attempts (reference metropolis.py:204-261 math), applied
    as row permutations of the (E, K, P) states and (E, K, K) ll, all
    ensembles at once.

    swap_i, swap_u : (E, K - 1) pair indices and uniforms.
    Returns (st, ll, attempts (E, K), accepts (E, K)) of this round. Every
    index stays on the device, so nothing waits for it."""
    E, K = ll.shape[:2]
    dev = ll.device
    ens = torch.arange(E, device=dev)
    own = torch.arange(K, device=dev).expand(E, K)
    att = torch.zeros((E, K), dtype=torch.int64, device=dev)
    acc = torch.zeros((E, K), dtype=torch.int64, device=dev)
    for j in range(K - 1):
        i = swap_i[:, j]
        ip = i + 1
        # logratio = b_i(u_i) + b_j(u_j) - b_i(u_j) - b_j(u_i)
        logratio = (ll[ens, i, i] + ll[ens, ip, ip] - ll[ens, ip, i]
                    - ll[ens, i, ip])
        accept = swap_u[:, j] < torch.exp(-logratio)
        at_i, at_ip = own == i[:, None], own == ip[:, None]
        perm = torch.where(at_i, torch.where(accept, ip, i)[:, None], own)
        perm = torch.where(at_ip, torch.where(accept, i, ip)[:, None], perm)
        st = torch.gather(st, 1, perm[..., None].expand(st.shape))
        ll = torch.gather(ll, 1, perm[..., None].expand(ll.shape))
        att = att + at_i.to(torch.int64)
        acc = acc + (at_i & accept[:, None]).to(torch.int64)
    return st, ll, att, acc


def make_window_body(eval_nf, move_plan, widths, temper_freq, do_tempering,
                     topo=None):
    """Build window(states (E_l, K_l, P), ll (E_l, K_l, K), k0, n_iters,
    sources) -> (states, ll, swap_att (E_l, K_l), swap_acc (E_l, K_l),
        nfail (E_l,), hist=(states (E_l, n, K_l, P), ll_own (E_l, n, K_l),
        accept (E_l, n, K_l)))
    over a block of E_l tempered ensembles x K_l of their K chains (the
    JAX window body).

    eval_nf : (N, P) states -> ((N, K) ll at every temperature, (N,)
        count per state of the solves that failed after the escalation
        ladder). Each iteration calls it once, on all E_l * K_l proposals.
    widths : (K, P) temperature-scaled proposal half-widths (global rows).
    topo : MHTopology of the block; None is the identity topology of
        whatever (E, K) the states have (one block holds every chain).
    sources : E_l draw sources; ensemble e consumes sources[e] exactly as
        a single-ensemble window would (all K chains' draws; the block
        keeps rows c0:c0 + K_l), so a fused run equals E separate runs
        and any split of the chains equals the fused run.
    """
    def window(states, ll, k0, n_iters, sources):
        E, K_l, P = states.shape
        K = ll.shape[2]
        tp = single_device_topology(E, K) if topo is None else topo
        if (tp.E_l, tp.K_l, tp.K) != (E, K_l, K):
            raise ValueError(f"states {tuple(states.shape)} and ll "
                             f"{tuple(ll.shape)} do not fit the topology's "
                             f"block ({tp.E_l}, {tp.K_l}) of {tp.K} chains")
        _, c0 = tp.offsets()
        rows = slice(c0, c0 + K_l)
        dev = states.device
        w = widths[rows].repeat(E, 1)
        swap_att = torch.zeros((E, K_l), dtype=torch.int64, device=dev)
        swap_acc = torch.zeros((E, K_l), dtype=torch.int64, device=dev)
        nfail = torch.zeros((E,), dtype=torch.int64, device=dev)
        h_states, h_ll, h_acc = [], [], []
        for k in range(int(k0), int(k0) + int(n_iters)):
            with span("metrotrpl.walk.iteration"):
                d = stack_draws([s.draws(k) for s in sources])
                u_prop, u_mu, u_acc = d.u_prop, d.u_mu, d.u_acc
                if K_l != K:   # the block's chains of each ensemble's draws
                    T = u_prop.shape[0]
                    u_prop = u_prop.reshape(T, E, K, P)[:, :, rows].reshape(
                        T, E * K_l, P)
                    if u_mu is not None:
                        u_mu = u_mu.reshape(T, E, K)[:, :, rows].reshape(
                            T, E * K_l)
                    u_acc = u_acc[:, rows]
                new_states = make_trial_move(states.reshape(E * K_l, P), w,
                                             u_prop, u_mu, move_plan)
                new_ll, nf = eval_nf(new_states)
                new_states = new_states.reshape(E, K_l, P)
                new_ll = new_ll.reshape(E, K_l, K)
                nfail = nfail + nf.reshape(E, K_l).sum(dim=1)

                # each chain's own temperature is global column c0 + i
                logratio = (torch.diagonal(new_ll, c0, dim1=1, dim2=2)
                            - torch.diagonal(ll, c0, dim1=1, dim2=2))
                logratio = torch.where(torch.isnan(logratio), -torch.inf,
                                       logratio)
                accept = u_acc < torch.exp(logratio)
                states = torch.where(accept[..., None], new_states, states)
                ll = torch.where(accept[..., None], new_ll, ll)

                if do_tempering and k % temper_freq == 0:
                    st_g, ll_g = tp.gather(states, ll)
                    st_g, ll_g, att, acc = swap_perm_round(
                        st_g, ll_g, d.swap_i, d.swap_u)
                    states, ll, att, acc = tp.scatter(st_g, ll_g, att, acc)
                    swap_att = swap_att + att
                    swap_acc = swap_acc + acc
                h_states.append(states)
                h_ll.append(torch.diagonal(ll, c0, dim1=1, dim2=2))
                h_acc.append(accept)
        hist = (torch.stack(h_states, dim=1), torch.stack(h_ll, dim=1),
                torch.stack(h_acc, dim=1))
        return states, ll, swap_att, swap_acc, tp.psum_fail(nfail), hist

    return window
