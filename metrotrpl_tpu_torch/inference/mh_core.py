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
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from metrotrpl_tpu_torch.inference.moves import make_trial_move


class IterDraws(NamedTuple):
    """The random numbers of one iteration (K chains, P parameters, T
    proposal candidates per chain)."""
    u_prop: torch.Tensor            # (T, K, P) uniform [0, 1)
    u_mu: Optional[torch.Tensor]    # (T, K) uniform [0, 1), mu constraint
    u_acc: torch.Tensor             # (K,) uniform [0, 1)
    swap_i: torch.Tensor            # (K - 1,) int64 in [0, K - 2]
    swap_u: torch.Tensor            # (K - 1,) uniform [0, 1)


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


def make_window_body(eval_nf, move_plan, widths, temper_freq, do_tempering):
    """Build window(states (E, K, P), ll (E, K, K), k0, n_iters, sources)
    -> (states, ll, swap_att (E, K), swap_acc (E, K), nfail (E,),
        hist=(states (E, n, K, P), ll_own (E, n, K), accept (E, n, K)))
    over E tempered ensembles of K chains (the JAX window body over an
    (E_l, K_l) block on the single-device topology).

    eval_nf : (N, P) states -> ((N, K) ll at every temperature, (N,)
        count per state of the solves that failed after the escalation
        ladder). Each iteration calls it once, on all E * K proposals.
    widths : (K, P) temperature-scaled proposal half-widths.
    sources : E draw sources; ensemble e consumes sources[e] exactly as a
        single-ensemble window would, so a fused run equals E separate
        runs.
    """
    def window(states, ll, k0, n_iters, sources):
        E, K, P = states.shape
        dev = states.device
        w = widths.repeat(E, 1)
        swap_att = torch.zeros((E, K), dtype=torch.int64, device=dev)
        swap_acc = torch.zeros((E, K), dtype=torch.int64, device=dev)
        nfail = torch.zeros((E,), dtype=torch.int64, device=dev)
        h_states, h_ll, h_acc = [], [], []
        for k in range(int(k0), int(k0) + int(n_iters)):
            d = stack_draws([s.draws(k) for s in sources])
            new_states = make_trial_move(states.reshape(E * K, P), w,
                                         d.u_prop, d.u_mu, move_plan)
            new_ll, nf = eval_nf(new_states)
            new_states = new_states.reshape(E, K, P)
            new_ll = new_ll.reshape(E, K, K)
            nfail = nfail + nf.reshape(E, K).sum(dim=1)

            logratio = (torch.diagonal(new_ll, dim1=1, dim2=2)
                        - torch.diagonal(ll, dim1=1, dim2=2))
            logratio = torch.where(torch.isnan(logratio), -torch.inf,
                                   logratio)
            accept = d.u_acc < torch.exp(logratio)
            states = torch.where(accept[..., None], new_states, states)
            ll = torch.where(accept[..., None], new_ll, ll)

            if do_tempering and k % temper_freq == 0:
                states, ll, att, acc = swap_perm_round(states, ll, d.swap_i,
                                                       d.swap_u)
                swap_att = swap_att + att
                swap_acc = swap_acc + acc
            h_states.append(states)
            h_ll.append(torch.diagonal(ll, dim1=1, dim2=2))
            h_acc.append(accept)
        hist = (torch.stack(h_states, dim=1), torch.stack(h_ll, dim=1),
                torch.stack(h_acc, dim=1))
        return states, ll, swap_att, swap_acc, nfail, hist

    return window
