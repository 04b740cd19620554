"""Metropolis-Hastings + parallel-tempering window over E ensembles.

Counterpart of ``metrotrpl_tpu/inference/mh_core.py``: each iteration
proposes a move for every chain of every ensemble, evaluates all E * K
chains in one batched solve, accepts or rejects, and every
``temper_freq`` iterations runs one round of (K - 1) random adjacent-pair
tempering swaps in each ensemble, as row permutations of the (E, K, P)
states and the (E, K, K) chains x temperatures log-likelihood matrices.
Iterations are a Python loop; all tensors stay on the walk's device. On
a card, a pde walk's iteration is three CUDA graphs, replayed around the
escalation ladder's one host sync and its eager rung
(:class:`_IterationGraphs`); elsewhere it runs eagerly, with the same
bits.

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

from metrotrpl_tpu_torch.inference.likelihood import LadderEval
from metrotrpl_tpu_torch.inference.moves import (
    make_trial_move,
    move_tensors,
    n_tries,
)
from metrotrpl_tpu_torch.solver import solve_kernel
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


class WalkEval:
    """eval_logll at the walk's temperatures, as the window calls it:
    eval_nf(states (N, P)) -> ((N, K) ll at every temperature, (N,)
    solves per state that failed after the escalation ladder).
    ``ladder`` is the evaluator where it is a :class:`LadderEval` (the pde
    kind), whose parts the window replays as CUDA graphs on a card, else
    None."""

    def __init__(self, eval_logll, temps):
        self.eval_logll = eval_logll
        self.temps = temps
        self.ladder = (eval_logll if isinstance(eval_logll, LadderEval)
                       else None)

    def __call__(self, states):
        r = self.eval_logll(states, self.temps)
        return r["logll_T"], r["fail_states"]


def accept_step(states, ll, new_states, new_ll, u_acc, c0):
    """The Metropolis accept of every chain at its own temperature, global
    column c0 + i of the (E, K_l, K) ll: (states, ll, accept (E, K_l))."""
    logratio = (torch.diagonal(new_ll, c0, dim1=1, dim2=2)
                - torch.diagonal(ll, c0, dim1=1, dim2=2))
    logratio = torch.where(torch.isnan(logratio), -torch.inf, logratio)
    accept = u_acc < torch.exp(logratio)
    states = torch.where(accept[..., None], new_states, states)
    ll = torch.where(accept[..., None], new_ll, ll)
    return states, ll, accept


def _kernel_counts():
    return {k: (solve_kernel.LAUNCHES[k], solve_kernel.ROWS[k])
            for k in solve_kernel.LAUNCHES}


class _Segment:
    """A fixed-shape piece of the iteration, fn, captured once as a CUDA
    graph in ``pool``. A replay runs no Python, so it adds to the solve
    kernel's counters what the capture's calls added, and the capture
    itself counts nothing."""

    def __init__(self, fn, pool):
        self.graph = torch.cuda.CUDAGraph()
        c0 = _kernel_counts()
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode="thread_local"):
            fn()
        c1 = _kernel_counts()
        self.counts = {k: (c1[k][0] - c0[k][0], c1[k][1] - c0[k][1])
                       for k in c1 if c1[k] != c0[k]}
        self._add(-1)

    def _add(self, sign):
        for k, (n, rows) in self.counts.items():
            solve_kernel.LAUNCHES[k] += sign * n
            solve_kernel.ROWS[k] += sign * rows

    def replay(self):
        with span("metrotrpl.walk.replay"):
            self.graph.replay()
        self._add(1)


class _IterationGraphs:
    """The iteration of a pde walk on a card as three CUDA graphs around
    the ladder's rung, the one step whose size the data decide:

    A : the trial move and the ladder up to its sync (``before``);
    then, eagerly, the sync and the rung (``rung``);
    I : the assembled curves and the IRF stage (``mid``);
    C : the rest of the comparison, the accept step and the failure count.

    Static buffers hold the carried states ``x`` and ll ``ll``, the
    iteration's draws and the window's failure count ``nfail``. The first
    iteration runs the segments eagerly on a side stream, the warm-up a
    capture asks for; the second captures them, into one memory pool, and
    from then on they are replayed."""

    def __init__(self, ev, move_plan, mt, w, c0, states, ll):
        E, K_l, P = states.shape
        T = n_tries(move_plan)
        kw = dict(dtype=states.dtype, device=states.device)
        self.ev, self.plan, self.mt, self.w, self.c0 = (ev, move_plan, mt,
                                                        w, c0)
        self.x = torch.empty_like(states)
        self.ll = torch.empty_like(ll)
        self.u_prop = torch.empty((T, E * K_l, P), **kw)
        self.u_mu = (None if move_plan.mu_constraint is None
                     else torch.empty((T, E * K_l), **kw))
        self.u_acc = torch.empty((E, K_l), **kw)
        self.nfail = torch.zeros((E,), dtype=torch.int64,
                                 device=states.device)
        self.warm = False
        self.segments = None

    def _a(self):
        E, K_l, P = self.x.shape
        self.new = make_trial_move(self.x.reshape(E * K_l, P), self.w,
                                   self.u_prop, self.u_mu, self.plan,
                                   self.mt)
        self.pre = self.ev.ladder.before(self.new)

    def _i(self):
        self.mid = self.ev.ladder.mid(self.pre)

    def _c(self):
        r = self.ev.ladder.after(self.pre, self.mid, self.ev.temps)
        E, K_l, P = self.x.shape
        self.nfail.add_(r["fail_states"].reshape(E, K_l).sum(dim=1))
        x, ll, self.accept = accept_step(
            self.x, self.ll, self.new.reshape(E, K_l, P),
            r["logll_T"].reshape(self.ll.shape), self.u_acc, self.c0)
        self.x.copy_(x)
        self.ll.copy_(ll)

    def step(self, u_prop, u_mu, u_acc):
        """One iteration on these draws: moves ``x`` and ``ll`` on and
        returns the accepts (E, K_l)."""
        self.u_prop.copy_(u_prop)
        if u_mu is not None:
            self.u_mu.copy_(u_mu)
        self.u_acc.copy_(u_acc)
        ladder = self.ev.ladder
        if not self.warm:
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side), span("metrotrpl.likelihood.eval"):
                self._a()
                ladder.rung(self.pre)
                self._i()
                self._c()
            cur.wait_stream(side)
            self.warm = True
            return self.accept
        if self.segments is None:
            pool = torch.cuda.graph_pool_handle()
            self.segments = [_Segment(f, pool)
                             for f in (self._a, self._i, self._c)]
        a, i, c = self.segments
        with span("metrotrpl.likelihood.eval"):
            a.replay()
            ladder.rung(self.pre)
            with span("metrotrpl.likelihood.irf"):
                i.replay()
            c.replay()
        return self.accept


def make_window_body(eval_nf, move_plan, widths, temper_freq, do_tempering,
                     topo=None, _eager=False):
    """Build window(states (E_l, K_l, P), ll (E_l, K_l, K), k0, n_iters,
    sources) -> (states, ll, swap_att (E_l, K_l), swap_acc (E_l, K_l),
        nfail (E_l,), hist=(states (E_l, n, K_l, P), ll_own (E_l, n, K_l),
        accept (E_l, n, K_l)))
    over a block of E_l tempered ensembles x K_l of their K chains (the
    JAX window body).

    eval_nf : (N, P) states -> ((N, K) ll at every temperature, (N,)
        count per state of the solves that failed after the escalation
        ladder). Each iteration calls it once, on all E_l * K_l proposals.
        Where it is a :class:`WalkEval` of the pde kind and the states are
        on a card, the iterations run as the CUDA graphs of
        :class:`_IterationGraphs`, kept across windows of the same shapes,
        with the same bits; ``_eager`` turns them off (tests).
    widths : (K, P) temperature-scaled proposal half-widths (global rows).
    topo : MHTopology of the block; None is the identity topology of
        whatever (E, K) the states have (one block holds every chain).
    sources : E_l draw sources; ensemble e consumes sources[e] exactly as
        a single-ensemble window would (all K chains' draws; the block
        keeps rows c0:c0 + K_l), so a fused run equals E separate runs
        and any split of the chains equals the fused run.
    """
    mt = move_tensors(move_plan, widths.dtype, widths.device)
    graphs = {}    # the captured iteration, by the window's shapes

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
        n = int(n_iters)
        swap_att = torch.zeros((E, K_l), dtype=torch.int64, device=dev)
        swap_acc = torch.zeros((E, K_l), dtype=torch.int64, device=dev)
        nfail = torch.zeros((E,), dtype=torch.int64, device=dev)
        h_states = torch.empty((E, n, K_l, P), dtype=states.dtype,
                               device=dev)
        h_ll = torch.empty((E, n, K_l), dtype=ll.dtype, device=dev)
        h_acc = torch.empty((E, n, K_l), dtype=torch.bool, device=dev)
        w = widths[rows].repeat(E, 1)
        g = None
        if (getattr(eval_nf, "ladder", None) is not None and states.is_cuda
                and not _eager):
            key = (states.shape, ll.shape, states.dtype, dev)
            g = graphs.get(key)
            if g is None:
                graphs.clear()
                g = graphs[key] = _IterationGraphs(eval_nf, move_plan, mt, w,
                                                   c0, states, ll)
            g.x.copy_(states)
            g.ll.copy_(ll)
            g.nfail.zero_()
        for i, k in enumerate(range(int(k0), int(k0) + n)):
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
                if g is None:
                    new_states = make_trial_move(states.reshape(E * K_l, P),
                                                 w, u_prop, u_mu, move_plan,
                                                 mt)
                    new_ll, nf = eval_nf(new_states)
                    nfail = nfail + nf.reshape(E, K_l).sum(dim=1)
                    states, ll, accept = accept_step(
                        states, ll, new_states.reshape(E, K_l, P),
                        new_ll.reshape(E, K_l, K), u_acc, c0)
                else:
                    accept = g.step(u_prop, u_mu, u_acc)
                    states, ll = g.x, g.ll

                if do_tempering and k % temper_freq == 0:
                    st_g, ll_g = tp.gather(states, ll)
                    st_g, ll_g, att, acc = swap_perm_round(
                        st_g, ll_g, d.swap_i, d.swap_u)
                    states, ll, att, acc = tp.scatter(st_g, ll_g, att, acc)
                    swap_att = swap_att + att
                    swap_acc = swap_acc + acc
                    if g is not None:
                        g.x.copy_(states)
                        g.ll.copy_(ll)
                        states, ll = g.x, g.ll
                h_states[:, i].copy_(states)
                h_ll[:, i].copy_(torch.diagonal(ll, c0, dim1=1, dim2=2))
                h_acc[:, i].copy_(accept)
        if g is not None:   # the caller's copies: the buffers walk on
            states, ll, nfail = g.x.clone(), g.ll.clone(), g.nfail.clone()
        return (states, ll, swap_att, swap_acc, tp.psum_fail(nfail),
                (h_states, h_ll, h_acc))

    return window
