"""The walk cells: the fused tempered walk of ``cli mcmc --ensembles E``,
window after window of the mix's iteration count, each window's History
copied to the host once.

Set-up builds the plans and the fused window function from the
configuration (``plans_from_config``, ``build_mh_kernel``,
``vmap_ensembles``), starts every chain of every ensemble at the
configuration's initial guess, and walks one window of the same length:
that compiles nothing (the kernels are a built library), but it loads
the library and touches every shape the window uses. The measured
windows follow on from there. No checkpoint is written.
"""

from time import perf_counter

import numpy as np
import torch


class Walk:
    """The program under test of a walk cell, built and warmed up."""

    def __init__(self, cell, inputs, seed, device):
        from metrotrpl_tpu_torch import default_walk_dtype
        from metrotrpl_tpu_torch.inference.metropolis import (
            build_mh_kernel,
            plans_from_config,
            vmap_ensembles,
        )
        from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
        from metrotrpl_tpu_torch.inference.moves import n_tries

        sim_info, param_info, mc, e_data, iniPar, irf_tables = inputs
        tr = cell.traffic
        self.E = int(tr["ensembles"])
        self.W = int(tr["window_iters"])
        self.temps = np.asarray(mc["parallel_tempering"], dtype=float)
        self.K = len(self.temps)
        self.temper_freq = int(mc.get("temper_freq", 10))
        names = list(param_info["names"])
        self.P = len(names)
        self.dtype = default_walk_dtype(device)
        self.device = device
        like_plan, move_plan = plans_from_config(
            sim_info, param_info, dict(mc), e_data, iniPar,
            irf_tables=irf_tables)
        base = np.array([param_info["trial_move"][n]
                         if param_info["active"][n] else 0.0 for n in names])
        self.kernel = vmap_ensembles(build_mh_kernel(
            like_plan, move_plan, self.temps, base, self.temper_freq,
            self.K > 1, dtype=self.dtype, device=device))
        #: ensemble e draws from seed + e, as cli mcmc seeds its replicas
        self.seeds = [int(seed) + e for e in range(self.E)]
        self.sources = [TorchDraws(s, self.K, self.P, n_tries(move_plan),
                                   move_plan.mu_constraint is not None,
                                   self.dtype, device) for s in self.seeds]
        x0 = np.array([param_info["init_guess"][n] for n in names])
        self.states = torch.as_tensor(
            np.broadcast_to(x0, (self.E, self.K, self.P)).copy(),
            dtype=self.dtype, device=device)
        self.ll = self.kernel.init_ll(self.states)
        self.k = 1
        self.windows = []
        #: solves that failed after the escalation ladder, per ensemble
        self.nfail = torch.zeros((self.E,), dtype=torch.int64, device=device)

    def window(self):
        """Walk one window and copy its History to the host: (states (E,
        n, K, P), own-temperature ll (E, n, K), accepts (E, n, K)) as
        numpy, iterations k0..k0+n-1."""
        E, K, P, n = self.E, self.K, self.P, self.W
        k0 = self.k
        states, ll, att, acc, nfail, hist = self.kernel.run_window(
            self.states, self.ll, k0, n, self.sources)
        h_states, h_ll, h_acc = hist
        buf = torch.cat([h_states.reshape(E, n, K * P), h_ll,
                         h_acc.to(h_ll.dtype)], dim=2).cpu().numpy()
        self.states, self.ll = states, ll
        self.nfail = self.nfail + nfail
        self.k += n
        rec = (k0, buf[..., :K * P].reshape(E, n, K, P),
               buf[..., K * P:K * P + K], buf[..., K * P + K:] > 0.5)
        return rec

    def warm_up(self):
        """One window of the cell's shapes; keeps the final states as the
        start of the measured History."""
        self.window()
        self.nfail.zero_()
        self.start = (self.k - 1, self.states.cpu().numpy(),
                      torch.diagonal(self.ll, 0, 1, 2).cpu().numpy())
        torch.cuda.synchronize()

    def measure(self, seconds, max_windows=None):
        """Windows until ``seconds`` have passed (or ``max_windows``):
        returns (iterations, wall seconds)."""
        t0 = perf_counter()
        n = 0
        while True:
            self.windows.append(self.window())
            n += 1
            dt = perf_counter() - t0
            if dt >= seconds or (max_windows and n >= max_windows):
                return n * self.W, dt

    def rate(self, iters, seconds):
        """walker-steps/s: iterations x chains x ensembles over the
        window's wall time."""
        return iters * self.K * self.E / seconds

    def history(self):
        """The measured History: first iteration, start states (E, K, P)
        and own ll (E, K) before it, then states (E, n, K, P), ll (E, n,
        K) and accepts (E, n, K) of every measured iteration."""
        k_first = self.windows[0][0]
        return (k_first, self.start[1], self.start[2],
                np.concatenate([w[1] for w in self.windows], axis=1),
                np.concatenate([w[2] for w in self.windows], axis=1),
                np.concatenate([w[3] for w in self.windows], axis=1))

    def free(self):
        del self.kernel, self.states, self.ll, self.sources


def run(cell, args, t_start):
    """Set up, measure or trace, and check one walk cell."""
    from portbench.harness import check, common, outcome

    device = outcome.DEVICE
    outcome.load_library()
    if args.trace:
        outcome.open_spans()
    inputs = common.program_inputs(cell)
    w = Walk(cell, inputs, args.seed, device)
    w.warm_up()
    setup_s = outcome.seconds_since(t_start)
    c0 = outcome.counters()
    if args.trace:
        (iters, dt), summary = outcome.trace_windows(
            lambda: w.measure(float("inf"),
                              max_windows=int(cell.traffic["trace_windows"])),
            cell)
    else:
        iters, dt = w.measure(args.seconds)
        summary = None
    torch.cuda.synchronize()
    c1 = outcome.counters()
    if args.trace and args.seconds > dt:
        # the rest of the window untraced, so that the check draws from
        # as long a walk as an untraced run's
        w.measure(args.seconds - dt)
    common.log(f"set-up {setup_s:.3f} s; window {dt:.3f} s")
    mem = torch.cuda.max_memory_allocated()
    failed = int(w.nfail.sum())
    hist = w.history()
    seeds, dtype = w.seeds, w.dtype
    E, K = w.E, w.K
    M = cell.config["simPar"]["num_meas"]
    w.free()
    del w
    torch.cuda.empty_cache()

    o = outcome.Outcome()
    o.memory_peak = mem
    # every proposal's solves over the run's measured windows
    o.attempted = hist[3].shape[1] * E * K * M
    o.failed = failed
    o.e2e = {"walker_steps_per_s": iters * K * E / dt, "setup_s": setup_s}
    o.ctx = outcome.reader_context(cell, c0, c1, summary, iters=iters,
                                   evals=iters)
    t_check = perf_counter()
    o.compared, o.correct = check.walk_verdict(cell, hist, seeds, dtype,
                                               device, args.seed)
    common.log(f"check {perf_counter() - t_check:.3f} s")
    return o
