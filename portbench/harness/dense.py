"""The dense cells: the dense sampler of ``cli dense``
(``inference.dense.bayes``), called again and again on prior samples
drawn from the seed, each call a fixed number of chunks.

Set-up makes one call of one chunk, which loads the kernel library and
touches the chunk's shapes; the measured calls follow.
"""

import copy
from time import perf_counter

import numpy as np


class Dense:
    """The program under test of a dense cell."""

    def __init__(self, cell, inputs, seed, device):
        sim_info, param_info, mc, e_data, iniPar, irf_tables = inputs
        tr = cell.traffic
        self.chunk = int(tr["chunk"])
        self.per_call = int(tr["chunks_per_call"]) * self.chunk
        self.args = (iniPar, sim_info, e_data, dict(mc), param_info)
        if irf_tables:
            self.args[3]["_IRF_tables"] = irf_tables
        self.seed = int(seed)
        self.device = device
        self.calls = []          # (X, P) of every measured call
        self.n_call = 0

    def _call(self, n):
        from metrotrpl_tpu_torch.inference.dense import bayes

        iniPar, sim_info, e_data, flags, param_info = self.args
        flags = dict(flags, num_iters=n)
        # call i draws its samples from (seed, i)
        s = int(np.random.SeedSequence([self.seed, self.n_call])
                .generate_state(1, np.uint64)[0] >> 1)
        self.n_call += 1
        _, P, X = bayes(None, None, iniPar, sim_info, e_data, flags,
                        copy.deepcopy(param_info), chunk=self.chunk, seed=s,
                        device=self.device)
        return X, P

    def warm_up(self):
        import torch

        self._call(self.chunk)
        torch.cuda.synchronize()

    def measure(self, seconds, max_calls=None):
        """Calls until ``seconds`` have passed: (samples, wall seconds)."""
        t0 = perf_counter()
        n = 0
        while True:
            self.calls.append(self._call(self.per_call))
            n += 1
            dt = perf_counter() - t0
            if dt >= seconds or (max_calls and n >= max_calls):
                return n * self.per_call, dt

    def samples(self):
        return (np.concatenate([c[0] for c in self.calls]),
                np.concatenate([c[1] for c in self.calls]))


def run(cell, args, t_start):
    """Set up, measure or trace, and check one dense cell."""
    import torch

    from portbench.harness import check, common, outcome

    device = outcome.DEVICE
    outcome.load_library()
    inputs = common.program_inputs(cell)
    d = Dense(cell, inputs, args.seed, device)
    d.warm_up()
    setup_s = outcome.seconds_since(t_start)
    c0 = outcome.counters()
    if args.trace:
        (n, dt), summary = outcome.trace_windows(
            lambda: d.measure(float("inf"),
                              max_calls=int(cell.traffic["trace_calls"])),
            cell)
    else:
        n, dt = d.measure(args.seconds)
        summary = None
    torch.cuda.synchronize()
    c1 = outcome.counters()
    if args.trace and args.seconds > dt:
        # the rest of the window untraced, so that the check draws from
        # as many samples as an untraced run's
        d.measure(args.seconds - dt)
    common.log(f"set-up {setup_s:.3f} s; window {dt:.3f} s")
    mem = torch.cuda.max_memory_allocated()
    X, P = d.samples()
    del d
    torch.cuda.empty_cache()

    o = outcome.Outcome()
    o.memory_peak = mem
    o.attempted = len(P)
    # a sample fails where the sampler gives no log-likelihood (NaN, or
    # +inf, which no misfit gives). -inf is an answer: the curve's solve
    # is conceded by the ladder or rejected by the comparison (most
    # often a decay that underflows within the window), as the
    # reference's is; about half of the prior box reads so.
    o.failed = int(np.sum(np.isnan(P) | np.isposinf(P)))
    o.e2e = {"dense_samples_per_s": n / dt, "setup_s": setup_s}
    o.ctx = outcome.reader_context(cell, c0, c1, summary, samples=n,
                                   evals=n // int(cell.traffic["chunk"]))
    t_check = perf_counter()
    o.compared, o.correct = check.dense_verdict(cell, X, P, device)
    common.log(f"check {perf_counter() - t_check:.3f} s")
    return o
