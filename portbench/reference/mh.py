"""The Metropolis-Hastings proposal in plain PyTorch, for replaying the
walk's steps from its own recorded states.

The draws of iteration k of an ensemble come from a generator on the
walk's device seeded from (seed, k), in the order the walk consumes them;
the trial move is the log-space uniform displacement with the prior
screen (bounds, p0 > n0, |log tauN - log tauP| <= 2), the first of up to
100 candidates that passes, else the last.
"""

import math

import numpy as np
import torch

#: candidates drawn per chain and iteration under hard bounds
MAX_PROPOSALS = 100
_LN10 = math.log(10.0)


def pow10(x):
    return torch.exp(x * _LN10)


def draws(seed, k, K, P, T, dtype, device):
    """(u_prop (T, K, P), u_acc (K,), swap_i (K-1,), swap_u (K-1,)) of
    iteration k of the ensemble seeded ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, int(k)])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0] >> 1))
    kw = dict(generator=g, dtype=dtype, device=device)
    u_prop = torch.rand((T, K, P), **kw)
    u_acc = torch.rand((K,), **kw)
    swap_i = torch.randint(0, max(K - 1, 1), (max(K - 1, 0),), generator=g,
                           device=device)
    swap_u = torch.rand((max(K - 1, 0),), **kw)
    return u_prop, u_acc, swap_i, swap_u


class MoveSpec:
    """The prior screen and move widths of a configuration."""

    def __init__(self, cfg, temps, dtype, device):
        pi = cfg["param_info"]
        names = list(pi["names"])
        self.names = names
        dev = torch.device(device)
        self.do_log = torch.tensor([bool(pi["do_log"][n]) for n in names],
                                   device=dev)
        self.active = torch.tensor([bool(pi["active"][n]) for n in names],
                                   device=dev)
        bound = [[float(v) for v in pi["prior_dist"][n]] for n in names]
        self.lb = torch.tensor([b[0] for b in bound], dtype=torch.float64,
                               device=dev)
        self.ub = torch.tensor([b[1] for b in bound], dtype=torch.float64,
                               device=dev)
        base = torch.tensor([float(pi["trial_move"][n]) if pi["active"][n]
                             else 0.0 for n in names], dtype=dtype,
                            device=dev)
        tt = torch.as_tensor(np.asarray(temps), dtype=dtype, device=dev)
        self.widths = torch.sqrt(tt)[:, None] * base[None]     # (K, P)
        self.idx = {n: i for i, n in enumerate(names)}

    def approve(self, x):
        raw = torch.where(self.do_log, pow10(x), x)
        ok = torch.all(torch.where(self.active, (self.lb < raw)
                                   & (raw < self.ub), True), dim=-1)
        i = self.idx
        ok = ok & (x[..., i["p0"]] > x[..., i["n0"]])
        ok = ok & (torch.abs(x[..., i["tauN"]] - x[..., i["tauP"]]) <= 2.0)
        return ok

    def propose(self, state, u_prop):
        """Proposals (K, P) from states (K, P) and draws (T, K, P)."""
        x = torch.where(self.do_log, torch.log10(state), state)
        new = x[None] + self.widths[None] * (2.0 * u_prop - 1.0)
        ok = self.approve(new)
        T = new.shape[0]
        first = torch.argmax(ok.to(torch.int32), dim=0)
        pick = torch.where(ok.any(dim=0), first, T - 1)
        chosen = new[pick, torch.arange(new.shape[1], device=new.device)]
        out = torch.where(self.do_log, pow10(chosen), chosen)
        return torch.where(self.widths > 0, out, state)
