"""What decides ``correct``: the timed path's outputs against the plain
reference that the cell's configuration names (portbench/reference/),
once the window has closed, the peak
memory has been read and the program's state is freed.

A check has two halves. ``*_evidence`` takes from the program's History
what is compared (no reference involved); ``*_judge`` works the same out
with the reference, in float64, and gives the numbers. ``readings.py``
runs the halves apart, so that the reference and its control can judge
one walk's evidence on any device.

Walk cells: from the History the windows copied to the host, a sample
drawn from the seed.

- ``ll_off_share``: states the walk recorded, each with the
  log-likelihood at its chain's temperature that the program computed
  (its fast float32 solve, the rung's float64 repairs, the IRF stage, the
  comparison); the reference works the same out from the state alone.
  The number is the share of sampled states that are off: float32's
  rounding at nx=128 leaves a few states far off in sound runs, and the
  walk keeps the states whose log-likelihood came out too high
  (PERF.md), so a share is compared and not the widest gap.
- ``moves_wrong`` (exact): sampled iterations of sampled ensembles. The
  iteration's draws are made again from the seed as the walk makes them,
  and the proposals from the recorded previous states. Each recorded next
  state must be the proposal where the walk accepted and the previous
  state where it rejected; an accept must hold by the program's own
  log-likelihoods; after a swap round the states must be an order that
  the round's sequence of adjacent swaps can reach.
- ``accepts_missed``: at the same iterations, the proposals that the
  reference's log-likelihood accepts against the previous state's (the
  program's, which the walk compared with) under the walk's own uniform;
  the number is the share of them that the walk rejected. A walk that
  rejects what it should accept (a proposal's log-likelihood too low or
  lost, a comparison turned round) reads near 1.
- ``swaps_wrong``: sampled swap rounds, replayed with the walk's own
  uniforms and the program's log-likelihoods of the round's states at
  every temperature: each state's, as the walk recorded it at the slot
  the round left it in, carried to the other temperatures by the
  reference's ratios between them. The number is the share of rounds
  whose recorded order differs from the replay's. (Replayed with the
  reference's own log-likelihoods, sound rounds differ wherever a state
  that float32 left far off takes part: those states are
  ``ll_off_share``'s to judge; PERF.md.)

Dense cells: ``ll_off_share`` of the ``N_TOP`` samples of the window
with the highest log-likelihood the program returned (the ones that
carry the posterior's weight), each against the reference's at T = 1.
Far from the data, where the ladder's gate leaves float32 rows
unrepaired by design, the log-likelihood runs to -1e6 and float32 can
miss it by tens of percent; those samples weigh nothing.

The limit of each number is the configuration file's (``limits``, per
mode), set from the program's readings and the control's or a planted
fault's (PERF.md); ``moves_wrong`` is exact, with the limit 0.

A state is off where |program - reference| exceeds LL_TOL / T and LL_REL
of |reference| at its chain's temperature T (so LL_TOL in the misfit's
own units at every temperature), or where one side is -inf and the other
is not.
"""

import itertools

import numpy as np
import torch

from portbench.reference import mh

#: a state's log-likelihood at temperature T is off where |program -
#: reference| exceeds LL_TOL / T and LL_REL of |reference|
LL_TOL = 3.0
LL_REL = 3e-2
#: states, iterations and swap rounds a walk cell's check samples; a
#: dense cell's best samples compared
N_STATES = 64
N_ITERS = 8
N_SWAPS = 8
N_TOP = 48


def gaps(prog, ref, temps=1.0):
    """Per state, |prog - ref| in units of its tolerance (> 1 is off) at
    the states' temperatures; -inf on both sides is 0, on one side only
    infinity."""
    tol = np.maximum(LL_TOL / np.asarray(temps, dtype=float),
                     LL_REL * np.abs(np.where(np.isfinite(ref), ref, 0.0)))
    both = np.isneginf(prog) & np.isneginf(ref)
    with np.errstate(invalid="ignore"):
        g = np.where(both, 0.0, np.abs(prog - ref)) / tol
    return np.where(np.isnan(g), np.inf, g)


def reference_lls(ref, setup, states, device, block=256, **prec):
    """The reference ``ref``'s ll (N, K) of each state at every
    temperature of the ladder, ``block`` states at a time."""
    ll, _ = ref.loglik(setup, np.asarray(states, dtype=np.float64),
                       setup.temps, device=device, block=block, **prec)
    return np.asarray(ll, dtype=np.float64)


def reference_ll(ref, setup, states, temps_idx, device, **prec):
    """The reference ``ref``'s ll of each state at its temperature
    index."""
    ll = reference_lls(ref, setup, states, device, **prec)
    return ll[np.arange(len(states)), temps_idx]


def walk_samples(hist, rng, n_states):
    """(e, j, c) of ``n_states`` History entries drawn uniformly."""
    E, n, K, _ = hist[3].shape
    flat = rng.choice(E * n * K, size=min(n_states, E * n * K),
                      replace=False)
    return np.unravel_index(flat, (E, n, K))


def walk_picks(hist, rng, n_iters, swaps, temper_freq):
    """(e, j) of ``n_iters`` iterations drawn uniformly among the swap
    rounds (``swaps``) or among the other iterations."""
    k_first = hist[0]
    E, n, K = hist[3].shape[:3]
    i = k_first + np.arange(n)
    is_swap = (i % temper_freq == 0) & (K > 1)
    js = np.nonzero(is_swap == bool(swaps))[0]
    if not len(js):
        return []
    return [(int(a), int(js[b])) for a, b in
            zip(rng.integers(0, E, n_iters),
                rng.integers(0, len(js), n_iters))]


def walk_evidence(setup, hist, seeds, dtype, device, seed):
    """What a walk check compares, from the program's History (states
    and log-likelihoods as the walk recorded them, and the sampled
    iterations with their draws made again and their proposals), drawn
    from ``seed``: a dict of numpy arrays."""
    k_first, st0, ll0, H_st, H_ll, H_acc = hist
    K, P = H_st.shape[2:]
    mc = setup.cfg["MCMC_fields"]
    temper_freq = int(mc.get("temper_freq", 10))
    n_tries = mh.MAX_PROPOSALS if mc.get("hard_bounds") else 1
    spec = mh.MoveSpec(setup.cfg, setup.temps, dtype, device)
    rng = np.random.default_rng([int(seed) % 2 ** 63, 17])
    e, j, c = walk_samples(hist, rng, N_STATES)
    ev = {"s_states": H_st[e, j, c], "s_ll": H_ll[e, j, c],
          "s_c": np.asarray(c)}
    picks = (walk_picks(hist, rng, N_ITERS, False, temper_freq)
             + walk_picks(hist, rng, N_SWAPS, True, temper_freq))
    rows = {k: [] for k in ("prev", "prev_ll", "prop", "u_acc", "acc",
                            "post", "post_ll", "swap_i", "swap_u")}
    is_swap = []
    for e, j in picks:
        i = k_first + j
        prev = st0[e] if j == 0 else H_st[e, j - 1]
        u_prop, u_acc, swap_i, swap_u = mh.draws(seeds[e], i, K, P, n_tries,
                                                 dtype, device)
        prop = spec.propose(torch.as_tensor(prev, dtype=dtype,
                                            device=device), u_prop)
        for k, v in (("prev", prev),
                     ("prev_ll", ll0[e] if j == 0 else H_ll[e, j - 1]),
                     ("prop", prop.cpu().numpy()),
                     ("u_acc", u_acc.cpu().numpy()), ("acc", H_acc[e, j]),
                     ("post", H_st[e, j]), ("post_ll", H_ll[e, j]),
                     ("swap_i", swap_i.cpu().numpy()),
                     ("swap_u", swap_u.cpu().numpy())):
            rows[k].append(np.asarray(v))
        is_swap.append(K > 1 and i % temper_freq == 0)
    for k, v in rows.items():
        ev[k] = np.stack(v) if v else np.zeros((0,))
    ev["is_swap"] = np.asarray(is_swap, dtype=bool)
    return ev


def _reachable(pre, post, swap_i):
    """Whether some accept / reject sequence of the round's adjacent
    swaps orders the states ``pre`` (K, P) as ``post``."""
    K = len(pre)
    for acc in itertools.product((False, True), repeat=K - 1):
        order = list(range(K))
        for j, a in enumerate(acc):
            if a:
                i = int(swap_i[j])
                order[i], order[i + 1] = order[i + 1], order[i]
        if np.array_equal(pre[order], post):
            return True
    return False


def moves_wrong(ev):
    """The count of recorded steps of the sampled iterations that the
    walk's own draws, proposals and log-likelihoods do not explain
    (exact)."""
    wrong = 0
    for n in range(len(ev["is_swap"])):
        acc = ev["acc"][n]
        pre = np.where(acc[:, None], ev["prop"][n], ev["prev"][n])
        if ev["is_swap"][n]:
            wrong += int(not _reachable(pre, ev["post"][n],
                                        ev["swap_i"][n]))
            continue
        wrong += int(not np.array_equal(ev["post"][n], pre))
        for c in np.nonzero(acc)[0]:
            # an accept must hold by the walk's own numbers
            lr = (np.float32(ev["post_ll"][n][c])
                  - np.float32(ev["prev_ll"][n][c]))
            wrong += int(not ev["u_acc"][n][c] < np.exp(lr))
    return wrong


def accepts(u_acc, prop_ll, prev_ll):
    """Metropolis decisions u < exp(prop_ll - prev_ll) at the chains' own
    temperatures (a NaN difference rejects)."""
    with np.errstate(invalid="ignore", over="ignore"):
        lr = np.asarray(prop_ll, dtype=np.float64) - prev_ll
        return np.where(np.isnan(lr), False, u_acc < np.exp(lr))


def accepts_missed(ev, prop_ll, acc=None):
    """The share of the sampled proposals that the reference's ll
    ``prop_ll`` (n, K) at their own temperatures accepts and the walk
    (or ``acc``) rejected; 0 where the reference accepts none."""
    acc = ev["acc"] if acc is None else acc
    ref = accepts(ev["u_acc"], prop_ll, ev["prev_ll"].astype(np.float64))
    n = int(ref.sum())
    return float((ref & ~acc).sum() / n) if n else 0.0


def swap_replay(L, swap_i, swap_u):
    """The order of a swap round's K states, whose ll at every
    temperature is L (K, K), after its K - 1 adjacent attempts (as the
    walk makes them)."""
    order = list(range(len(L)))
    for i, u in zip(swap_i, swap_u):
        i = int(i)
        a, b = order[i], order[i + 1]
        lr = L[a, i] + L[b, i + 1] - L[b, i] - L[a, i + 1]
        with np.errstate(over="ignore", invalid="ignore"):
            if u < np.exp(-lr):
                order[i], order[i + 1] = b, a
    return order


def carried_lls(ev, n, L):
    """The program's ll (K, K) of swap round n's pre-swap states at every
    temperature: each state's recorded ll at the slot the round left it
    in, carried to the other temperatures by the reference's ll ``L``
    (K, K) of the same states; None where a state is missing after the
    round."""
    acc = ev["acc"][n]
    pre = np.where(acc[:, None], ev["prop"][n], ev["prev"][n])
    post, post_ll = ev["post"][n], ev["post_ll"][n].astype(np.float64)
    out = np.empty_like(L)
    for a in range(len(pre)):
        b = [b for b in range(len(post)) if np.array_equal(post[b], pre[a])]
        if not b:
            return None
        b = b[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            r = L[a] / L[a, b]
        out[a] = np.where(np.isfinite(r), post_ll[b] * r, L[a])
        if not np.isfinite(post_ll[b]):
            out[a] = post_ll[b]
    return out


def swaps_wrong(ev, pre_ll):
    """The share of sampled swap rounds whose recorded order is not the
    replay's under the program's ll of their pre-swap states, carried
    from the reference's ``pre_ll`` (rounds, K, K); None without sampled
    rounds."""
    idx = np.nonzero(ev["is_swap"])[0]
    if not len(idx):
        return None
    wrong = 0
    for r, n in enumerate(idx):
        acc = ev["acc"][n]
        pre = np.where(acc[:, None], ev["prop"][n], ev["prev"][n])
        own = carried_lls(ev, n, pre_ll[r])
        if own is None:
            wrong += 1
            continue
        order = swap_replay(own, ev["swap_i"][n], ev["swap_u"][n])
        wrong += int(not np.array_equal(pre[order], ev["post"][n]))
    return wrong / len(idx)


def walk_batch(ev):
    """The states whose ll the reference works out: the sampled states,
    every proposal of the sampled iterations, and the previous states of
    the sampled swap rounds; and the slices of each."""
    n_s = len(ev["s_states"])
    parts = [ev["s_states"]]
    n_it = len(ev["is_swap"])
    if n_it:
        parts.append(ev["prop"].reshape(-1, ev["prop"].shape[-1]))
        sw = ev["prev"][ev["is_swap"]]
        parts.append(sw.reshape(-1, sw.shape[-1]))
    return np.concatenate(parts).astype(np.float64), n_s


def prop_lls(ev, L):
    """The sampled proposals' ll (n, K) at their own temperatures, from
    the ll ``L`` (N, K) of ``walk_batch(ev)``'s states."""
    n_s, (n_it, K) = len(ev["s_states"]), ev["acc"].shape
    Lp = L[n_s:n_s + n_it * K].reshape(n_it, K, K)
    return Lp[:, np.arange(K), np.arange(K)]


def walk_numbers(ev, L, temps, acc=None):
    """The walk numbers from the ll ``L`` (N, K) at every temperature of
    ``walk_batch(ev)``'s states, against the program's records; with
    ``acc`` (n, K) the proposals' decisions are those and not the
    walk's, as for the control."""
    n_s = len(ev["s_states"])
    c = ev["s_c"]
    out = {"ll_off_share": float(np.mean(
        gaps(ev["s_ll"].astype(np.float64), L[np.arange(n_s), c],
             temps[c]) > 1))}
    n_it = len(ev["is_swap"])
    if not n_it:
        return out
    K = ev["prop"].shape[1]
    Lp = L[n_s:n_s + n_it * K].reshape(n_it, K, K)
    out["accepts_missed"] = accepts_missed(ev, prop_lls(ev, L), acc)
    sw = np.nonzero(ev["is_swap"])[0]
    if len(sw):
        Lprev = L[n_s + n_it * K:].reshape(len(sw), K, K)
        acc = ev["acc"][sw][..., None]
        out["swaps_wrong"] = swaps_wrong(
            ev, np.where(acc, Lp[sw], Lprev))
    return out


def walk_judge(ref, setup, ev, device):
    """(numbers compared [(name, value, limit)], correct) of a walk's
    evidence against the reference."""
    from portbench.harness import common

    states, n_s = walk_batch(ev)
    L = reference_lls(ref, setup, states, device)
    nums = walk_numbers(ev, L, np.asarray(setup.temps, dtype=float))
    lim = setup.cfg["limits"]["walk"]
    compared = [("ll_off_share", nums["ll_off_share"], lim["ll_off_share"]),
                ("moves_wrong", moves_wrong(ev), 0)]
    for k in ("accepts_missed", "swaps_wrong"):
        if nums.get(k) is not None:
            compared.append((k, nums[k], lim[k]))
    common.log(f"walk check: {n_s} states, {int(np.sum(~ev['is_swap']))} "
               f"iterations, {int(np.sum(ev['is_swap']))} swap rounds; "
               f"{len(states)} states through the reference")
    return compared, all(v <= lim for _, v, lim in compared)


def walk_verdict(cell, hist, seeds, dtype, device, seed):
    """(numbers compared [(name, value, limit)], correct) of a walk."""
    setup = cell.setup()
    ev = walk_evidence(setup, hist, seeds, dtype, device, seed)
    return walk_judge(cell.reference, setup, ev, device)


def dense_samples(X, P, n):
    """The n samples with the highest finite log-likelihood."""
    idx = np.argsort(np.where(np.isfinite(P), -P, np.inf), kind="stable")
    return X[idx[:n]], P[idx[:n]]


def dense_verdict(cell, X, P, device):
    """(numbers compared, correct) of a dense cell."""
    from portbench.harness import common

    Xs, Ps = dense_samples(X, P, N_TOP)
    ref = reference_ll(cell.reference, cell.setup(), Xs,
                       np.zeros(len(Xs), dtype=int), device)
    g = gaps(Ps, ref)
    compared = [("ll_off_share", float(np.mean(g > 1)),
                 cell.config["limits"]["dense"]["ll_off_share"])]
    common.log(f"dense check: best {len(Ps)} of {len(P)} samples, ll "
               f"{Ps.max():.6g} .. {Ps.min():.6g}; scaled gaps p50 "
               f"{np.median(g):.4g} max {np.max(g):.4g}")
    return compared, all(v <= lim for _, v, lim in compared)
