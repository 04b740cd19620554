#!/usr/bin/env python3
"""Extend the committed flagship reference-math chain (the port of
scripts/extend_oracle.py).

Resumes scripts/.oracle_tmh_3200_20260816_9879b0941d.npz, the serial
float64 LSODA Metropolis chain on the flagship dataset
(posterior_torch.run_oracle_mh, posterior_compare.run_oracle_mh line for
line), or this script's own partial, toward a target iteration count,
saving the partial every 100 iterations.

Proposal: a fixed symmetric Gaussian whose covariance is the committed
chain's own post-burn covariance (log10 of draws [3200 // 3 : 3200]) x
2.38^2 / 10. A symmetric fixed proposal leaves the stationary
distribution as it is, so the continued chain still targets the
reference-math posterior. Each resumed run draws from the substream
posterior_torch.oracle_seed(w, cov, n_done), as extend_oracle.py does;
the partial records where it was resumed (``resumed_at``) with each run's
s per iteration and worker count.

Each iteration's 6 curves are solved in a pool of --workers spawned
processes (one BLAS thread each) that lives as long as the chain; no
card is needed. The chain stops on any exception and leaves its last
partial, from which the next run resumes; SIGTERM stops it after the
iteration under way, at a partial written there.

Usage:
    python scripts/extend_oracle_torch.py [target] [--workers N]
        [--out-dir DIR]

Output: DIR/.oracle_tmh_ext_torch_<target>_20260816.npz when the target
is reached, and its .partial.npz (read by flagship_torch.py --oracle,
which takes the draws to n_done) every 100 iterations.
"""

import argparse
import os
import signal
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import flagship_torch as ft  # noqa: E402
import posterior_torch as pt  # noqa: E402

PRESERVED = ft.ORACLE_CHAIN
#: the committed chain's length; its first third is its burn-in
N_PRESERVED = 3200
#: the extension's default target (extend_oracle.py's)
TARGET = 12000


def chain_path(out_dir, target, seed):
    """The extended chain's file; its partial is this + ".partial.npz"."""
    return os.path.join(out_dir, f".oracle_tmh_ext_torch_{target}_{seed}.npz")


def committed_extension(target=TARGET, out_dir=HERE):
    """The extended chain in out_dir, the finished one or else its partial,
    or None if there is neither."""
    out = chain_path(out_dir, target, ft.flagship_workload().seed)
    for path in (out, out + ".partial.npz"):
        if os.path.exists(path):
            return path
    return None


def load_resume(partial, active):
    """The resume dict of run_oracle_mh from this script's partial if it
    exists, else (and when partial is None) from the committed chain."""
    if partial is not None and os.path.exists(partial):
        prev = np.load(partial)
        extra = {k: list(prev[k]) for k in ("resumed_at", "s_per_iter",
                                             "workers") if k in prev.files}
        return {"n_done": int(prev["n_done"]), "acc": float(prev["acc"]),
                **extra, **{k: np.asarray(prev[k]) for k in active}}
    z = np.load(PRESERVED)
    return {"n_done": len(z[active[0]]), "acc": float(z["acc"]),
            **{k: np.asarray(z[k]) for k in active}}


def proposal(resume, active):
    """(cov, start): the committed chain's post-burn log10 covariance x
    2.38^2 / d, and its last draw."""
    burn = N_PRESERVED // 3
    X = np.log10(np.stack([resume[k][burn:N_PRESERVED] for k in active],
                          axis=1))
    cov = np.cov(X.T) * (2.38 ** 2 / len(active))
    return cov, {k: float(resume[k][-1]) for k in active}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("target", nargs="?", type=int, default=TARGET)
    ap.add_argument("--workers", type=int,
                    default=min(6, os.cpu_count() or 1))
    ap.add_argument("--out-dir", default=None,
                    help="where the chain and its partial go (default: "
                         "scripts/)")
    args = ap.parse_args(argv)
    w = ft.flagship_workload()
    out = chain_path(args.out_dir or HERE, args.target, w.seed)
    partial = out + ".partial.npz"
    resume = load_resume(partial, w.active)
    print(f"{'resuming' if os.path.exists(partial) else 'starting'} the "
          f"extension at {resume['n_done']}/{args.target} on "
          f"{args.workers} worker(s)", flush=True)
    cov, start = proposal(resume, w.active)
    t, vals, _ = ft.checked_dataset(w)
    # SIGTERM ends the chain after the iteration under way, at a partial
    signals = []
    handler = signal.signal(signal.SIGTERM,
                            lambda signum, frame: signals.append(signum))
    try:
        samples, acc = pt.run_oracle_mh(
            w, t, vals, args.target, partial_path=partial, resume=resume,
            cov=cov, start=start, workers=args.workers,
            log=lambda s: print(s, flush=True), stop=lambda: bool(signals))
    finally:
        signal.signal(signal.SIGTERM, handler)
    if signals:
        sys.exit(f"stopped by signal {signals[0]}; resume from {partial}")
    runs = np.load(partial)       # written at the target's iteration
    np.savez(out, acc=acc, **samples,
             **{k: runs[k] for k in ("n_done", "resumed_at", "s_per_iter",
                                     "workers")})
    print(f"done: {args.target} iterations, acceptance {acc:.3f} -> {out}",
          flush=True)


if __name__ == "__main__":
    main()
