"""The walk's CUDA graphs (inference/mh_core.py, ``_IterationGraphs``)
against the eager walk on the card: the flagship configuration and the
real-data IRF configuration of portbench/configs, two ensembles, two
windows of 12 iterations from the configuration's initial guess (a
tempering round at iterations 10 and 20), every fifth evaluation's rows
to repair cleared in both. Both walks give the same bits
in everything a window returns, count the same solve-kernel launches and
rows, wait for the device once an evaluation, and the graphed one
replays three graphs an iteration. Card only (``cuda``), and no jax:

    python -m pytest --noconftest tests/test_torch_walk_graph.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

CELLS = ["staub-flagship.walk-e8", "staub-real-irf.walk-e8"]
E = 2
WINDOW = 12
N_WINDOWS = 2
SEED = 2 ** 33 + 17
RUNG = ("std", torch.float64)


def _walk(inputs, eager):
    """Both windows of one walk, then a third under the profiler: (the
    windows' outputs as numpy, the kernel counters after the two
    windows, whether each iteration's rung launched, the third window's
    span records)."""
    from metrotrpl_tpu_torch import tracing
    from metrotrpl_tpu_torch.inference import metropolis
    from metrotrpl_tpu_torch.inference.mh_core import TorchDraws
    from metrotrpl_tpu_torch.inference.moves import n_tries
    from metrotrpl_tpu_torch.solver import solve_kernel as sk

    sim_info, param_info, mc, e_data, iniPar, irf_tables = inputs
    rung_ran = []
    calls = [0]
    make = metropolis.make_eval_logll

    def counting(plan, **kw):
        ev = make(plan, **kw)

        def rung(pre):
            calls[0] += 1
            if calls[0] % 5 == 0:   # an evaluation with nothing to repair
                for pg in pre["groups"]:
                    pg["repair"].zero_()
            n = sk.LAUNCHES[RUNG]
            ev.rung(pre)
            rung_ran.append(sk.LAUNCHES[RUNG] > n)
        return ev._replace(rung=rung)

    like_plan, move_plan = metropolis.plans_from_config(
        sim_info, param_info, dict(mc), e_data, iniPar,
        irf_tables=irf_tables)
    names = list(param_info["names"])
    temps = np.asarray(mc["parallel_tempering"], dtype=float)
    base = np.array([param_info["trial_move"][n]
                     if param_info["active"][n] else 0.0 for n in names])
    metropolis.make_eval_logll = counting
    try:
        kernel = metropolis.vmap_ensembles(metropolis.build_mh_kernel(
            like_plan, move_plan, temps, base, int(mc["temper_freq"]), True,
            dtype=torch.float32, device="cuda", _eager=eager))
    finally:
        metropolis.make_eval_logll = make
    K, P = len(temps), len(names)
    sources = [TorchDraws(SEED + e, K, P, n_tries(move_plan),
                          move_plan.mu_constraint is not None,
                          torch.float32, "cuda") for e in range(E)]
    x0 = np.array([param_info["init_guess"][n] for n in names])
    states = torch.as_tensor(np.broadcast_to(x0, (E, K, P)).copy(),
                             dtype=torch.float32, device="cuda")
    ll = kernel.init_ll(states)
    sk.reset_launch_counts()
    rung_ran.clear()
    k, outs = 1, []
    for _ in range(N_WINDOWS):
        out = kernel.run_window(states, ll, k, WINDOW, sources)
        states, ll = out[0], out[1]
        outs.append([a.cpu().numpy() for a in (*out[:5], *out[5])])
        k += WINDOW
    counts = {key: (sk.LAUNCHES[key], sk.ROWS[key]) for key in sk.LAUNCHES}
    ran = list(rung_ran)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        kernel.run_window(states, ll, k, WINDOW, sources)
        torch.cuda.synchronize()
    recs = [r for r in tracing.records() if r.traced]
    tracing.span("off")    # the first span after the profiler stops counting
    return outs, counts, ran, recs


@pytest.fixture(scope="module", params=CELLS)
def walks(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.harness import common

    inputs = common.program_inputs(common.Cell(request.param))
    return {eager: _walk(inputs, eager) for eager in (True, False)}


@pytest.mark.cuda
def test_graphed_windows_equal_the_eager_ones_bit_for_bit(walks):
    """Carried states and ll, swap attempts and accepts, failed solves,
    and the History's states, own ll and accepts, window by window."""
    names = ("states", "ll", "swap_att", "swap_acc", "nfail", "h_states",
             "h_ll", "h_acc")
    for want, got in zip(walks[True][0], walks[False][0]):
        for name, a, b in zip(names, want, got):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
    # the windows held a tempering round that swapped
    assert sum(int(w[2].sum()) for w in walks[False][0]) > 0
    assert sum(int(w[3].sum()) for w in walks[False][0]) > 0


@pytest.mark.cuda
def test_iterations_with_and_without_rung_rows(walks):
    """Each walk had iterations whose rung launched and iterations whose
    ladder had no rows to repair (every fifth evaluation's cleared), at
    the same iterations."""
    eager, graphed = walks[True][2], walks[False][2]
    assert graphed == eager
    assert len(graphed) == N_WINDOWS * WINDOW
    assert any(graphed) and not all(graphed)


@pytest.mark.cuda
def test_kernel_counters_match_the_eager_walk(walks):
    """A replay counts the fast solve's launch and rows as the eager
    launch does; the capture counts nothing."""
    counts = walks[False][1]
    assert counts == walks[True][1]
    n_iter = N_WINDOWS * WINDOW
    assert counts[("std", torch.float32)][0] == n_iter
    assert counts[RUNG][0] == sum(walks[False][2])


@pytest.mark.cuda
@pytest.mark.parametrize("eager, replays", [(True, 0), (False, 3)])
def test_one_sync_an_evaluation_and_the_replays(walks, eager, replays):
    recs = walks[eager][3]
    iters = [r for r in recs if r.name == "metrotrpl.walk.iteration"]
    assert len(iters) == WINDOW
    assert sum(r.syncs for r in recs) == WINDOW
    assert sum(r.name == "metrotrpl.ladder.sync" for r in recs) == WINDOW
    assert sum(r.name == "metrotrpl.walk.replay"
               for r in recs) == replays * WINDOW
