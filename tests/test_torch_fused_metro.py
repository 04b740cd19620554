"""PyTorch port end to end over E ensembles: metro(n_ensembles=E) on the
CPU equals E separate metro runs, writes one checkpoint per replica that
the JAX package loads, resumes bit for bit through a '{e}' template, and
resumes the per-replica checkpoints the JAX metro wrote."""

import os

import numpy as np
import pytest
from torch_parity import walk_setup

from metrotrpl_tpu.io.ensemble import load_checkpoint as j_load


def _metro(out, n, **kw):
    from metrotrpl_tpu_torch.inference.metropolis import metro

    over = {k: kw.pop(k) for k in ("load_checkpoint",) if k in kw}
    return metro(*walk_setup(out, n, **over), device="cpu",
                 trap_signals=False, **kw)


def test_metro_n_ensembles_matches_separate_runs(tmp_path):
    """metro(n_ensembles=2) equals two separate port metro runs at seeds s
    and s + 1: History and swap counters bit for bit, one checkpoint per
    replica that the JAX package loads, and the replicas differ."""
    enss = _metro(tmp_path / "fused", 7, seed=21, n_ensembles=2)
    assert len(enss) == 2
    for e, seed in enumerate((21, 22)):
        solo = _metro(tmp_path / f"solo{e}", 7, seed=seed,
                      export_path="f.pik")
        back = j_load(str(tmp_path / "fused" / f"CPU{e}-final.pik"))
        for ens in (enss[e], back):
            for a in ("states", "loglikelihood", "accept", "swap_attempts",
                      "swap_accept"):
                np.testing.assert_array_equal(getattr(ens.H, a),
                                              getattr(solo.H, a), err_msg=a)
        assert back.latest_iter == 7
        assert back.ensemble_fields["_rng_seed"] == seed
    assert np.isfinite(enss[0].H.loglikelihood).all()
    assert enss[0].H.swap_attempts.sum() > 0
    assert not np.array_equal(enss[0].H.states, enss[1].H.states)


def test_metro_n_ensembles_resume_bit_exact(tmp_path):
    """12 straight iterations == 6 + per-replica checkpoints + resume to
    12 through a '{e}' template, bit for bit for both replicas, with each
    replica's stored seed recovered; a plain name cannot resume two
    replicas."""
    a = _metro(tmp_path / "a", 12, seed=5, n_ensembles=2)
    _metro(tmp_path / "b", 6, seed=5, n_ensembles=2)
    b = _metro(tmp_path / "b", 12, n_ensembles=2,
               load_checkpoint="CPU{e}-final.pik")
    assert [e.ensemble_fields["_rng_seed"] for e in b] == [5, 6]
    for x, y in zip(a, b):
        assert y.latest_iter == 12
        np.testing.assert_array_equal(x.H.states, y.H.states)
        np.testing.assert_array_equal(x.H.loglikelihood, y.H.loglikelihood)
        np.testing.assert_array_equal(x.H.accept[:, 6:], y.H.accept[:, 6:])
    with pytest.raises(ValueError, match="per-replica"):
        _metro(tmp_path / "b", 12, n_ensembles=2,
               load_checkpoint="CPU0-final.pik")


def test_port_resumes_jax_fused_checkpoints(tmp_path):
    """The port resumes the per-replica checkpoints that JAX
    metro(n_ensembles=2) wrote: each replica keeps the JAX walk's first 4
    iterations of History and its stored seed, and walks on to 7 with
    finite log-likelihoods."""
    from metrotrpl_tpu.inference import metro as jmetro

    jmetro(*walk_setup(tmp_path, 4), seed=31, n_ensembles=2,
           trap_signals=False)
    first = [j_load(str(tmp_path / f"CPU{e}-final.pik")) for e in range(2)]
    enss = _metro(tmp_path, 7, n_ensembles=2,
                  load_checkpoint="CPU{e}-final.pik")
    for j, t in zip(first, enss):
        assert t.latest_iter == 7
        assert t.ensemble_fields["_rng_seed"] == \
            j.ensemble_fields["_rng_seed"]
        for a in ("states", "loglikelihood", "accept"):
            np.testing.assert_array_equal(getattr(t.H, a)[..., :4],
                                          getattr(j.H, a)[..., :4])
        assert np.isfinite(t.H.loglikelihood).all()
    assert [e.ensemble_fields["_rng_seed"] for e in enss] == [31, 32]
    assert os.path.exists(str(tmp_path / "CPU1-final.pik"))
