"""PyTorch port over a mesh of processes on the CPU, resuming the JAX
package's checkpoints: a 1x2 mesh resumes the per-replica checkpoints
that JAX metro(n_ensembles=2) wrote."""

import numpy as np
from torch_parity import walk_setup

from metrotrpl_tpu.io.ensemble import load_checkpoint as j_load


def _metro(out, n, **kw):
    from metrotrpl_tpu_torch.inference.metropolis import metro

    over = {k: kw.pop(k) for k in ("load_checkpoint",) if k in kw}
    return metro(*walk_setup(out, n, **over), device="cpu",
                 trap_signals=False, n_ensembles=2, **kw)


def test_mesh_resumes_jax_fused_checkpoints(tmp_path):
    """A 1x2 port mesh resumes the per-replica checkpoints that JAX
    metro(n_ensembles=2) wrote: each replica keeps the JAX walk's first 4
    iterations of History and its stored seed, and walks on to 7 with
    finite log-likelihoods."""
    from metrotrpl_tpu.inference import metro as jmetro

    jmetro(*walk_setup(tmp_path, 4), seed=31, n_ensembles=2,
           trap_signals=False)
    first = [j_load(str(tmp_path / f"CPU{e}-final.pik")) for e in range(2)]
    enss = _metro(tmp_path, 7, mesh_shape=(1, 2),
                  load_checkpoint="CPU{e}-final.pik")
    for j, t in zip(first, enss):
        assert t.latest_iter == 7
        assert t.ensemble_fields["_rng_seed"] == \
            j.ensemble_fields["_rng_seed"]
        for f in ("states", "loglikelihood", "accept"):
            np.testing.assert_array_equal(getattr(t.H, f)[..., :4],
                                          getattr(j.H, f)[..., :4])
        assert np.isfinite(t.H.loglikelihood).all()
    assert [e.ensemble_fields["_rng_seed"] for e in enss] == [31, 32]
