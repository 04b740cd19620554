"""PyTorch port resume over a mesh of processes on the CPU: a 2x2 mesh
walk of 6 iterations resumed to 12 from its per-replica checkpoints
equals 12 straight iterations bit for bit."""

import numpy as np
from torch_parity import walk_setup

from metrotrpl_tpu.io.ensemble import load_checkpoint as j_load


def _metro(out, n, **kw):
    from metrotrpl_tpu_torch.inference.metropolis import metro

    over = {k: kw.pop(k) for k in ("load_checkpoint",) if k in kw}
    return metro(*walk_setup(out, n, **over), device="cpu",
                 trap_signals=False, n_ensembles=2, **kw)


def test_mesh_resume_bit_exact(tmp_path):
    """12 straight iterations (the fused walk, which any mesh equals) ==
    6 on a 2x2 mesh + resume to 12 on a 2x2 mesh through a '{e}'
    template, bit for bit for both replicas, each replica's seed
    recovered from its checkpoint."""
    a = _metro(tmp_path / "a", 12, seed=5)
    _metro(tmp_path / "b", 6, seed=5, mesh_shape=(2, 2))
    half = j_load(str(tmp_path / "b" / "CPU1-final.pik"))
    assert half.latest_iter == 6
    b = _metro(tmp_path / "b", 12, mesh_shape=(2, 2),
               load_checkpoint="CPU{e}-final.pik")
    assert [e.ensemble_fields["_rng_seed"] for e in b] == [5, 6]
    for x, y in zip(a, b):
        assert y.latest_iter == 12
        for f in ("states", "loglikelihood", "accept"):
            np.testing.assert_array_equal(getattr(x.H, f), getattr(y.H, f),
                                          err_msg=f)
        np.testing.assert_array_equal(y.H.swap_attempts,
                                      x.H.swap_attempts)
