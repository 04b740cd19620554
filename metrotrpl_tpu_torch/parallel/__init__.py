"""The sharded walk: tempered ensembles and chains split over processes.

Counterpart of ``metrotrpl_tpu/parallel``. JAX runs one SPMD program over
a ``Mesh(("ens", "chains"))`` of devices; here every cell of the
(d_e, d_c) grid is a process of a ``torch.distributed`` world, rank
``r = i_e * d_c + i_c``, holding the block of E/d_e ensembles x K/d_c
chains that JAX's device held. Its share of the solve batch never leaves
it; only the tempering swap's tiny (K, P) states and (K, K) likelihood
matrices and the History rows move, over the chains group of its
ensemble block. JAX's ``make_sim_sharding`` / ``shard_states_fn`` and
the ``shard_batch`` hook of its single-device kernel are hints to the
XLA partitioner; where the process structure does the partitioning they
have no counterpart.
"""

from metrotrpl_tpu_torch.parallel.mesh import (  # noqa: F401
    ChainMesh,
    make_chain_mesh,
    mesh_backend,
    mesh_devices,
)
