"""The process grid of the sharded walk (JAX ``parallel/mesh.py``).

A (d_e, d_c) grid of ``torch.distributed`` ranks, rank ``r = i_e * d_c +
i_c``: axis "ens" splits the E ensembles, axis "chains" the K tempered
chains of each. Each rank gets one device, named explicitly: by default
one card of its own; ranks share a card only when the caller says so.
The backend follows from the devices: NCCL when every rank has a card of
its own; gloo when two ranks share a card (NCCL refuses two ranks on one
GPU) and on the CPU. Under gloo the collectives' few hundred bytes go
through the host; the solves stay on the rank's device either way.
"""

from datetime import timedelta
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from metrotrpl_tpu_torch import resolve_device


class CommCount:
    """The collectives a rank made over its chains group and the bytes it
    put into them (its own buffer, once per collective)."""
    __slots__ = ("collectives", "bytes")

    def __init__(self):
        self.collectives = 0
        self.bytes = 0

    def add(self, buf):
        self.collectives += 1
        self.bytes += buf.numel() * buf.element_size()


class ChainMesh(NamedTuple):
    """One rank's place in the (d_e, d_c) grid."""
    shape: tuple                 # (d_e, d_c)
    rank: int                    # i_e * d_c + i_c
    i_e: int                     # ensemble block
    i_c: int                     # chain block
    device: torch.device         # where the rank walks and solves
    backend: str                 # "nccl" or "gloo"
    chains_group: object         # the d_c ranks of ensemble block i_e
    comm_device: torch.device    # where the collectives' tensors live
    comm: Optional[CommCount] = None   # what the rank's collectives sent
    #                              (make_chain_mesh's; None: no world)


def mesh_devices(mesh_shape, devices=None, device="cuda"):
    """The device of each rank of a ``mesh_shape = (d_e, d_c)`` grid, in
    rank order.

    devices : one device per rank (strings or ``torch.device``); ranks
        may share a card, e.g. ``["cuda:0"] * 4``.
    device : without ``devices``: "cpu" puts every rank on the CPU; a
        CUDA device gives rank r its own card ``cuda:r`` and raises where
        the host has fewer cards than ranks (as JAX's run_mh_sharded does).
    """
    d_e, d_c = (int(x) for x in mesh_shape)
    if d_e < 1 or d_c < 1:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} must be two "
                         "positive counts")
    n = d_e * d_c
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"mesh_shape {(d_e, d_c)} has {n} ranks but "
                             f"{len(devs)} devices were given")
    elif resolve_device(device).type == "cpu":
        devs = [torch.device("cpu")] * n
    else:
        avail = torch.cuda.device_count()
        if avail < n:
            raise ValueError(
                f"mesh_shape {(d_e, d_c)} needs {n} devices; only {avail} "
                f"available (pass devices, e.g. ['cuda:0'] * {n}, for "
                "ranks that share a card)")
        devs = [torch.device("cuda", r) for r in range(n)]
    out = []
    for d in devs:
        if d.type == "cuda":
            d = torch.device("cuda", 0 if d.index is None else d.index)
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"{d} requested; the host has "
                                 f"{torch.cuda.device_count()} cards")
        elif d.type != "cpu":
            raise ValueError(f"unsupported mesh device {d}")
        out.append(d)
    return out


def mesh_backend(devices):
    """``nccl`` when every rank has a card of its own, else ``gloo`` (two
    ranks on one card, or the CPU)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def make_chain_mesh(mesh_shape, devices, backend=None, timeout=None):
    """This rank's :class:`ChainMesh` (the JAX ``Mesh``, seen from one
    process). Needs the default process group of d_e * d_c ranks; every
    rank calls it, since it creates every ensemble block's chains group,
    in the same order on every rank.

    devices : every rank's device (:func:`mesh_devices`).
    backend : the default group's backend (default :func:`mesh_backend`).
    timeout : seconds a collective of the chains groups may wait.
    """
    d_e, d_c = (int(x) for x in mesh_shape)
    if not dist.is_initialized():
        raise RuntimeError("make_chain_mesh needs an initialised default "
                           "process group")
    if dist.get_world_size() != d_e * d_c or len(devices) != d_e * d_c:
        raise ValueError(f"a {d_e}x{d_c} mesh needs {d_e * d_c} ranks and "
                         f"devices; the world has {dist.get_world_size()} "
                         f"ranks, {len(devices)} devices were given")
    backend = backend or mesh_backend(devices)
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    groups = [dist.new_group(list(range(i * d_c, (i + 1) * d_c)),
                             backend=backend, **kw) for i in range(d_e)]
    rank = dist.get_rank()
    i_e, i_c = divmod(rank, d_c)
    device = torch.device(devices[rank])
    comm = device if backend == "nccl" else torch.device("cpu")
    return ChainMesh(shape=(d_e, d_c), rank=rank, i_e=i_e, i_c=i_c,
                     device=device, backend=backend,
                     chains_group=groups[i_e], comm_device=comm,
                     comm=CommCount())
