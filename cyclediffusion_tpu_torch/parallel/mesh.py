"""The process group, the ``data`` mesh and row sharding (counterpart of
``cyclediffusion_tpu.parallel.mesh``; see the package docstring for how
JAX's shardings map onto ranks)."""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits for the others at the group's rendezvous and in a
# collective before it raises
DEFAULT_TIMEOUT_S = 1800


def init_distributed(init_method: Optional[str] = None, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int]:
    """Join the process group -> (rank, world size).

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``); a ``file://`` path needs no port.  ``backend``
    defaults to ``"cpu:gloo,cuda:nccl"`` with a card (NCCL for CUDA
    tensors, gloo for host ones) and ``"gloo"`` without; ``"gloo"``
    carries CUDA tensors through the host, which lets several ranks share
    one card (NCCL refuses two ranks on one device).  A group that cannot be formed raises: there
    is no fallback to one process.  Once joined, later calls return the
    group's position."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("RANK and WORLD_SIZE are unset: launch with torchrun or pass "
                               "rank and world_size")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world_size


def process_position() -> Tuple[int, int]:
    """(this process's rank, the number of processes): the process group's
    when one is initialised, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def data_mesh(device_type: Optional[str] = None):
    """1-D ``DeviceMesh`` named ``"data"`` over every rank of the group."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call init_distributed first")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _default_device_type(),
                            (dist.get_world_size(),), mesh_dim_names=("data",))


def mesh_extent(mesh, dim: str = "data") -> int:
    """The number of ranks along the mesh dimension ``dim``."""
    return mesh.size(mesh.mesh_dim_names.index(dim))


def shard_rows(n: int, index: int, count: int) -> slice:
    """Rows of axis 0 that ``P("data")`` puts on device ``index`` of
    ``count``: a contiguous block of ``n / count`` (``n`` must divide; pad
    with :func:`pad_to_multiple`)."""
    if n % count:
        raise ValueError(f"{n} rows do not split over {count} ranks: pad them with "
                         "pad_to_multiple")
    per = n // count
    return slice(index * per, (index + 1) * per)


def batch_sharding(mesh, n: int, dim: str = "data") -> slice:
    """This rank's block of ``n`` rows on the mesh dimension ``dim``."""
    return shard_rows(n, mesh.get_local_rank(dim), mesh_extent(mesh, dim))


def shard_batch(mesh, tree):
    """This rank's block of axis 0 of every array or tensor in a dict (or of
    one array)."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    return tree[batch_sharding(mesh, len(tree))]


def replicate(mesh, tree, dim: str = "data"):
    """Every tensor of a dict (or one tensor) broadcast in place from the
    first rank of the mesh dimension ``dim``."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v, dim) for k, v in tree.items()}
    group = mesh.get_group(dim)
    dist.broadcast(tree, src=dist.get_global_rank(group, 0), group=group)
    return tree


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order: the all-gather GSPMD inserts to make a sharded array whole."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def pad_to_multiple(arr: np.ndarray, multiple: int):
    """Pad axis 0 to a multiple (repeat-last padding); returns (padded, n)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.repeat(arr[-1:], rem, axis=0)
    return np.concatenate([arr, pad], axis=0), n
