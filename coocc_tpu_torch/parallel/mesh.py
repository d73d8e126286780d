"""The data-parallel layout: one process per device, the batch split by rows.

Counterpart of coocc_tpu/parallel/mesh.py (reference tools/dist_train.sh,
apis/mmdet_train.py:72-92), in PyTorch's idiom: where JAX builds one Mesh
over every device and shards the batch's leading axis over its 'data'
axis, each process here holds one device and takes its rank's rows of the
global batch (`shard_batch`); the gradients, BatchNorm statistics and
metrics cross processes through the process group (parallel/
distributed.py, parallel/train_step.py).
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from .distributed import local_rank

log = logging.getLogger("coocc_tpu_torch")


class Mesh(NamedTuple):
    """The run's process group (None in one process), this process's rank
    and the world size, and the device the rank computes on."""
    group: Optional[object]
    rank: int
    world: int
    device: torch.device


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK. Ranks past the
    host's cards share them round-robin under gloo (the one backend that
    allows two ranks on one card), and raise under NCCL."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device_type} requested but "
                           "torch.cuda.is_available() is False")
    lr, n = local_rank(), torch.cuda.device_count()
    if lr >= n:
        backend = dist.get_backend() if dist.is_initialized() else None
        if backend != "gloo":
            raise RuntimeError(
                f"local rank {lr} has no card of its own ({n} on this "
                f"host) and the backend is {backend}: NCCL needs one card a "
                "rank (set LOCAL_RANK to the rank's index on its host), or "
                "use gloo to share a card")
        log.info("local rank %d shares card %d (%d on this host, gloo)", lr,
                 lr % n, n)
    dev = torch.device("cuda", lr % n)
    torch.cuda.set_device(dev)
    return dev


def make_mesh(device_type: str = "cuda") -> Mesh:
    """The run's mesh: the default process group (every process; None
    when the process runs alone) and this rank's device (rank_device)."""
    if dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), \
            dist.get_world_size()
    else:
        group, rank, world = None, 0, 1
    return Mesh(group, rank, world, rank_device(device_type))


def shard_batch(batch, rank: int, world: int):
    """Rank `rank`'s rows of a global Batch (numpy arrays or tensors with
    the batch axis first): its B / world consecutive rows, as JAX's
    batch_sharding puts them on device `rank`. None leaves pass through."""
    B = next(len(a) for a in batch if a is not None)
    if B % world:
        raise ValueError(f"a batch of {B} does not split over {world} ranks")
    n = B // world

    def rows(a):
        if a is None:
            return None
        part = a[rank * n:(rank + 1) * n]
        return np.ascontiguousarray(part) if isinstance(part, np.ndarray) \
            else part.contiguous()
    return type(batch)(*(rows(a) for a in batch))
