"""How many devices train or predict, and which rows of a batch each one takes.

Port of ``sleap_nn_tpu/parallel/mesh.py``. The JAX package shards a batch's
leading axis over a 1-D ``data`` mesh (``P("data")``): device ``r`` of
``n`` holds the contiguous rows ``[r * B / n, (r + 1) * B / n)``. In
training each device is a process, which takes those rows; in
data-parallel inference the mesh is a list of devices, each holding one
replica of the models (:func:`get_mesh`, :func:`replicate`), and replica
``r`` predicts those rows (:func:`shard_batch_spec`).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, TypeVar

import torch

T = TypeVar("T")


def available_devices(device) -> int:
    """The devices a run on ``device`` can spread over: the CUDA devices
    this process sees, or 1 on the CPU (as JAX has one on a plain CPU
    host)."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def num_devices(batch_size: int, val_batch_size: int, trainer_devices=None,
                n_avail: int = 1) -> int:
    """The JAX trainer's device count: the largest count that divides both
    batch sizes, at most ``trainer_devices`` (a positive int; anything else
    means every device) and at most ``n_avail``:
    ``gcd(gcd(batch, val_batch), min(trainer_devices or n_avail, n_avail))``."""
    want = trainer_devices if isinstance(trainer_devices, int) and trainer_devices > 0 \
        else n_avail
    return math.gcd(math.gcd(int(batch_size), int(val_batch_size)), min(int(want), n_avail))


def shard_rows(global_batch_size: int, rank: int, n: int) -> slice:
    """Rank ``rank`` of ``n``'s rows of a global batch (``P("data")``)."""
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} must divide evenly across {n} "
                         "devices.")
    rows = global_batch_size // n
    return slice(rank * rows, (rank + 1) * rows)


def get_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None,
             device="cuda") -> List[torch.device]:
    """The devices that each hold a replica: ``devices`` as given (a device
    may repeat: two replicas on one card), else every CUDA device this
    process sees (the first ``num_devices`` of them) for a CUDA ``device``,
    and one for the CPU."""
    if devices is None:
        device = torch.device(device)
        devices = ([torch.device("cuda", i) for i in range(available_devices(device))]
                   if device.type == "cuda" else [device])[:num_devices]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("the mesh holds no device")
    return mesh


def replicate(build: Callable[[torch.device], T], mesh: Sequence[torch.device]) -> List[T]:
    """One replica a device of the mesh: ``build(device)`` makes each, with
    its own copy of every weight and buffer on its device."""
    return [build(d) for d in mesh]


def shard_batch_spec(batch_size: int, mesh: Sequence[torch.device]) -> List[slice]:
    """The rows of a batch each replica of the mesh takes (``P("data")``)."""
    return [shard_rows(batch_size, r, len(mesh)) for r in range(len(mesh))]
