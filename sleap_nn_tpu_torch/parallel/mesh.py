"""How many devices train, and which rows of a batch each one takes.

Port of ``sleap_nn_tpu/parallel/mesh.py``. The JAX package shards a batch's
leading axis over a 1-D ``data`` mesh (``P("data")``): device ``r`` of
``n`` holds the contiguous rows ``[r * B / n, (r + 1) * B / n)``. Here each
device is a process, and each process takes those rows.
"""

from __future__ import annotations

import math

import torch


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
