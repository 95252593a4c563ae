"""Data-parallel training over processes (DDP).

Port of ``sleap_nn_tpu/parallel/``: where the JAX package shards a batch
over a 1-D ``data`` mesh and lets XLA all-reduce the gradients, each
device here is a process of a ``torch.distributed`` group that takes its
rows of every global batch, and ``DistributedDataParallel`` all-reduces
the gradients (NCCL between CUDA devices, gloo on the CPU).
"""

from sleap_nn_tpu_torch.parallel.distributed import (
    all_reduce_sum,
    barrier,
    broadcast_object,
    initialize_distributed,
    is_multiprocess,
    local_batch_size,
    local_rank,
    process_count,
    process_index,
    sync_cache_fill_status,
)
from sleap_nn_tpu_torch.parallel.mesh import (
    available_devices,
    num_devices,
    shard_rows,
)

__all__ = [
    "all_reduce_sum",
    "available_devices",
    "barrier",
    "broadcast_object",
    "initialize_distributed",
    "is_multiprocess",
    "local_batch_size",
    "local_rank",
    "num_devices",
    "process_count",
    "process_index",
    "shard_rows",
    "sync_cache_fill_status",
]
