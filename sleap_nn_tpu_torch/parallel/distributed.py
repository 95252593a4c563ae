"""Processes, ranks and the collectives of data-parallel training.

Port of ``sleap_nn_tpu/parallel/distributed.py`` on ``torch.distributed``:
one process per device, a process group joining them (NCCL between CUDA
devices, gloo on the CPU), the gradients all-reduced by
``DistributedDataParallel``. Where the JAX package joins hosts with
``jax.distributed.initialize``, a process here joins the group.

Launch contract (the JAX package's, or torchrun's):

    SLEAP_NN_TPU_COORDINATOR=host0:8476 \
    SLEAP_NN_TPU_NUM_PROCESSES=4 \
    SLEAP_NN_TPU_PROCESS_ID=<0..3> python -m sleap_nn_tpu_torch.cli train ...

or ``torchrun --nproc-per-node 4 -m sleap_nn_tpu_torch.cli train ...``
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``). A process on CUDA takes the device of its local rank
(``LOCAL_RANK``, else its rank modulo the devices it sees).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

ENV_COORDINATOR = "SLEAP_NN_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "SLEAP_NN_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "SLEAP_NN_TPU_PROCESS_ID"
# How long a group this module creates waits at its rendezvous and at each
# collective: long enough for rank 0's model-dir writes and epoch-end
# evaluation, which the other ranks wait out at their next collective.
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def is_initialized() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join a process group; a no-op for a single-process run.

    A group the caller has already initialized is used as it is. Otherwise
    the arguments, then ``SLEAP_NN_TPU_COORDINATOR`` (``host:port``),
    ``SLEAP_NN_TPU_NUM_PROCESSES`` and ``SLEAP_NN_TPU_PROCESS_ID``, then
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK`` say where to meet. The backend is NCCL where ``device`` (by
    default the card, if there is one) is a CUDA device, gloo otherwise; a
    CUDA process first selects the device of its :func:`local_rank`.

    Returns True when this process is in a group (a group of one
    included). A launch contract that names some of its three values and
    not the others raises ``ValueError``; a group that fails to form
    raises: there is no silent single-process run.
    """
    if is_initialized():
        return True
    addr = coordinator_address or os.environ.get(ENV_COORDINATOR)
    n = num_processes if num_processes is not None else _env_int(ENV_NUM_PROCESSES)
    rank = process_id if process_id is not None else _env_int(ENV_PROCESS_ID)
    if addr is None and n is None and rank is None and os.environ.get("MASTER_ADDR") \
            and _env_int("WORLD_SIZE") is not None:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT') or 29500}"
        n, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if addr is None and n is None and rank is None:
        return False
    missing = [name for name, v in (("coordinator address", addr), ("number of processes", n),
                                    ("process id", rank)) if v is None]
    if missing:
        raise ValueError(
            f"distributed launch: {', '.join(missing)} not given (set {ENV_COORDINATOR}, "
            f"{ENV_NUM_PROCESSES} and {ENV_PROCESS_ID}, or torchrun's MASTER_ADDR, "
            "WORLD_SIZE and RANK)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    if cuda:
        index = torch.device(device).index
        torch.cuda.set_device(index if index is not None else local_rank(rank))
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{addr}",
                            world_size=int(n), rank=int(rank), timeout=GROUP_TIMEOUT)
    return True


def local_rank(rank: Optional[int] = None) -> int:
    """This process's index among the processes of its host: torchrun's
    ``LOCAL_RANK``, else its rank modulo the CUDA devices it sees."""
    env = _env_int("LOCAL_RANK")
    if env is not None:
        return env
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def is_multiprocess() -> bool:
    """Whether the group spans more than one process."""
    return process_count() > 1


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_batch_size(global_batch_size: int) -> int:
    """This process's rows of a global batch (the count must divide it)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} must divide evenly across {n} processes.")
    return global_batch_size // n


def collective_device() -> torch.device:
    """Where the group's tensors live: the current card under NCCL, else
    the CPU."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the group's processes, detached, on ``t``'s
    device (``t`` itself, detached, outside a group)."""
    t = t.detach()
    if not is_initialized():
        return t
    out = t.to(collective_device(), copy=True)
    dist.all_reduce(out)
    return out.to(t.device)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``src``'s ``obj`` on every process (picklable objects)."""
    if not is_multiprocess():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=collective_device())
    return box[0]


def sync_cache_fill_status(local_error: "Exception | None" = None) -> None:
    """Agree on cache-fill success across processes.

    Every process calls this after filling its data cache. If any process
    failed, every process raises: the failing one with its own error, the
    others naming the ranks that failed, so that no healthy rank waits at
    the first collective of training. One all-reduce of a flag per rank.
    Single-process: re-raises the local error or does nothing.
    """
    if not is_multiprocess():
        if local_error is not None:
            raise local_error
        return
    flags = torch.zeros(process_count(), dtype=torch.int32, device=collective_device())
    flags[process_index()] = int(local_error is not None)
    dist.all_reduce(flags)
    if local_error is not None:
        raise local_error
    failed = [i for i, f in enumerate(flags.tolist()) if f]
    if failed:
        raise RuntimeError(
            f"Data-cache fill failed on process(es) {failed}; aborting on all ranks to avoid "
            "a collective deadlock. See the failing rank's log for the original error.")


def barrier(name: str = "sleap_nn_tpu_barrier") -> None:
    """Block until every process reaches this point; a no-op single-process.

    Used at the checkpoint writes, so that no rank races ahead of process
    0's files. ``name`` labels the call site (the JAX package's barriers
    carry one); torch's barrier takes none.
    """
    if not is_multiprocess():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def destroy() -> None:
    """Leave the process group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()
