"""Process-group initialisation and the per-process share of the data.

The reference's `audio_transformers_tpu/parallel/distributed.py` on
`torch.distributed`. The port's data parallelism is one process per
device: each process holds a replica of the parameters and its rows of
every global batch, and the collectives of `parallel/mesh.py` average
the gradients and sum the statistics. A single process needs none of it:
there these helpers are no-ops and report one process, so the same
training script runs anywhere.

The process geometry comes from the arguments, else from the reference's
variables (ATX_COORDINATOR "host:port", ATX_NUM_PROCESSES,
ATX_PROCESS_ID), else from torchrun's (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(*names: str, default: int) -> int:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def local_rank() -> int:
    """This process's device index on its host (torchrun's LOCAL_RANK;
    0 without it)."""
    return _env_int("LOCAL_RANK", default=0)


def process_device(device="cuda") -> torch.device:
    """`device`, with a bare "cuda" pinned to this process's card
    (cuda:LOCAL_RANK), the device a torchrun process trains on."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def initialize_if_multihost(coordinator: Optional[str] = None,
                            num_processes: Optional[int] = None,
                            process_id: Optional[int] = None, *,
                            device="cuda",
                            backend: Optional[str] = None) -> bool:
    """Call once at program start. Joins the process group of
    `num_processes` processes over a TCP store at `coordinator`
    ("host:port") and returns True; with one process and no coordinator
    it does nothing and returns False, as the reference does.

    The backend is NCCL for a CUDA `device` and gloo for the CPU unless
    `backend` names one (gloo also reduces CUDA tensors, and it admits
    several processes on one card, which NCCL refuses). A CUDA process
    is pinned to its card (`process_device`) before the group forms. A
    second call in a process that has joined returns True."""
    if dist.is_initialized():
        return True
    num = num_processes or _env_int("ATX_NUM_PROCESSES", "WORLD_SIZE",
                                    default=1)
    if num <= 1 and coordinator is None:
        return False
    if coordinator is None:
        coordinator = os.environ.get("ATX_COORDINATOR")
    if coordinator is None:
        coordinator = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                       f"{os.environ.get('MASTER_PORT', '9911')}")
    rank = (process_id if process_id is not None
            else _env_int("ATX_PROCESS_ID", "RANK", default=0))
    device = process_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator}", world_size=num, rank=rank)
    return True


def shutdown() -> None:
    """Leaves the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_shard(num_samples: int) -> range:
    """This process's contiguous shard of a dataset's index space; the
    last process takes the remainder."""
    n_proc = process_count()
    pid = process_index()
    per = num_samples // n_proc
    start = pid * per
    end = start + per if pid < n_proc - 1 else num_samples
    return range(start, end)


def global_batch_to_local(global_batch_size: int) -> int:
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {n} processes")
    return global_batch_size // n
