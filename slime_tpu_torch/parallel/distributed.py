"""Process-group initialisation and cross-process utilities.

Port of ``slime_tpu/parallel/distributed.py``. JAX's
``jax.distributed.initialize`` becomes ``torch.distributed``'s default
process group: one process per card with NCCL, or per CPU worker with gloo
(the tests). Nothing on a machine tells the program of a cluster, so the
caller gives the rendezvous address, the world size and the rank, or sets
the JAX package's environment variables ``COORDINATOR_ADDRESS`` (``host:port``
or a ``tcp://`` / ``file://`` URL), ``NUM_PROCESSES`` and ``PROCESS_ID``, or
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``. Under NCCL each rank is bound to ``cuda:LOCAL_RANK`` (the
process id when no local rank is given). With one process every function
here is a no-op, as in JAX.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: str = "nccl") -> None:
    """Idempotent ``init_process_group`` with the JAX package's environment
    fallbacks; a no-op for one process. ``backend`` is ``"nccl"`` on the
    cards (the default: the port runs on the card) or ``"gloo"`` on the
    CPU."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    if num_processes <= 1 and coordinator_address is None:
        return
    if dist.is_initialized():
        return
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if not address and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not address:
        raise ValueError("initialize: no coordinator address (argument, "
                         "COORDINATOR_ADDRESS or MASTER_ADDR/MASTER_PORT) for a "
                         "multi-process group")
    if "://" not in address:
        address = f"tcp://{address}"
    rank = process_id if process_id is not None else int(
        env.get("PROCESS_ID", env.get("RANK", "0")))
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=rank)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch this process should feed."""
    n = process_count()
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def broadcast_object(obj=None, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (rank 0's decisions: a prompt
    read from stdin, a batch order); ``obj`` itself with one process."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Cross-process sync point (debug/checkpoint coordination); ``name``
    is kept for the JAX signature."""
    if process_count() == 1:
        return
    dist.barrier()
