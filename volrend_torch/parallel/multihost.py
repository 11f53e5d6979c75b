"""Multi-process runtime glue (the counterpart of
``volrend_tpu/parallel/multihost.py``).

One process a card, started by ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and ``LOCAL_RANK``) or by
hand with a coordinator address; collectives run inside the parallel
layer's calls. This module wraps:

- ``init()``: ``torch.distributed.init_process_group`` from the
  environment (``env://``) or from a coordinator (``VOLREND_COORDINATOR``,
  host:port, with ``VOLREND_NUM_PROCESSES`` and ``VOLREND_PROCESS_ID`` or
  the arguments); a no-op in a single process, so the same entry point
  runs anywhere;
- ``global_mesh()``: a 1-D mesh over every rank of the job;
- ``pose_shard()``: which poses this process renders (round robin; each
  process writes its own PNGs, as the reference's headless renderer writes
  one file a pose).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["init", "global_mesh", "pose_shard", "process_index",
           "process_count"]

_initialized = False


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: Optional[str] = None,
         timeout_s: float = 600.0) -> None:
    """Join the job's process group (idempotent; a single-process no-op
    when neither a coordinator nor ``torchrun``'s environment is set).
    ``backend``: NCCL when a card is present, else gloo, unless named; with
    NCCL each process takes the card of its local rank."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "VOLREND_COORDINATOR")
    launched = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if coordinator_address is None and not launched:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator "
                             f"address (or torchrun's environment)")
        _initialized = True  # single-process mode
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        if num_processes is None:
            num_processes = int(env["VOLREND_NUM_PROCESSES"])
        if process_id is None:
            process_id = int(env["VOLREND_PROCESS_ID"])
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=timeout)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    _initialized = True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis_name: str = "rays", device=None):
    """A flat mesh over every rank of the job (one rank without a process
    group); ``device``: the ranks' device (this rank's card by default)."""
    from volrend_torch.parallel.mesh import make_mesh
    return make_mesh(axis_name, device=device)


def pose_shard(n_poses: int) -> List[int]:
    """Round-robin pose ids for this process."""
    return [i for i in range(n_poses)
            if i % process_count() == process_index()]
