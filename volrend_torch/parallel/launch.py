"""Start a group of ranks on one machine: ``spawn(fn, n)`` runs
``fn(rank, *args)`` in n fresh processes joined into one process group
(a ``FileStore`` in a temporary directory: no port to pick), collects what
each returns, and fails fast: the group's collectives and the whole run
have a time limit, a rank that raises fails the run, and every process is
stopped before ``spawn`` returns or raises. The multi-rank tests, the dry
run and the card smoke's sharded phase start their worlds through it; a
job across machines starts its processes with ``torchrun`` and
``multihost.init()`` instead."""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _rank_main(rank: int, fn, n: int, backend: str, store: str, out: str,
               timeout_s: float, threads: Optional[int], args) -> None:
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store, n), rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        res = fn(rank, *args)
        dist.barrier()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: tuple = (), backend: str = "gloo",
          timeout_s: float = 300.0, threads: Optional[int] = None
          ) -> List[Any]:
    """Run ``fn(rank, *args)`` on ranks 0..n-1 of a fresh process group of
    ``backend`` (gloo: CPU tensors, or CUDA tensors of ranks that share a
    card; NCCL: one card a rank); returns each rank's result (saved with
    ``torch.save``: tensors, arrays, numbers). ``fn`` must be importable by
    name (a module-level function). ``timeout_s`` bounds each collective
    and the whole run: past it the ranks are killed and TimeoutError
    raised. ``threads``: each rank's ``torch.set_num_threads``."""
    with tempfile.TemporaryDirectory(prefix="volrend_spawn_") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, backend, store, tmp, timeout_s,
                              threads, args),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks ran past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
