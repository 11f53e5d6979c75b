"""Idempotent pose-sharded render queue with resume (the counterpart of
``volrend_tpu/parallel/work_queue.py``).

The reference exits on any error; a preempted multi-process batch job
should instead resume at the last completed pose batch. This queue:

- shards a pose list across processes (``process_index``/``process_count``,
  ``multihost.process_index`` under torch.distributed);
- records completion in a per-process JSON manifest updated atomically
  after each batch, so a restarted job skips finished work;
- writes outputs through a caller callback (PNG per pose, like
  main_headless.cpp:216-222 — each host writes its own shard).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, List, Optional, Sequence

__all__ = ["RenderQueue"]


class RenderQueue:
    def __init__(self, out_dir: str, n_items: int,
                 process_index: int = 0, process_count: int = 1):
        self.out_dir = out_dir
        self.n_items = n_items
        self.process_index = process_index
        self.process_count = process_count
        os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(
            out_dir, f".manifest_p{process_index:03d}.json")
        self.done = set()
        if os.path.isfile(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    self.done = set(json.load(f)["done"])
            except Exception:
                self.done = set()

    def my_items(self) -> List[int]:
        """This process's shard of item ids (round-robin, like rays across
        chips: independent, order-free)."""
        return [i for i in range(self.n_items)
                if i % self.process_count == self.process_index]

    def pending(self) -> List[int]:
        return [i for i in self.my_items() if i not in self.done]

    def mark_done(self, ids: Sequence[int]) -> None:
        """Atomically persist completion (write-temp + rename)."""
        self.done.update(int(i) for i in ids)
        fd, tmp = tempfile.mkstemp(dir=self.out_dir)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"done": sorted(self.done)}, f)
            os.replace(tmp, self.manifest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def run(self, render_batch: Callable[[List[int]], object],
            batch_size: int = 8,
            finish: Optional[Callable[[List[int], object], None]] = None
            ) -> int:
        """Process pending items in batches; returns #items completed now.

        finish: optional second pipeline stage (PP overlap, SURVEY §2.3):
        ``render_batch(ids)`` should only DISPATCH work (returning e.g. an
        async device array) and ``finish(ids, result)`` synchronizes and
        writes outputs. The queue dispatches batch k+1 BEFORE finishing
        batch k, so device compute overlaps host download/PNG encoding —
        the reference's render/readback pipelining
        (main_headless.cpp:208-223). Items are marked done only after
        their ``finish`` returns (resume safety unchanged). Without
        ``finish``, render_batch is treated as synchronous (old contract).
        """
        todo = self.pending()
        n = 0
        if finish is None:
            for s in range(0, len(todo), batch_size):
                batch = todo[s:s + batch_size]
                render_batch(batch)
                self.mark_done(batch)
                n += len(batch)
            return n
        prev = None
        for s in range(0, len(todo), batch_size):
            batch = todo[s:s + batch_size]
            result = render_batch(batch)         # dispatch (async)
            if prev is not None:
                pids, pres = prev
                finish(pids, pres)               # overlap with `result`
                self.mark_done(pids)
                n += len(pids)
            prev = (batch, result)
        if prev is not None:
            pids, pres = prev
            finish(pids, pres)
            self.mark_done(pids)
            n += len(pids)
        return n
