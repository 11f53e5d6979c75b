"""Tracing, profiling and metrics (the counterpart of
``volrend_tpu/utils/profiling.py``).

The reference's observability is ad-hoc wall timers (cudaEvent in headless,
GLFW-clock FPS in the GUI title bar, chrono PROFILE macros on web). Here:

- ``FrameTimer``: the headless protocol (time N frames end to end, report
  ms/frame + fps + Mrays/s), waiting for the last output's device first;
- ``fps_counter``: the web app's 20-frame moving-average FPS;
- ``Metrics``: rolling metric dict printed per batch and dumpable to JSON
  (absl-style structured stdout without the dependency);
- ``trace``: context manager around ``torch.profiler`` (CPU and CUDA
  activities) writing a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch

__all__ = ["sync", "FrameTimer", "Metrics", "trace", "fps_counter"]


def sync(x) -> None:
    """Wait until the work queued on ``x``'s device is done (a CUDA tensor:
    ``torch.cuda.synchronize`` on its own device; host data: nothing to
    wait for)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class FrameTimer:
    """main_headless.cpp:203-231 protocol: wall time around the frame loop."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.n_frames = 0
        self._t0: Optional[float] = None
        self.elapsed = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def frame(self, n: int = 1) -> None:
        self.n_frames += n

    def stop(self, last_output=None) -> None:
        if last_output is not None:
            sync(last_output)
        self.elapsed = time.perf_counter() - self._t0

    @property
    def ms_per_frame(self) -> float:
        return 1e3 * self.elapsed / max(self.n_frames, 1)

    @property
    def fps(self) -> float:
        return self.n_frames / self.elapsed if self.elapsed else 0.0

    @property
    def mrays_per_s(self) -> float:
        return (self.n_frames * self.width * self.height
                / self.elapsed / 1e6 if self.elapsed else 0.0)

    def report(self) -> str:
        return (f"{self.ms_per_frame:.10f} ms per frame\n"
                f"{self.fps:.10f} fps\n"
                f"{self.mrays_per_s:.3f} Mrays/s")


class fps_counter:
    """20-frame moving-average FPS (web/main_web.cpp:38-76)."""

    def __init__(self, window: int = 20):
        self.window = window
        self._times = []

    def tick(self) -> float:
        now = time.perf_counter()
        self._times.append(now)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])


class Metrics:
    """Per-batch metric accumulation with JSON dump (§5.5)."""

    def __init__(self):
        self.history: list = []

    def log(self, step: int, **kv) -> Dict:
        row = {"step": step, **{k: float(v) for k, v in kv.items()}}
        self.history.append(row)
        print(" ".join([f"step={step}"]
                       + [f"{k}={row[k]:.6g}" for k in kv]), flush=True)
        return row

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.history, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around a code region (CPU activity, and CUDA where a
    card is present); the Chrome trace goes to ``log_dir/trace.json``.
    Profiler errors raise."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
