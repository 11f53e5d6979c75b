"""Device resolution for the port's entry points, and host data onto the
device without blocking the host."""

from __future__ import annotations

import numbers
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no card is present — the port never drifts to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "volrend_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev


def to_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (a number, an array or a tensor) as a ``dtype`` tensor on
    ``device``, without blocking the host: a number becomes a fill on the
    device, host arrays reach a card through pinned memory asynchronously.
    (A plain copy from pageable host memory waits for every kernel already
    queued, so the host cannot run ahead of the device.)"""
    if isinstance(x, numbers.Number):
        return torch.full((), x, dtype=dtype, device=device)
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return x.to(device=device, dtype=dtype)
    t = torch.as_tensor(x, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
