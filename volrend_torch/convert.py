"""Build the port's tree and grid objects from plain numpy arrays.

The inputs are the fields of ``volrend_tpu``'s ``TreeArrays`` / ``DenseGrid``
(or any producer of the same layout) as numpy arrays, plus their static
metadata; the outputs are the port's tensor dataclasses on ``device``.
The tests use these to march identical payloads through both packages.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.models.n3tree import TreeArrays
from volrend_torch.ops.dense_grid import DenseGrid
from volrend_torch.utils.device import DeviceLike, resolve

__all__ = ["tree_from_numpy", "grid_from_numpy"]


def _t(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """numpy (any dtype numpy can hold, incl. ml_dtypes' bfloat16) ->
    tensor of ``dtype`` on ``dev``."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # bfloat16 has no numpy dtype of its own: widen exactly to f32
        a = a.astype(np.float32)
    # a copy: the source may be a read-only view of another framework's
    # buffer
    return torch.from_numpy(np.array(a, order="C")).to(dev).to(dtype)


def tree_from_numpy(child, data, offset, scale, extra, lut, *, N: int,
                    data_dim: int, basis_dim: int, fmt, max_depth: int,
                    lut_depth: int,
                    ndc: Optional[Tuple[float, float, float]] = None,
                    device: DeviceLike = None) -> TreeArrays:
    """TreeArrays fields as numpy arrays -> the port's TreeArrays."""
    dev = resolve(device)
    return TreeArrays(
        child=_t(child, torch.int32, dev).reshape(-1),
        data=_t(data, torch.float16, dev),
        offset=_t(offset, torch.float32, dev),
        scale=_t(scale, torch.float32, dev),
        extra=_t(extra, torch.float32, dev),
        lut=_t(lut, torch.int32, dev),
        N=int(N), data_dim=int(data_dim), basis_dim=int(basis_dim),
        fmt=BasisType(int(fmt)), max_depth=int(max_depth),
        lut_depth=int(lut_depth),
        ndc=None if ndc is None else tuple(float(v) for v in ndc))


def grid_from_numpy(data, offset, scale, extra, qscale, sigma_grid, *,
                    G: int, data_dim: int, basis_dim: int, fmt,
                    quantized: bool, occ_max=None,
                    ndc: Optional[Tuple[float, float, float]] = None,
                    device: DeviceLike = None) -> DenseGrid:
    """DenseGrid fields as numpy arrays -> the port's DenseGrid.

    data: (G,G,G,D) float16, or (G,G,G,D+1) int8 when ``quantized``;
    sigma_grid: (G,G,G) bfloat16 values (any float numpy dtype holding
    them exactly)."""
    dev = resolve(device)
    data = np.asarray(data)
    ddt = torch.int8 if quantized else torch.float16
    if occ_max is not None:
        occ_max = tuple(tuple(float(v) for v in row) for row in occ_max)
    return DenseGrid(
        data=_t(data, ddt, dev),
        offset=_t(offset, torch.float32, dev),
        scale=_t(scale, torch.float32, dev),
        extra=_t(extra, torch.float32, dev),
        qscale=_t(qscale, torch.float32, dev),
        sigma_grid=(None if sigma_grid is None
                    else _t(sigma_grid, torch.bfloat16, dev)),
        G=int(G), data_dim=int(data_dim), basis_dim=int(basis_dim),
        fmt=BasisType(int(fmt)), quantized=bool(quantized),
        occ_max=occ_max,
        ndc=None if ndc is None else tuple(float(v) for v in ndc))
