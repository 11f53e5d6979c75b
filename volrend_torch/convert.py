"""Build the port's objects from plain numpy arrays.

The inputs are the fields of ``volrend_tpu``'s ``TreeArrays`` / ``DenseGrid``
(or any producer of the same layout) as numpy arrays, plus their static
metadata, or a ``Trainer``'s or ``FrameTrainer``'s state; the outputs are
the port's tensor dataclasses, parameters and optimizer state on
``device``. The tests use these to march identical payloads through both
packages, and the trainers' ``restore_checkpoint`` to carry a trainer's
state across.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.models.n3tree import TreeArrays
from volrend_torch.ops.dense_grid import DenseGrid
from volrend_torch.utils.device import DeviceLike, resolve

__all__ = ["tree_from_numpy", "grid_from_numpy",
           "trainer_state_from_numpy", "frame_trainer_state_from_numpy"]


def _t(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """numpy (any dtype numpy can hold, incl. ml_dtypes' bfloat16) ->
    tensor of ``dtype`` on ``dev``."""
    a = _widen_bf16(np.asarray(a))
    # a copy: the source may be a read-only view of another framework's
    # buffer
    return torch.from_numpy(np.array(a, order="C")).to(dev).to(dtype)


def _widen_bf16(a: np.ndarray) -> np.ndarray:
    """bfloat16 values (ml_dtypes' dtype, or the raw 2-byte records an npz
    file holds them as) widened exactly to float32; other arrays as they
    are."""
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise ValueError(f"cannot read a {a.dtype} array as bfloat16")
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)
    return a


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


def _opt_state(opt_leaves: Sequence, optimizer, shapes, dev,
               what: str) -> dict:
    leaves = [torch.from_numpy(np.array(_widen_bf16(np.asarray(x)),
                                        order="C")).to(dev)
              for x in opt_leaves]
    state = optimizer.from_leaves(leaves)
    for name in ("mu", "nu"):
        if [tuple(m.shape) for m in state[name]] != shapes:
            raise ValueError(f"optimizer moments ({name}) do not match the "
                             f"{what}")
    return state


def trainer_state_from_numpy(data, opt_leaves: Sequence, optimizer,
                             device: DeviceLike = None
                             ) -> Tuple[torch.Tensor, dict]:
    """A ray-batch Trainer's state -> the port trainer's f32 master leaf
    rows and optimizer state on ``device``.

    data: the (K, D) leaf rows (a numpy array or a tensor). opt_leaves: the
        optimizer state's leaves in the reference's
        ``jax.tree_util.tree_flatten`` order, ``optax.adam``'s (count, mu,
        nu) or ``lean_adam``'s (m, v, t), as for
        ``frame_trainer_state_from_numpy``. optimizer: the port trainer's
        ``train.Adam``."""
    dev = resolve(device)
    if isinstance(data, torch.Tensor):
        data = data.detach().to(dev, torch.float32)
    else:
        data = _t(data, torch.float32, dev)
    state = _opt_state(opt_leaves, optimizer, [tuple(data.shape)], dev,
                       "leaf rows' shape")
    return data, state


def frame_trainer_state_from_numpy(pyramid: Sequence, opt_leaves: Sequence,
                                   optimizer, device: DeviceLike = None
                                   ) -> Tuple[List[torch.nn.Parameter],
                                              dict]:
    """A FrameTrainer's state -> the port trainer's parameters and
    optimizer state on ``device``.

    pyramid: the pyramid levels, (B, B, B, D) each, coarse to fine (numpy
        arrays or tensors). opt_leaves: the optimizer state's leaves as the
        reference's ``jax.tree_util.tree_flatten`` orders them —
        ``optax.adam``: (count, mu levels..., nu levels...);
        ``volrend_tpu.train.lean_adam``: (m levels..., v levels..., t) —
        bf16 leaves as ml_dtypes arrays or the raw 2-byte records an npz
        holds. optimizer: the port trainer's ``train.Adam`` (its
        ``state_dtype`` says which layout the leaves are in)."""
    dev = resolve(device)
    params = [torch.nn.Parameter(_t(p, torch.float32, dev)
                                 if not isinstance(p, torch.Tensor)
                                 else p.detach().to(dev, torch.float32))
              for p in pyramid]
    state = _opt_state(opt_leaves, optimizer,
                       [tuple(p.shape) for p in params], dev,
                       "pyramid's level shapes")
    return params, state
