"""Codebook-quantized octrees kept in their codebook form on the device
(the counterpart of ``volrend_tpu/models/quantized.py``; BASELINE config
3).

The host loader (``models/n3tree.py``) decodes a codebook-quantized tree
to dense f16 at load, as the reference does (``src/n3tree.cpp:279-340``).
``to_device_quantized`` instead uploads the codebooks and the per-leaf
codes, and the renderers dequantize each leaf as they fetch it
(``QuantLeaves.fetch_rows``, dispatched by ``render_exact._fetch_rows``):
per leaf one row of n_q codes and n_q codebook rows. A leaf holds 2 n_q
bytes of codes where the dense form holds 6 n_q bytes of f16 colours: a
third of the device memory for an SH16 tree, as the compressed npz holds
on disk. The dequant is a gather of small tables, in PyTorch: the
reference leaves it to XLA, and no Pallas kernel exists for it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from volrend_torch.models.n3tree import N3Tree, TreeArrays
from volrend_torch.utils.device import DeviceLike, resolve

__all__ = ["QuantLeaves", "load_quantized", "to_device_quantized"]


class QuantLeaves:
    """The leaf payload of a quantized tree, in place of the dense
    ``TreeArrays.data`` (K, D) f16 tensor.

    codebooks: (n_q, n_codes, 3) float16
    ids:       (K, n_q) int16, each leaf's codebook indices (the uint16
               codes' bits; basis-major)
    sigma:     (K,) float16
    retained:  (K, 3 * n_retain) float16, the first n_retain basis
               functions' colours kept whole, (basis, channel) order
    """

    def __init__(self, codebooks, ids, sigma, retained, n_q: int,
                 n_retain: int, basis_dim: int, data_dim: int):
        self.codebooks, self.ids = codebooks, ids
        self.sigma, self.retained = sigma, retained
        self.n_q, self.n_retain = n_q, n_retain
        self.basis_dim, self.data_dim = basis_dim, data_dim

    @property
    def shape(self):
        return (self.ids.shape[0], self.data_dim)

    @property
    def dtype(self):
        return torch.float16

    @property
    def device(self):
        return self.ids.device

    def nbytes(self) -> int:
        """Device bytes of the codebooks, codes, sigma and retained
        colours."""
        return sum(t.numel() * t.element_size() for t in
                   (self.codebooks, self.ids, self.sigma, self.retained))

    def fetch_rows(self, leaf_idx: torch.Tensor) -> torch.Tensor:
        """Gather and dequantize the leaves ``leaf_idx`` (...,) ->
        (..., data_dim) f16 rows in the dense decode's layout
        (n3tree.cpp:310-340): channel-major [c0: retained..quant, c1: ...,
        c2: ..., sigma]."""
        li = leaf_idx.long()
        shape = li.shape
        n_codes = self.codebooks.shape[1]
        ids = self.ids[li].to(torch.int32) & 0xFFFF              # (..., n_q)
        base = torch.arange(self.n_q, dtype=torch.int32,
                            device=ids.device) * n_codes
        quant = self.codebooks.reshape(-1, 3)[(ids + base).long()]
        ret = self.retained[li].reshape(shape + (self.n_retain, 3))
        cols = torch.cat([ret, quant], -2)                    # (..., nb, 3)
        rgb = cols.transpose(-1, -2).reshape(shape + (-1,))   # channel-major
        return torch.cat([rgb, self.sigma[li][..., None]], -1)


def load_quantized(path_or_dict) -> N3Tree:
    """Parse a compressed npz WITHOUT decoding: an N3Tree whose ``quant``
    attribute holds the raw quantized arrays (``data`` stays None)."""
    if isinstance(path_or_dict, dict):
        npz = path_or_dict
    else:
        with np.load(path_or_dict, allow_pickle=False) as f:
            npz = dict(f.items())
    if "quant_colors" not in npz:
        raise ValueError("not a quantized tree (no quant_colors)")
    tree = N3Tree()
    dense_keys = {k: v for k, v in npz.items()
                  if k not in ("quant_colors", "quant_map", "sigma",
                               "data_retained")}
    # the standard field parsing, with an empty dense payload
    tree.load_npz({**dense_keys,
                   "data": np.zeros((0, 1, 1, 1, 1), np.float16),
                   "data_dim": npz["data_dim"]})
    tree.capacity = int(npz["quant_map"].shape[1])
    tree.data = None
    tree.quant = {
        "quant_colors": np.asarray(npz["quant_colors"], np.float16),
        "quant_map": np.asarray(npz["quant_map"], np.uint16),
        "sigma": np.asarray(npz["sigma"], np.float16),
        "data_retained": (np.asarray(npz["data_retained"], np.float16)
                          if "data_retained" in npz else None),
    }
    return tree


def to_device_quantized(tree: N3Tree, lut_depth: Optional[int] = None,
                        device: DeviceLike = None) -> TreeArrays:
    """Upload a tree from ``load_quantized`` with a QuantLeaves payload
    (no decode) on ``device`` (default CUDA)."""
    q = getattr(tree, "quant", None)
    if q is None:
        raise ValueError("to_device_quantized takes a tree from "
                         "load_quantized")
    dev = resolve(device)
    n_q = int(q["quant_map"].shape[0])
    K = tree.capacity * tree.N3
    ret = q["data_retained"]
    n_retain = int(ret.shape[0]) if ret is not None else 0
    if ret is not None:
        # (n_retain, K, 3) -> (K, n_retain * 3), (basis, channel) order
        retained = np.moveaxis(ret.reshape(n_retain, K, 3), 0, 1
                               ).reshape(K, n_retain * 3)
    else:
        retained = np.zeros((K, 0), np.float16)
    ids = np.moveaxis(q["quant_map"].reshape(n_q, K), 0, 1)
    arrays = tree.to_device(lut_depth=lut_depth, device=dev)
    arrays.data = QuantLeaves(
        codebooks=torch.as_tensor(q["quant_colors"]).to(dev),
        ids=torch.as_tensor(np.ascontiguousarray(ids).view(np.int16)
                            ).to(dev),
        sigma=torch.as_tensor(q["sigma"].reshape(K)).to(dev),
        retained=torch.as_tensor(np.ascontiguousarray(retained)).to(dev),
        n_q=n_q, n_retain=n_retain,
        basis_dim=tree.data_format.basis_dim, data_dim=tree.data_dim)
    return arrays
