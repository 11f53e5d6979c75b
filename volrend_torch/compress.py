"""Octree compression: median-cut color quantization (svox-compatible npz).

Re-implements the reference pipeline (``scripts/compress_octree.py``) without
the svox CUDA extension: per-SH-basis median-cut quantization of leaf colors
to a 2^bits codebook, sigma thresholding, optional retained (uncompressed)
first-k coefficients, written in the exact npz schema the reference loader
decodes (``src/n3tree.cpp:279-340``): ``quant_colors`` (n_q, 2^bits, 3) f16,
``quant_map`` (n_q, capacity, N, N, N) u16, ``sigma``, ``data_retained``.

The quantizer is a vectorized level-wise median cut: every live box splits
at the median of its widest dimension each level (bits levels -> 2^bits
boxes), O(bits * M log M) with no Python per-box loops.

The port's own copy of ``volrend_tpu/compress.py`` (NumPy only): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["quantize_median_cut", "compress_tree"]


def quantize_median_cut(points: np.ndarray, bits: int = 16,
                        weights: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize (M, 3) colors to a 2^bits codebook.

    Returns (colors (2^bits, 3) f32 box means, ids (M,) uint32).
    weights: optional per-point weights for the box means (the reference's
    --weighted mode weights by opacity).
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    M = pts.shape[0]
    n_boxes = 1 << bits
    if M == 0:
        return np.zeros((n_boxes, 3), np.float32), np.zeros(0, np.uint32)

    box = np.zeros(M, np.int64)
    for _level in range(bits):
        order = np.argsort(box, kind="stable")
        b_sorted = box[order]
        # segment boundaries of each live box
        starts = np.flatnonzero(np.r_[True, b_sorted[1:] != b_sorted[:-1]])
        live = b_sorted[starts]
        # widest dimension + split threshold (box mean along it) per box;
        # mean-threshold splitting separates gapped clusters that a pure
        # count-median split would straddle, and matches it on smooth data
        seg_min = np.stack([np.minimum.reduceat(pts[order, c], starts)
                            for c in range(3)], -1)
        seg_max = np.stack([np.maximum.reduceat(pts[order, c], starts)
                            for c in range(3)], -1)
        seg_sum = np.stack([np.add.reduceat(pts[order, c], starts)
                            for c in range(3)], -1)
        counts = np.diff(np.r_[starts, M])
        wdim = np.argmax(seg_max - seg_min, -1)             # (n_live,)
        thresh = (seg_sum[np.arange(live.size), wdim]
                  / counts)                                  # (n_live,)
        inv_box = np.searchsorted(live, box)                # per point
        key = pts[np.arange(M), wdim[inv_box]]
        box = box * 2 + (key > thresh[inv_box])

    # box means
    w = (np.ones(M, np.float64) if weights is None or weights.size == 0
         else np.asarray(weights, np.float64).reshape(-1))
    colors = np.zeros((n_boxes, 3), np.float64)
    counts = np.bincount(box, weights=w, minlength=n_boxes)
    for c in range(3):
        colors[:, c] = np.bincount(box, weights=pts[:, c] * w,
                                   minlength=n_boxes)
    colors /= np.maximum(counts, 1e-12)[:, None]
    return colors.astype(np.float32), box.astype(np.uint32)


def compress_tree(npz: Dict[str, np.ndarray], bits: int = 16,
                  sigma_thresh: float = 2.0, retain: int = 1,
                  weighted: bool = False) -> Dict[str, np.ndarray]:
    """Apply the reference compression to a dense-tree npz dict.

    Strips training-only keys, kills sub-threshold voxels, quantizes each
    SH basis independently; returns a new npz dict the loader can decode.
    """
    z = {k: np.asarray(v) for k, v in npz.items()}
    for k in ("parent_depth", "geom_resize_fact", "n_free", "n_internal",
              "depth_limit"):
        z.pop(k, None)
    data = np.asarray(z["data"], np.float32)
    N = data.shape[1]
    sigma = data[..., -1].reshape(-1).copy()
    snz = sigma > sigma_thresh
    sigma[~snz] = 0.0

    colors = data[..., :-1]
    basis_dim = colors.shape[-1] // 3
    # channel-major layout: [r0..r(bd-1), g..., b...]; per-basis color triplet
    per_basis = colors.reshape(-1, 3, basis_dim)[snz]       # (M, 3, bd)

    retained_list = []
    quant_colors = []
    quant_maps = []
    w = (1.0 - np.exp(-0.01 * sigma[snz])) if weighted else None
    for j in range(basis_dim):
        d = per_basis[:, :, j]
        if j < retain:
            full = np.zeros((snz.shape[0], 3), np.float16)
            full[snz] = d.astype(np.float16)
            retained_list.append(full.reshape(-1, N, N, N, 3))
            continue
        cb, ids = quantize_median_cut(d, bits, w)
        id_full = np.zeros(snz.shape[0], np.uint16)
        id_full[snz] = ids.astype(np.uint16)
        quant_colors.append(cb.astype(np.float16))
        quant_maps.append(id_full.reshape(-1, N, N, N))

    del z["data"]
    z["quant_colors"] = np.stack(quant_colors)
    z["quant_map"] = np.stack(quant_maps)
    z["sigma"] = sigma.astype(np.float16).reshape(-1, N, N, N)
    if retain:
        z["data_retained"] = np.stack(retained_list)
    return z
