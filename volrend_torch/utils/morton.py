"""3-D Morton (Z-order) codes, vectorized (the port's own copy of
``volrend_tpu/utils/morton.py``, NumPy only).

Parity with ``include/volrend/internal/morton.hpp:26-40`` (bit
expand/unexpand). Used to order rays by octree entry cell so neighboring
lanes traverse neighboring memory (SURVEY.md §7.8); also handy for
building spatially-coherent leaf orderings when sharding trees.
"""

from __future__ import annotations

import numpy as np

__all__ = ["morton_code_3", "inv_morton_code_3", "ray_morton_order"]


def _expand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def _unexpand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1249249249249249)
    v = (v | (v >> np.uint64(2))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v >> np.uint64(4))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v >> np.uint64(8))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v >> np.uint64(16))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v >> np.uint64(32))) & np.uint64(0x1FFFFF)
    return v


def morton_code_3(x, y, z) -> np.ndarray:
    """Interleave (x, y, z) 21-bit ints -> 63-bit Morton codes."""
    return (_expand_bits(np.asarray(x)) << np.uint64(2)) \
        | (_expand_bits(np.asarray(y)) << np.uint64(1)) \
        | _expand_bits(np.asarray(z))


def inv_morton_code_3(code):
    code = np.asarray(code, np.uint64)
    return (_unexpand_bits(code >> np.uint64(2)),
            _unexpand_bits(code >> np.uint64(1)),
            _unexpand_bits(code))


def ray_morton_order(entry_points: np.ndarray, grid: int = 1024
                     ) -> np.ndarray:
    """Sort order for rays by the Morton code of their volume entry point
    (tree coords in [0,1]^3) — reduces gather divergence across lanes."""
    p = np.clip((np.asarray(entry_points) * grid).astype(np.int64),
                0, grid - 1)
    return np.argsort(morton_code_3(p[:, 0], p[:, 1], p[:, 2]),
                      kind="stable")
