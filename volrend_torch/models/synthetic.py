"""Synthetic PlenOctree generation.

The reference consumes trees trained by svox; this environment has no scene
assets, so tests and benchmarks build procedural trees in the exact same npz
layout (relative child skips, channel-major SH coeffs + sigma, fp16 data —
see ``src/n3tree.cpp:228-362``). Construction is vectorized level-order
subdivision driven by a refinement predicate, like svox refinement.
"""

from __future__ import annotations

from typing import Callable, Optional

import os

import numpy as np

from volrend_torch.models.data_format import BasisType, DataFormat
from volrend_torch.models.n3tree import N3Tree

__all__ = ["build_tree", "make_blob_scene", "make_test_tree",
           "make_solid_scene", "make_solid_tree"]


def build_tree(
    refine_fn: Callable[[np.ndarray, float, int], np.ndarray],
    leaf_fn: Callable[[np.ndarray, float], np.ndarray],
    max_depth: int,
    data_dim: int,
    N: int = 2,
    data_format: Optional[DataFormat] = None,
    scale: Optional[np.ndarray] = None,
    offset: Optional[np.ndarray] = None,
) -> N3Tree:
    """Build an N3Tree by level-order subdivision (all NumPy, vectorized).

    refine_fn(centers (M,3) in tree coords, cell_size, depth) -> bool (M,):
        True where the cell should be subdivided (depth < max_depth only).
    leaf_fn(centers (M,3), cell_size) -> (M, data_dim) float leaf payloads.
    max_depth: deepest *node* depth; finest voxels have size N**-(max_depth+1).
    """
    N3 = N ** 3
    cell = np.arange(N3)
    sub = np.stack([cell // (N * N), (cell // N) % N, cell % N], -1)  # (N3,3)

    level_coords = np.zeros((1, 3), np.int64)  # root node coords at depth 0
    next_id = 1
    child_levels = []
    data_levels = []
    for d in range(max_depth + 1):
        n = level_coords.shape[0]
        if n == 0:
            break
        res = N ** (d + 1)
        cell_size = 1.0 / res
        cc = level_coords[:, None, :] * N + sub[None]          # (n, N3, 3)
        centers = (cc.reshape(-1, 3) + 0.5) * cell_size        # (n*N3, 3)

        if d < max_depth:
            subdiv = refine_fn(centers, cell_size, d + 1).reshape(n, N3)
        else:
            subdiv = np.zeros((n, N3), bool)

        child = np.zeros((n, N3), np.int32)
        n_new = int(subdiv.sum())
        if n_new:
            new_ids = next_id + np.arange(n_new)
            node_ids = (next_id - n) + np.arange(n)  # this level's node ids
            flat_rows = np.nonzero(subdiv)[0]
            child[subdiv] = (new_ids - node_ids[flat_rows]).astype(np.int32)
            next_id += n_new

        data = np.zeros((n * N3, data_dim), np.float32)
        leaf_mask = ~subdiv.reshape(-1)
        if leaf_mask.any():
            data[leaf_mask] = leaf_fn(centers[leaf_mask], cell_size)
        child_levels.append(child)
        data_levels.append(data.reshape(n, N3, data_dim))
        level_coords = cc[subdiv]

    tree = N3Tree()
    tree.N = N
    tree.data_dim = data_dim
    tree.capacity = next_id
    tree.child = np.concatenate(child_levels).reshape(-1, N, N, N)
    tree.data = (np.concatenate(data_levels)
                 .reshape(-1, N, N, N, data_dim).astype(np.float16))
    assert tree.child.shape[0] == tree.capacity
    tree.data_format = data_format or DataFormat(
        BasisType.SH, (data_dim - 1) // 3)
    tree.scale = (np.asarray(scale, np.float32) if scale is not None
                  else np.full(3, 0.5, np.float32))
    tree.offset = (np.asarray(offset, np.float32) if offset is not None
                   else np.full(3, 0.5, np.float32))
    return tree


def make_blob_scene(n_blobs: int = 5, seed: int = 0, sigma_scale: float = 40.0):
    """A deterministic scene of smooth density blobs with SH-varying color.

    Returns (density_fn, refine_fn, leaf_fn_factory) where density/refine work
    in tree coordinates [0,1]^3.
    """
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.25, 0.75, (n_blobs, 3))
    radii = rng.uniform(0.08, 0.2, n_blobs)
    amps = rng.uniform(0.5, 1.0, n_blobs) * sigma_scale

    def density(pts: np.ndarray) -> np.ndarray:
        d2 = ((pts[:, None, :] - centers[None]) ** 2).sum(-1)
        return (amps * np.exp(-0.5 * d2 / radii[None] ** 2)).sum(-1)

    def refine(centers_pts: np.ndarray, cell_size: float, depth: int):
        # subdivide where density *could* exceed a small threshold anywhere in
        # the cell: bound each gaussian by its value at the nearest cell point
        half_diag = 0.5 * np.sqrt(3.0) * cell_size
        d = np.sqrt(((centers_pts[:, None, :] - centers[None]) ** 2).sum(-1))
        d = np.maximum(d - half_diag, 0.0)
        bound = (amps * np.exp(-0.5 * d ** 2 / radii[None] ** 2)).sum(-1)
        return bound > 0.2

    def leaf_fn_factory(basis_dim: int, coeff_seed: int = 1):
        crng = np.random.default_rng(coeff_seed)
        freqs = crng.uniform(2.0, 9.0, (basis_dim, 3, 3))   # (bd, rgb, 3)
        phases = crng.uniform(0.0, 2 * np.pi, (basis_dim, 3))
        scales = 1.5 / (1.0 + np.arange(basis_dim)) ** 1.2  # decaying bands
        data_dim = 3 * basis_dim + 1
        # flattened (3*bd, ...) coefficient views, f32: the bench tree has
        # ~17M leaf points x 48 sin evals, so f32 SIMD ufuncs run across
        # threads (they release the GIL). Values match an f64 evaluation to
        # f32 roundoff (the payload array is f32 anyway).
        fmat = np.concatenate(
            [freqs[:, c].astype(np.float32) for c in range(3)], 0)  # (3bd,3)
        pvec = np.concatenate(
            [phases[:, c].astype(np.float32) for c in range(3)])
        svec = np.concatenate([scales.astype(np.float32)] * 3)

        cen32 = centers.astype(np.float32)
        rad32 = radii.astype(np.float32)
        amp32 = amps.astype(np.float32)

        def _block(pts32: np.ndarray) -> np.ndarray:
            out = np.empty((pts32.shape[0], data_dim), np.float32)
            arg = pts32 @ fmat.T
            arg += pvec
            np.sin(arg, out=arg)
            arg *= svec
            out[:, :3 * basis_dim] = arg
            # f32 density twin (payloads are f16; refine keeps the f64
            # path so the tree STRUCTURE stays bit-stable)
            d2 = ((pts32[:, None, :] - cen32[None]) ** 2).sum(-1)
            d2 *= -0.5 / rad32 ** 2
            np.exp(d2, out=d2)
            out[:, -1] = d2 @ amp32
            return out

        def leaf_fn(pts: np.ndarray, cell_size: float) -> np.ndarray:
            pts32 = np.ascontiguousarray(pts, np.float32)
            m = pts32.shape[0]
            if m < 1 << 18:
                return _block(pts32)
            from concurrent.futures import ThreadPoolExecutor
            nw = min(8, os.cpu_count() or 1)
            bounds = np.linspace(0, m, nw + 1).astype(np.int64)
            with ThreadPoolExecutor(nw) as pool:
                parts = list(pool.map(
                    _block, [pts32[bounds[i]:bounds[i + 1]]
                             for i in range(nw)]))
            return np.concatenate(parts, 0)

        return leaf_fn

    return density, refine, leaf_fn_factory


def make_solid_scene(n_blobs: int = 6, seed: int = 0,
                     sigma_scale: float = 150.0, cut: float = 1.0):
    """Objects-with-empty-space scene: a hard-thresholded blob union.

    ``make_blob_scene`` produces smooth fog filling nearly the whole bbox
    (97% voxel occupancy at bench settings) — real PlenOctree assets are
    the opposite: opaque objects with crisp silhouettes surrounded by empty
    space, stored fine at surfaces and coarse inside. This scene has that
    statistic: density = sigma_scale * max(0, raw - cut) where raw is the
    gaussian-blob sum, so the object is the {raw > cut} region (solid,
    rays saturate at the surface) and everything else is exactly zero.
    The refine predicate subdivides only where a cell can STRADDLE the
    cut — interiors and empty space stay coarse, like svox-trained trees.
    """
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.3, 0.7, (n_blobs, 3))
    radii = rng.uniform(0.08, 0.18, n_blobs)
    amps = rng.uniform(0.6, 1.2, n_blobs)

    def raw(pts: np.ndarray) -> np.ndarray:
        d2 = ((pts[:, None, :] - centers[None]) ** 2).sum(-1)
        return (amps * np.exp(-0.5 * d2 / radii[None] ** 2)).sum(-1)

    def density(pts: np.ndarray) -> np.ndarray:
        return sigma_scale * np.maximum(0.0, raw(pts) - cut)

    def refine(centers_pts: np.ndarray, cell_size: float, depth: int):
        # subdivide only where the cell can straddle the surface {raw=cut}:
        # upper bound (nearest-point) above cut AND lower bound (farthest-
        # point) below it — interiors and empty space keep coarse leaves
        half_diag = 0.5 * np.sqrt(3.0) * cell_size
        d = np.sqrt(((centers_pts[:, None, :] - centers[None]) ** 2)
                    .sum(-1))
        d_near = np.maximum(d - half_diag, 0.0)
        d_far = d + half_diag
        ub = (amps * np.exp(-0.5 * d_near ** 2
                            / radii[None] ** 2)).sum(-1)
        lb = (amps * np.exp(-0.5 * d_far ** 2 / radii[None] ** 2)).sum(-1)
        return (ub > cut) & (lb < cut)

    def leaf_fn_factory(basis_dim: int, coeff_seed: int = 1):
        crng = np.random.default_rng(coeff_seed)
        freqs = crng.uniform(2.0, 9.0, (basis_dim, 3, 3))
        phases = crng.uniform(0.0, 2 * np.pi, (basis_dim, 3))
        scales = 1.5 / (1.0 + np.arange(basis_dim)) ** 1.2
        data_dim = 3 * basis_dim + 1

        def leaf_fn(pts: np.ndarray, cell_size: float) -> np.ndarray:
            out = np.zeros((pts.shape[0], data_dim), np.float32)
            for k in range(basis_dim):
                for c in range(3):
                    out[:, c * basis_dim + k] = scales[k] * np.sin(
                        pts @ freqs[k, c] + phases[k, c])
            out[:, -1] = density(pts)
            return out

        return leaf_fn

    return density, refine, leaf_fn_factory


def make_solid_tree(max_depth: int = 4, basis_dim: int = 9, seed: int = 0,
                    n_blobs: int = 6, sigma_scale: float = 150.0,
                    cut: float = 1.0) -> N3Tree:
    """Convenience: a solid-object tree (realistic occupancy statistics)."""
    _, refine, leaf_factory = make_solid_scene(
        n_blobs=n_blobs, seed=seed, sigma_scale=sigma_scale, cut=cut)
    data_dim = 3 * basis_dim + 1
    return build_tree(
        refine, leaf_factory(basis_dim, coeff_seed=seed + 1),
        max_depth=max_depth, data_dim=data_dim,
        data_format=DataFormat(BasisType.SH, basis_dim),
    )


def make_test_tree(max_depth: int = 4, basis_dim: int = 9, seed: int = 0,
                   n_blobs: int = 4, sigma_scale: float = 40.0) -> N3Tree:
    """Convenience: a blob-scene tree (SH basis) for tests/benchmarks."""
    _, refine, leaf_factory = make_blob_scene(
        n_blobs=n_blobs, seed=seed, sigma_scale=sigma_scale)
    data_dim = 3 * basis_dim + 1
    return build_tree(
        refine, leaf_factory(basis_dim, coeff_seed=seed + 1),
        max_depth=max_depth, data_dim=data_dim,
        data_format=DataFormat(BasisType.SH, basis_dim),
    )
