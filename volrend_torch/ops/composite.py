"""Mesh/volume compositing frames, the octree wireframe and the lumisphere
probe (the counterpart of ``volrend_tpu/ops/composite.py``).

Ties the host mesh rasterizer (``ops/rasterize.py``) to the exact volume
renderer (``ops/render_exact.py``): the mesh pass gives each pixel a colour
and a euclidean camera distance; the volume march stops at that distance
and its remaining transmittance composites over the mesh colour, the
reference's two-pass contract (``src/cuda_renderer.cpp:103-118``,
``src/cuda/volrend.cu:143-163``). The slab path's mesh frames
(``slab_render.render_image(meshes=...)``) are held against
``render_frame_with_meshes``.

Also the reference GUI's volume-side helpers:
- the octree wireframe overlay (``N3Tree.gen_wireframe`` as a line mesh;
  ``src/n3tree.cpp:364-434``, drawn when ``opt.show_grid``);
- the lumisphere probe (``src/cuda/volrend.cu:175-191``): the leaf
  coefficients at a point, its ball image and the in-frame inset.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.models.mesh import Mesh
from volrend_torch.models.n3tree import N3Tree, TreeArrays
from volrend_torch.ops import basis as basis_mod
from volrend_torch.ops import render_exact
from volrend_torch.ops.rasterize import rasterize_meshes
from volrend_torch.utils.options import RenderOptions

__all__ = ["render_frame_with_meshes", "wireframe_mesh", "probe_coeffs",
           "probe_image", "draw_probe_inset"]


def wireframe_mesh(tree: N3Tree, max_depth: int = 4) -> Mesh:
    """The octree wireframe as a line mesh (cuda_renderer.cpp:182-188)."""
    verts = tree.gen_wireframe(max_depth=max_depth)
    m = Mesh(np.asarray(verts, np.float32).reshape(-1, 9), face_size=2)
    m.auto_faces()
    m.unlit = True
    m.name = "wireframe"
    return m


def render_frame_with_meshes(tree: TreeArrays, cam, opt: RenderOptions,
                             meshes: Sequence[Mesh],
                             host_tree: Optional[N3Tree] = None
                             ) -> np.ndarray:
    """A whole frame by the exact renderer: the mesh pass, then the volume
    pass composited over it; (H, W, 4) f32 on the host. ``host_tree``: the
    source N3Tree, for the ``opt.show_grid`` wireframe."""
    meshes = list(meshes)
    if opt.show_grid and host_tree is not None:
        meshes.append(wireframe_mesh(host_tree, opt.grid_max_depth))
    buf = rasterize_meshes(meshes, cam)
    out = render_exact.render_image(tree, cam, opt, tmax_bg=buf.dist,
                                    bg_rgb=buf.color)
    return out.cpu().numpy()


def probe_coeffs(tree: TreeArrays, point) -> np.ndarray:
    """The leaf payload at a world-space probe point
    (retrieve_cursor_lumisphere_kernel, volrend.cu:100-134, 175-191)."""
    p = torch.as_tensor(np.asarray(point, np.float32),
                        device=tree.child.device)
    pos = tree.offset + tree.scale * p
    leaf_idx, _, _ = render_exact.query_batched(tree, pos[None])
    row = render_exact._fetch_rows(tree.data, leaf_idx[:1])[0]
    return row.to(torch.float32).cpu().numpy()[:tree.data_dim]


def _basis_np(tree: TreeArrays, dirs: np.ndarray) -> np.ndarray:
    """(n, basis_dim) basis values of the tree's format at (n, 3) dirs."""
    extra = tree.extra.cpu() if isinstance(tree.extra, torch.Tensor) \
        else tree.extra
    vals = basis_mod.eval_basis(BasisType(int(tree.fmt)), tree.basis_dim,
                                torch.as_tensor(dirs), extra)
    return vals.numpy()


def probe_image(tree: TreeArrays, point, size: int = 100) -> np.ndarray:
    """The GUI's inset lumisphere ball: the probe point's lobe evaluated
    over a size x size orthographic sphere patch; (size, size, 3) f32."""
    coeffs = probe_coeffs(tree, point)
    bd = tree.basis_dim
    xs = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    xx, yy = np.meshgrid(xs, -xs)
    r2 = xx ** 2 + yy ** 2
    zz = np.sqrt(np.maximum(1.0 - r2, 0.0))
    dirs = np.stack([xx, yy, zz], -1)
    if bd < 0:
        rgb = np.broadcast_to(coeffs[:3], (size, size, 3)).copy()
    else:
        vals = _basis_np(tree, dirs.reshape(-1, 3))
        raw = (coeffs[:3 * bd].reshape(3, bd)[None]
               * vals[:, None, :]).sum(-1)
        rgb = (1.0 / (1.0 + np.exp(-raw))).reshape(size, size, 3)
    rgb[r2 > 1.0] = 0.0
    return rgb.astype(np.float32)


def draw_probe_inset(frame: np.ndarray, tree: TreeArrays, cam,
                     opt: RenderOptions) -> np.ndarray:
    """The lumisphere-probe ball drawn as an inset circle in the top-right
    corner of a rendered frame (the reference draws it in its kernel,
    volrend.cu:100-134), on the host. ``frame``: (H, W, 4) float [0, 1]
    or uint8 RGBA; returns a modified copy of the same dtype. The ball's
    directions are the unit hemisphere rotated by the camera
    (``_mv3(cam.transform, cen, dir)``) with the basis window applied, so
    the inset follows the camera and the SH-band view as the reference's
    does."""
    if not opt.enable_probe:
        return frame
    H, W = frame.shape[:2]
    s = int(opt.probe_disp_size)
    if s <= 0 or W < s + 5 or H < s + 5:
        return frame
    is_u8 = frame.dtype == np.uint8
    out = np.array(frame)

    coeffs = probe_coeffs(tree, opt.probe)
    # the pixel block covering the circle (the reference walks the square
    # y < s + 5, x >= W - s - 5 and tests c <= 1)
    ys = np.arange(H)
    xs = np.arange(W)
    in_y = ys < s + 5
    in_x = xs >= W - s - 5
    yy = (ys[in_y] - 5).astype(np.float32)
    xx = (xs[in_x] - (W - s) + 5).astype(np.float32)
    cen0 = -(xx / (0.5 * s) - 1.0)
    cen1 = yy / (0.5 * s) - 1.0
    c = cen0[None, :] ** 2 + cen1[:, None] ** 2
    inside = c <= 1.0
    if not np.any(inside):
        return out
    cen2 = -np.sqrt(np.maximum(1.0 - c, 0.0))
    cen = np.stack([np.broadcast_to(cen0[None, :], c.shape),
                    np.broadcast_to(cen1[:, None], c.shape), cen2], -1)
    R = np.asarray(cam.transform, np.float32)[:3, :3]
    dirs = cen[inside] @ R.T

    bd = tree.basis_dim
    if bd < 0:
        rgb = np.broadcast_to(coeffs[:3], (dirs.shape[0], 3))
    else:
        vals = _basis_np(tree, dirs)
        lo, hi = opt.basis_minmax
        k = np.arange(vals.shape[-1])
        vals = np.where((k >= lo) & (k <= hi), vals, 0.0)
        raw = (coeffs[:3 * bd].reshape(3, bd)[None]
               * vals[:, None, :]).sum(-1)
        rgb = 1.0 / (1.0 + np.exp(-raw))
    if is_u8:
        # clip before the cast: RGBA trees skip the sigmoid, so an
        # unclipped cast would wrap instead of saturating
        px = np.concatenate(
            [np.clip(np.round(rgb * 255.0), 0.0, 255.0),
             np.full((rgb.shape[0], 1), 255.0)], -1).astype(np.uint8)
    else:
        px = np.concatenate(
            [rgb, np.ones((rgb.shape[0], 1))], -1).astype(out.dtype)
    block = out[np.ix_(ys[in_y], xs[in_x])]
    block[inside] = px[..., :block.shape[-1]]
    out[np.ix_(ys[in_y], xs[in_x])] = block
    return out
