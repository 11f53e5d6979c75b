"""CPU mesh rasterizer producing the color+distance buffers for volume
compositing.

Replaces the reference's GL mesh pass (``src/mesh.cpp:99-161`` vertex/frag
shaders + ``src/cuda_renderer.cpp:103-112``): renders visible meshes with
the same two-light Blinn-Phong shading (ambient 0.3, diffuse 0.7/0.2 from
the two hardcoded light dirs, specular 0.6*spec^32) and writes **euclidean
distance to the camera** (not z-depth) into the second buffer — the exact
contract the volume kernel uses as ``t_max`` when compositing
(``src/cuda/volrend.cu:143-163``, ``mesh.cpp:159``).

Meshes are small viz aids; a vectorized NumPy scanline pass per triangle is
plenty. Lines/points are rasterized with interpolated sampling.

The port's own copy of ``volrend_tpu/ops/rasterize.py`` (NumPy only): the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from volrend_torch.models.mesh import Mesh

__all__ = ["rasterize_meshes", "MeshBuffers"]

_LIGHT1 = np.array([0.5, 0.2, 1.0])
_LIGHT1 = _LIGHT1 / np.linalg.norm(_LIGHT1)
_LIGHT2 = np.array([-0.5, -1.0, -0.5])
_LIGHT2 = _LIGHT2 / np.linalg.norm(_LIGHT2)


class MeshBuffers:
    """color (H,W,3) f32, dist (H,W) f32 (inf where no mesh)."""

    def __init__(self, height: int, width: int):
        self.color = np.zeros((height, width, 3), np.float32)
        self.dist = np.full((height, width), np.inf, np.float32)


def _shade(color, normal, frag_world, cam_pos, unlit: bool):
    """Fragment shading (mesh.cpp frag shader semantics). Inputs (...,3)."""
    if unlit:
        return color
    n = normal / np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True),
                            1e-12)
    diffuse = 0.7 * np.maximum((n @ _LIGHT1), 0.0)
    diffuse2 = 0.2 * np.maximum((n @ _LIGHT2), 0.0)
    view = cam_pos - frag_world
    view = view / np.maximum(np.linalg.norm(view, axis=-1, keepdims=True),
                             1e-12)
    refl = 2.0 * (n @ _LIGHT1)[..., None] * n - _LIGHT1
    spec = 0.6 * np.maximum(np.sum(view * refl, -1), 0.0) ** 32
    lum = 0.3 + diffuse + diffuse2 + spec
    return np.clip(color * lum[..., None], 0.0, 1.0)


def _project(pts: np.ndarray, cam) -> Tuple[np.ndarray, np.ndarray]:
    """World -> (pixel xy, camera-space pos). Pixel convention matches
    screen2worlddir: px = x_cam/(-z_cam)*fx + W/2, y flipped."""
    R = cam.transform[:, :3]
    c = cam.transform[:, 3]
    p_cam = (pts - c) @ R  # world->cam (R orthonormal)
    z = -p_cam[:, 2]
    z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    px = p_cam[:, 0] / z_safe * cam.fx + 0.5 * cam.width
    py = -p_cam[:, 1] / z_safe * cam.fy + 0.5 * cam.height
    return np.stack([px, py], -1), p_cam


def _raster_triangles(verts, faces, cam, buf: MeshBuffers, unlit: bool):
    if faces.size == 0:
        faces = np.arange((verts.shape[0] // 3) * 3, dtype=np.int64)
    tri = faces.reshape(-1, 3).astype(np.int64)
    pix, p_cam = _project(verts[:, :3], cam)
    z = -p_cam[:, 2]
    cam_pos = cam.transform[:, 3]
    H, W = buf.dist.shape
    for t in tri:
        if np.any(z[t] <= 1e-6):
            continue  # no near-plane clipping for viz meshes
        p = pix[t]                       # (3,2)
        xmin = max(int(np.floor(p[:, 0].min())), 0)
        xmax = min(int(np.ceil(p[:, 0].max())) + 1, W)
        ymin = max(int(np.floor(p[:, 1].min())), 0)
        ymax = min(int(np.ceil(p[:, 1].max())) + 1, H)
        if xmin >= xmax or ymin >= ymax:
            continue
        xs = np.arange(xmin, xmax) + 0.5
        ys = np.arange(ymin, ymax) + 0.5
        gx, gy = np.meshgrid(xs, ys)
        d = np.stack([gx - p[0, 0], gy - p[0, 1]], -1)
        e1 = p[1] - p[0]
        e2 = p[2] - p[0]
        det = e1[0] * e2[1] - e1[1] * e2[0]
        if abs(det) < 1e-12:
            continue
        b1 = (d[..., 0] * e2[1] - d[..., 1] * e2[0]) / det
        b2 = (e1[0] * d[..., 1] - e1[1] * d[..., 0]) / det
        b0 = 1.0 - b1 - b2
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        if not inside.any():
            continue
        # perspective-correct interpolation in 1/z
        iz = 1.0 / z[t]
        wgt = np.stack([b0 * iz[0], b1 * iz[1], b2 * iz[2]], -1)
        wsum = wgt.sum(-1)
        wgt = wgt / np.maximum(wsum[..., None], 1e-12)
        frag_cam = np.einsum("hwk,kc->hwc", wgt, p_cam[t])
        dist = np.linalg.norm(frag_cam, axis=-1)
        closer = inside & (dist < buf.dist[ymin:ymax, xmin:xmax])
        if not closer.any():
            continue
        col = np.einsum("hwk,kc->hwc", wgt, verts[t][:, 3:6])
        nrm = np.einsum("hwk,kc->hwc", wgt, verts[t][:, 6:9])
        frag_world = np.einsum("hwk,kc->hwc", wgt, verts[t][:, :3])
        shaded = _shade(col, nrm, frag_world, cam_pos, unlit)
        sub = buf.color[ymin:ymax, xmin:xmax]
        sub[closer] = shaded[closer]
        dsub = buf.dist[ymin:ymax, xmin:xmax]
        dsub[closer] = dist[closer]


def _raster_lines(verts, faces, cam, buf: MeshBuffers):
    if faces.size == 0:
        return
    seg = faces.reshape(-1, 2).astype(np.int64)
    pix, p_cam = _project(verts[:, :3], cam)
    z = -p_cam[:, 2]
    H, W = buf.dist.shape
    for s in seg:
        if np.any(z[s] <= 1e-6):
            continue
        a, b = pix[s[0]], pix[s[1]]
        n = int(np.ceil(np.abs(b - a).max())) + 1
        ts = np.linspace(0.0, 1.0, n)
        # perspective-correct param for distance interpolation
        iz = 1.0 / z[s]
        w1 = ts * iz[1] / ((1 - ts) * iz[0] + ts * iz[1])
        pts = a[None] * (1 - ts[:, None]) + b[None] * ts[:, None]
        xi = np.round(pts[:, 0] - 0.5).astype(np.int64)
        yi = np.round(pts[:, 1] - 0.5).astype(np.int64)
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        if not ok.any():
            continue
        frag = (p_cam[s[0]][None] * (1 - w1[:, None])
                + p_cam[s[1]][None] * w1[:, None])
        dist = np.linalg.norm(frag, axis=-1)
        col = (verts[s[0], 3:6][None] * (1 - w1[:, None])
               + verts[s[1], 3:6][None] * w1[:, None])
        xi, yi, dist, col = xi[ok], yi[ok], dist[ok], col[ok]
        closer = dist < buf.dist[yi, xi]
        buf.color[yi[closer], xi[closer]] = col[closer]
        buf.dist[yi[closer], xi[closer]] = dist[closer]


def _raster_points(verts, cam, buf: MeshBuffers):
    pix, p_cam = _project(verts[:, :3], cam)
    z = -p_cam[:, 2]
    H, W = buf.dist.shape
    xi = np.round(pix[:, 0] - 0.5).astype(np.int64)
    yi = np.round(pix[:, 1] - 0.5).astype(np.int64)
    ok = (z > 1e-6) & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    dist = np.linalg.norm(p_cam, axis=-1)
    order = np.argsort(-dist)  # far to near so near wins
    for i in order:
        if not ok[i]:
            continue
        if dist[i] < buf.dist[yi[i], xi[i]]:
            buf.color[yi[i], xi[i]] = verts[i, 3:6]
            buf.dist[yi[i], xi[i]] = dist[i]


def rasterize_meshes(meshes: Sequence[Mesh], cam) -> MeshBuffers:
    """Render visible meshes into color+distance buffers for cam."""
    buf = MeshBuffers(cam.height, cam.width)
    for m in meshes:
        if not m.visible or m.n_verts == 0:
            continue
        verts = m.transformed_verts()
        if m.face_size == 3:
            _raster_triangles(verts, m.faces, cam, buf, m.unlit)
        elif m.face_size == 2:
            _raster_lines(verts, m.faces, cam, buf)
        else:
            _raster_points(verts, cam, buf)
    return buf
