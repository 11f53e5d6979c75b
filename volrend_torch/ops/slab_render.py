"""Shear-warp slab renderer: the display render path (the counterpart of
``volrend_tpu/ops/slab_render.py``).

The reference renders by per-pixel octree pointer-chasing
(``rt_core.cuh:66-196``). This module replaces the traversal (not the
compositing math) with a shear-warp factorization:

1. **Bake** the octree to a dense int8 grid once per scene
   (``ops/dense_grid.py``).
2. **Permute** so the camera's dominant axis is the slab axis. Every ray
   through the pinhole centre C sampled at plane z has
   ``y = C_y + (z - C_z) * (d_y / d_z)`` — affine in the ray's slope, so on a
   uniform slope grid (the intermediate image) per-slab resampling is a
   separable scale + translate.
3. **March** the occupied slabs front to back for a whole (perm, flip) pose
   group in one launch of the fused march kernel (``ops/slab_march.py``).
4. **Warp** the intermediate image to the screen with the superquad warp
   (``ops/display_warp.py``), falling back per pose to the reference
   quad-gather warp (``_warp_to_screen_ref``) when a pose misfits. The
   training path warps through ``_warp_to_screen(precise=True)``.

NDC (LLFF) trees: the tree's coordinates are NDC coordinates, and the NDC
map is projective, so every warped ray passes through the image of the
camera origin: the warped ray family is still a pinhole family and the
factorization applies, with the slab axis the NDC z axis (``choose_axis``),
the camera centre and slope grid warped by ``render_exact.world2ndc`` and
an NDC-specific affine map from slopes to world view directions
(``FrameGeom.dirM``). Steep world-tree poses (boundary slopes past
MAX_SLAB_SLOPE, rays straddling the slab axis) render as split frames
(``render_frame_split``): one full-frame pass per (axis, sign) class of the
rays' dominant tree axis, stitched per pixel.

Every function takes a batch of poses: per-pose values are tensors with a
leading pose dimension (P, ...), the pose-invariant ones (fx, fy, grid
metadata) are shared. The display path takes the int8 and the f16 bake,
SH, SG, ASG and RGBA trees, the viewer's render options (depth,
render_bbox, the basis window, rot_dirs) and mesh overlays on world trees
(``render_image(meshes=...)``, ``opt.show_grid``): the host rasterizer's
distance buffer clips each pixel's z interval (``FrameGeom(mesh_dist=)``)
and kernel W composites the remaining transmittance over the mesh colour
(its mesh-background mode). NDC trees take meshes on the exact renderer
only, as in the reference (ValueError).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from volrend_torch.ops import display_warp, slab_march
from volrend_torch.ops.dense_grid import DenseGrid
from volrend_torch.ops.render_exact import _rodrigues_matrix, world2ndc
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

__all__ = ["choose_axis", "compatible", "render_frame", "render_frames",
           "render_frame_split", "render_image", "prepare_payload",
           "default_gi", "inplane_crop"]

_F32 = torch.float32

#: display-path in-plane occupancy crop (see inplane_crop / march_slabs
#: crop=): the payload is sliced to the occupied row/col ranges so sparse
#: scenes stream and shade the occupied sub-box only. Exact (cropped voxels
#: are sub-threshold, so they would be masked to zero anyway).
_INPLANE_CROP = True
#: crop length granularity (rows, cols). Module constants so tests can
#: exercise the crop at small G, as the reference's tests do.
_CROP_MULT_Y = 32
_CROP_MULT_X = 128

#: box-tap warp accuracy limit: per-slab spans stay near one voxel only
#: while boundary-ray slopes are below this
MAX_SLAB_SLOPE = 4.0


def inplane_crop(grid: DenseGrid, perm: Tuple[int, int, int],
                 sigma_thresh: float) -> Optional[Tuple[int, int, int, int]]:
    """(y0, Gy, x0, Gx) in-plane crop for slab axis perm[0], from the
    bake's per-axis occupancy metadata; lengths rounded up to
    (_CROP_MULT_Y, _CROP_MULT_X). None when disabled, unknown or
    uncroppable (dense scenes)."""
    if not _INPLANE_CROP or grid.occ_max is None:
        return None
    G = grid.G

    def rng(axis: int, mult: int) -> Tuple[int, int]:
        occ = np.asarray(grid.occ_max[axis], np.float64)
        idx = np.nonzero(occ > sigma_thresh)[0]
        if idx.size == 0:
            return 0, min(mult, G)   # empty scene: march culls everything
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        L = min(G, -(-(hi - lo) // mult) * mult)
        return max(0, min(lo, G - L)), L

    y0, Gy = rng(perm[1], _CROP_MULT_Y)
    x0, Gx = rng(perm[2], _CROP_MULT_X)
    if Gy == G and Gx == G:
        return None
    return (y0, Gy, x0, Gx)


def _cam_corners(width: int, height: int, fx: float, fy: float,
                 n_edge: int = 33) -> np.ndarray:
    """Camera-space dirs sampling the image boundary (slope extremes of a
    projective map live on the boundary)."""
    xs = np.linspace(0, width, n_edge, dtype=np.float64)
    ys = np.linspace(0, height, n_edge, dtype=np.float64)
    px = np.concatenate([xs, xs, np.full(n_edge, 0.0),
                         np.full(n_edge, float(width))])
    py = np.concatenate([np.full(n_edge, 0.0), np.full(n_edge, float(height)),
                         ys, ys])
    return np.stack([(px - 0.5 * width) / fx,
                     -(py - 0.5 * height) / fy,
                     -np.ones_like(px)], -1)


def _ndc_warp_dirs_np(ndc, dirs, origin):
    """Host-side NDC warp of world dirs sharing one origin (the world2ndc
    semantics of volrend.cu:34-54, numpy twin of render_exact.world2ndc).
    Returns UNnormalized NDC-space directions (slopes are scale-free)."""
    W, H, focal = (float(v) for v in ndc)
    o = np.asarray(origin, np.float64)
    d = np.asarray(dirs, np.float64)
    dz = d[:, 2]
    t = -(1.0 + o[2]) / dz
    cen = o[None, :] + t[:, None] * d
    sx = -(2.0 * focal) / W
    sy = -(2.0 * focal) / H
    return np.stack([
        sx * (d[:, 0] / dz - cen[:, 0] / cen[:, 2]),
        sy * (d[:, 1] / dz - cen[:, 1] / cen[:, 2]),
        -2.0 / cen[:, 2],
    ], -1)


def _ndc_center_np(ndc, origin):
    """NDC image of the camera origin under the projective NDC map
    pi(x,y,z) = (sx*x/z, sy*y/z, 1 + 2/z). The NDC warp is projective, so
    every warped ray passes through pi(origin): the warped ray family is
    still a pinhole family and the shear-warp factorization applies."""
    W, H, focal = (float(v) for v in ndc)
    ox, oy, oz = (float(v) for v in origin)
    sx = -(2.0 * focal) / W
    sy = -(2.0 * focal) / H
    return np.array([sx * ox / oz, sy * oy / oz, 1.0 + 2.0 / oz])


def _host(t) -> np.ndarray:
    """A small tensor (or array) as a float64 host array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def choose_axis(grid: DenseGrid, transform, fx: float, fy: float,
                width: int, height: int
                ) -> Tuple[Tuple[int, int, int], bool, float]:
    """Host-side: pick the slab axis for this pose.

    Returns (perm, flip, max_abs_slope). perm maps tree axes -> (slab, row,
    col); flip=True when rays march toward -slab. max_abs_slope gauges
    whether the pose is renderable (all boundary rays share the slab-axis
    sign); inf when not.

    NDC trees: the pose geometry is warped into NDC space first (the tree's
    coordinate system). The slab axis must be the NDC z axis and the
    warped pinhole centre must sit outside the volume's z range; other
    poses return inf (the exact renderer takes them)."""
    tf = _host(transform).reshape(3, 4)
    R = tf[:, :3]
    scale = _host(grid.scale)
    d_cam = _cam_corners(width, height, fx, fy)
    d_world = d_cam @ R.T
    fwd_w = R @ np.array([0.0, 0.0, -1.0])
    c4 = np.array([[0.0, 0.0], [width, 0.0], [0.0, height],
                   [width, height]])
    d4_world = np.stack([(c4[:, 0] - 0.5 * width) / fx,
                         -(c4[:, 1] - 0.5 * height) / fy,
                         -np.ones(4)], -1) @ R.T
    if grid.ndc is not None:
        o = tf[:, 3]
        # degenerate for the projective warp: camera on the z = 0 plane
        # (pi(o) at infinity) or a boundary ray not looking forward
        if abs(o[2]) < 1e-6 or np.any(d_world[:, 2] >= -1e-12):
            return (2, 0, 1), False, float("inf")
        # the warped pinhole centre inside the volume's z' range puts the
        # ray caustic inside the grid (per-voxel slopes are ill-defined on
        # the slab through the centre): scene-interior cameras fall back
        c_ndc = _ndc_center_np(grid.ndc, o)
        if -1.05 < c_ndc[2] < 1.05:
            return (2, 0, 1), False, float("inf")
        d_tree = _ndc_warp_dirs_np(grid.ndc, d_world, o) * scale
        fwd = _ndc_warp_dirs_np(grid.ndc, fwd_w[None], o)[0] * scale
        d4 = _ndc_warp_dirs_np(grid.ndc, d4_world, o) * scale
        m = int(np.argmax(np.abs(fwd)))
        if m != 2:
            # shading dirs are affine in the slope grid only when the slab
            # axis is the NDC z axis (see FrameGeom)
            return (m, (m + 1) % 3, (m + 2) % 3), bool(fwd[m] < 0), \
                float("inf")
    else:
        d_tree = d_world * scale
        d4 = d4_world * scale
        fwd = scale * fwd_w
        m = int(np.argmax(np.abs(fwd)))
    a, b = (m + 1) % 3, (m + 2) % 3

    # orient the cross axes to the screen: the intermediate image's row
    # coordinate (slope u along perm[1]) should track screen rows
    dm = d4[:, m]
    if not np.any(dm == 0):
        ua = d4[:, a] / dm
        dx = abs(ua[1] - ua[0]) + abs(ua[3] - ua[2])
        dy = abs(ua[2] - ua[0]) + abs(ua[3] - ua[1])
        if dy < dx:
            a, b = b, a
    perm = (m, a, b)

    dz = d_tree[:, m]
    flip = fwd[m] < 0
    if np.any(dz == 0) or (np.min(dz) < 0) != (np.max(dz) < 0):
        return perm, bool(flip), float("inf")
    u = d_tree[:, perm[1]] / dz
    v = d_tree[:, perm[2]] / dz
    return perm, bool(flip), float(max(np.abs(u).max(), np.abs(v).max()))


def compatible(grid: DenseGrid, transform, fx, fy, width, height,
               max_slope: float = MAX_SLAB_SLOPE) -> bool:
    _, _, s = choose_axis(grid, transform, fx, fy, width, height)
    return s < max_slope


def _slopes_from_dirs(d_tree, perm):
    dz = d_tree[..., perm[0]]
    safe = torch.where(torch.abs(dz) < 1e-12,
                       torch.full_like(dz, 1e-12), dz)
    return d_tree[..., perm[1]] / safe, d_tree[..., perm[2]] / safe


def _kernel_ok(grid: DenseGrid) -> None:
    """Raise unless the march takes the grid (the reference's
    ``_pallas_ok``): SH of degree 0-4, SG and ASG with their lobes (up to
    25: ValueError above, slab_march.DISPLAY_LOBES), RGBA with D = 4; the
    int8 or the f16 bake. Every display option is taken."""
    slab_march._check_format(grid.fmt, grid.basis_dim, grid.data_dim,
                             grid.extra)


def _permuted_grid(grid: DenseGrid, perm, crop=None) -> torch.Tensor:
    """Channel-planar slab-major payload (z, Dp, y, x), in-plane-sliced to
    ``crop`` when given (a fresh contiguous tensor). The f16 bake's is cast
    to bf16 after the permute and crop, as the reference's kernel takes it
    (Dp = D, sigma in the last plane)."""
    planar = grid.data.permute(perm[0], 3, perm[1], perm[2])
    if crop is not None:
        y0, Gy, x0, Gx = crop
        planar = planar[:, :, y0:y0 + Gy, x0:x0 + Gx]
    if not grid.quantized:
        return planar.to(torch.bfloat16, memory_format=torch.contiguous_format)
    return planar.contiguous()


def prepare_payload(grid: DenseGrid, perm: Tuple[int, int, int],
                    opt: RenderOptions) -> torch.Tensor:
    """Materialize the slab-major payload for one slab axis ONCE (scene
    prep) so repeated ``render_frames`` calls skip the per-call permute.
    Cache by the FULL ``perm`` (only flip is free: it is the march order)."""
    _kernel_ok(grid)
    crop = inplane_crop(grid, perm, float(opt.sigma_thresh))
    return _permuted_grid(grid, perm, crop=crop)


def default_gi(grid: DenseGrid) -> int:
    """Intermediate-plane resolution matched to the volume: gi = G rounded
    up to a multiple of 128, in [128, 512]; 2G for an NDC grid. An NDC
    grid's x and y span the whole frame, so a plane of G samples gives
    each sample a voxel's width of the frame: at gi = G, bench.py's NDC
    scene (G=128, 800^2) renders below its 47.5 dB gate
    (chip_smoke.py, phase 12f (c))."""
    g = 2 * grid.G if grid.ndc is not None else grid.G
    return int(min(512, max(128, -(-g // 128) * 128)))


def _slope_grid(R, fx, fy, scale, perm: Tuple[int, int, int], width: int,
                height: int, gi: int, ndc=None, origin=None,
                unit_slope_box: bool = False):
    """The intermediate slope grid of a pose batch, (u0, du, v0, dv) (P,):
    the range of the image boundary's slopes along perm[1] and perm[2]
    plus a half-texel guard band, over gi samples. R (P, 3, 3); fx, fy
    0-d tensors on R's device. An NDC tree (``ndc``) warps the boundary
    rays from each pose's ``origin`` (P, 3) through world2ndc.
    ``unit_slope_box``: a split-frame class pass's fixed box
    +-(1 + 2/gi), which holds every ray whose dominant tree axis is the
    slab axis (slope magnitudes <= 1), whatever the frame's range."""
    P = R.shape[0]
    if unit_slope_box:
        box = torch.full((P,), float(np.float32(1.0 + 2.0 / gi)),
                         dtype=_F32, device=R.device)
        u0 = -box
        du = (box - u0) / (gi - 1)
        return u0, du, u0, du
    corners_cam = to_device(_cam_corners(width, height, 1.0, 1.0), _F32,
                            R.device)
    # rescale the unit-focal boundary by the actual fx/fy
    corners_cam = torch.stack([corners_cam[:, 0] * (1.0 / fx),
                               corners_cam[:, 1] * (1.0 / fy),
                               corners_cam[:, 2]], -1)
    d_world_c = torch.einsum("nc,pkc->pnk", corners_cam, R)
    if ndc is not None:
        ndir_c, _ = world2ndc(ndc, d_world_c, origin[:, None, :])
        d_tree_c = ndir_c * scale
    else:
        d_tree_c = d_world_c * scale
    uc, vc = _slopes_from_dirs(d_tree_c, perm)                  # (P, n)
    umin, umax = torch.amin(uc, -1), torch.amax(uc, -1)
    vmin, vmax = torch.amin(vc, -1), torch.amax(vc, -1)
    # half-texel guard band, PROPORTIONAL to each axis's slope range: an
    # absolute pad would swamp the tiny slope ranges of near-parallel ray
    # families (NDC cameras near the z = 0 plane warp to slopes ~2|oz|)
    ur = torch.clamp(umax - umin, min=1e-6)
    vr = torch.clamp(vmax - vmin, min=1e-6)
    upad = 0.5 * ur / gi
    vpad = 0.5 * vr / gi
    u0 = umin - upad
    v0 = vmin - vpad
    du = (umax + upad - u0) / (gi - 1)
    dv = (vmax + vpad - v0) / (gi - 1)
    return u0, du, v0, dv


class FrameGeom:
    """Per-frame slab geometry for a batch of P poses sharing (perm, flip):
    slope grid, per-pixel z intervals, camera in tree coords. Per-pose
    fields carry a leading P dimension.

    transforms: (P, 3, 4) or (3, 4) C2W [right|up|back|center].
    unit_slope_box: the split-frame class pass's fixed slope box (see
    _slope_grid).
    mesh_dist: optional (H, W), or (P, H, W), f32 euclidean camera distance
    of the nearest rasterized mesh fragment (inf where none:
    ops/rasterize.py MeshBuffers.dist). World trees only: each
    intermediate pixel's live z interval is clipped at the mesh surface,
    so the march stops at the mesh distance (volrend.cu:143-146) with the
    kernel's sub-slab precision (its boundary slabs count by their overlap
    with the interval)."""

    def __init__(self, grid: DenseGrid, transforms, fx, fy,
                 perm: Tuple[int, int, int], flip: bool,
                 width: int, height: int, opt: RenderOptions, gi: int,
                 unit_slope_box: bool = False, mesh_dist=None):
        dev = grid.device
        tr = to_device(transforms, _F32, dev).reshape(-1, 3, 4)
        P = tr.shape[0]
        self.R = R = tr[:, :, :3]
        self.fx = fx = to_device(fx, _F32, dev)
        self.fy = fy = to_device(fy, _F32, dev)
        self.scale = scale = grid.scale
        self.origin_w = o_w = tr[:, :, 3]
        self.ndc = ndc = grid.ndc
        if ndc is not None:
            # tree coords ARE NDC coords; the pinhole centre of the warped
            # ray family is pi(origin) (see _ndc_center_np)
            # the NDC map's x and y scales, in float32 as the reference's
            W_n, H_n, focal_n = (np.float32(v) for v in ndc)
            n_sx = float(-(np.float32(2.0) * focal_n) / W_n)
            n_sy = float(-(np.float32(2.0) * focal_n) / H_n)
            c_ndc = torch.stack([n_sx * o_w[:, 0] / o_w[:, 2],
                                 n_sy * o_w[:, 1] / o_w[:, 2],
                                 1.0 + 2.0 / o_w[:, 2]], -1)     # (P, 3)
            c_t = grid.offset + scale * c_ndc
        else:
            c_t = grid.offset + scale * o_w                     # (P, 3)
        self.cz, self.cy, self.cx = (c_t[:, perm[0]], c_t[:, perm[1]],
                                     c_t[:, perm[2]])
        cz, cy, cx = self.cz, self.cy, self.cx

        # ---- intermediate slope grid ----------------------------------------
        self.u0, self.du, self.v0, self.dv = u0, du, v0, dv = _slope_grid(
            R, fx, fy, scale, perm, width, height, gi, ndc=ndc, origin=o_w,
            unit_slope_box=unit_slope_box)
        io = torch.arange(gi, dtype=_F32, device=dev)
        # rows (axis perm[1]) / columns (axis perm[2]), (P, gi)
        self.uy = uy = u0[:, None] + du[:, None] * io
        self.ux = ux = v0[:, None] + dv[:, None] * io

        self.sgn = sgn = -1.0 if flip else 1.0

        # ---- shading-direction affine map -----------------------------------
        # the world view direction at a voxel is affine in the voxel's slope
        # coordinates (u, v): dir_world[a] = dirM[a,0] + dirM[a,1]*u +
        # dirM[a,2]*v. World trees: dir ~ sgn * permuted(1, u, v) / scale.
        # NDC trees: the world dir of the ray whose NDC line has slopes
        # (s_x', s_y') is dir ~ -(q_x/sx, q_y/sy, 1), q_j = c'_j + (1 -
        # c'_z) * s_j (the NDC line at z' = 1, where pi maps the world point
        # at infinity), still affine in (u, v)
        slot = {perm[0]: 0, perm[1]: 1, perm[2]: 2}
        if ndc is not None:
            zero = torch.zeros((P,), dtype=_F32, device=dev)
            one_m_cz = 1.0 - c_ndc[:, 2]
            rows = {2: [torch.full((P,), -1.0, dtype=_F32, device=dev),
                        zero, zero]}
            for axis, sdiv in ((0, n_sx), (1, n_sy)):
                c = [-c_ndc[:, axis] / sdiv, zero, zero]
                # NDC slope of axis j per slope-grid unit: scale[2]/scale[j]
                c[slot[axis]] = -one_m_cz * (scale[2] / scale[axis]) / sdiv
                rows[axis] = c
            self.dirM = torch.stack([torch.stack(rows[a], -1)
                                     for a in range(3)], 1)      # (P, 3, 3)
            # depth-mode t origin: rays start on the near plane z' = -1
            # (world2ndc parameterizes from the near-plane point)
            self.z0_depth = (grid.offset[2] - scale[2]).expand(P)
        else:
            inv_scale = 1.0 / scale
            dirM = torch.zeros((3, 3), dtype=_F32, device=dev)
            for a in range(3):
                dirM[a, slot[a]] = sgn * inv_scale[a]
            self.dirM = dirM.expand(P, 3, 3)
            self.z0_depth = cz

        bb = np.asarray(opt.render_bbox, np.float32)
        self.lo = lo = [float(v) for v in bb[:3][list(perm)]]
        self.hi = hi = [float(v) for v in bb[3:][list(perm)]]

        # ---- per-pixel live z-interval (volume entry/exit + t > 0) ----------
        big = 1e9

        def _axis_interval(cc, slope, a, b):
            tiny = torch.where(slope < 0, torch.full_like(slope, -1e-12),
                               torch.full_like(slope, 1e-12))
            degen = torch.abs(slope) < 1e-12
            sl = torch.where(degen, tiny, slope)
            za = cz[:, None] + (a - cc[:, None]) / sl
            zb = cz[:, None] + (b - cc[:, None]) / sl
            zmin = torch.minimum(za, zb)
            zmax = torch.maximum(za, zb)
            inside = ((cc >= a) & (cc < b))[:, None]
            zmin = torch.where(degen, torch.where(inside, -big, big), zmin)
            zmax = torch.where(degen, torch.where(inside, big, -big), zmax)
            return zmin, zmax

        ymin, ymax = _axis_interval(cy, uy, lo[1], hi[1])        # (P, gi)
        xmin, xmax = _axis_interval(cx, ux, lo[2], hi[2])
        z_lo_pix = torch.maximum(ymin[:, :, None], xmin[:, None, :])
        z_hi_pix = torch.minimum(ymax[:, :, None], xmax[:, None, :])
        z_lo_pix = torch.clamp(z_lo_pix, min=lo[0])
        z_hi_pix = torch.clamp(z_hi_pix, max=hi[0])
        # t > 0: nothing behind the camera centre. NDC rays start on the
        # near plane z' = -1 (the volume's z boundary), which the bbox clamp
        # above already enforces, and the warped centre may sit beyond the
        # far plane (cameras at z > 0)
        if ndc is None and flip:
            z_hi_pix = torch.minimum(z_hi_pix, cz[:, None, None])
        elif ndc is None:
            z_lo_pix = torch.maximum(z_lo_pix, cz[:, None, None])
        if mesh_dist is not None:
            if ndc is not None:
                raise ValueError("mesh compositing on the slab path "
                                 "supports world trees only (use the exact "
                                 "renderer)")
            z_mesh = self._mesh_zgrid(mesh_dist, width, height, gi, perm)
            if flip:
                z_lo_pix = torch.maximum(z_lo_pix, z_mesh)
            else:
                z_hi_pix = torch.minimum(z_hi_pix, z_mesh)
        self.z_lo_pix, self.z_hi_pix = z_lo_pix, z_hi_pix

    def _mesh_zgrid(self, mesh_dist, width: int, height: int, gi: int,
                    perm: Tuple[int, int, int]) -> torch.Tensor:
        """(P, gi, gi) slab-axis z of the mesh surface on each
        intermediate pixel's ray: the screen distance buffer sampled
        nearest at the pixel's screen position (a silhouette quantized to
        a screen pixel, the order of the warp's own resampling) and turned
        from euclidean camera distance into z = cz + sgn * d / |w|, w the
        world direction per unit of slab z; inf where the ray meets no
        mesh. The reference gathers 8-wide rows with a one-hot select (a
        TPU gather workaround); a plain gather gives what it computes."""
        uy, ux, sgn, R = self.uy, self.ux, self.sgn, self.R
        P = R.shape[0]
        inv_scale = 1.0 / self.scale
        d_perm = [torch.full((P, gi, gi), sgn, dtype=_F32, device=R.device),
                  (sgn * uy[:, :, None]).expand(P, gi, gi),
                  (sgn * ux[:, None, :]).expand(P, gi, gi)]
        d_tree = [None] * 3
        for i in range(3):
            d_tree[perm[i]] = d_perm[i]
        d_world = torch.stack([d_tree[a] * inv_scale[a] for a in range(3)],
                              -1)
        d_cam = torch.einsum("pyxk,pkc->pyxc", d_world, R)      # R^T d
        front = d_cam[..., 2] < -1e-9
        dz = torch.where(front, d_cam[..., 2], -1e-9)
        sx = (d_cam[..., 0] / -dz) * self.fx + 0.5 * width
        sy = -(d_cam[..., 1] / -dz) * self.fy + 0.5 * height
        jx = torch.round(sx).to(torch.int64)
        jy = torch.round(sy).to(torch.int64)
        valid = front & (jx >= 0) & (jx < width) & (jy >= 0) & (jy < height)
        flat = (torch.clamp(jy, 0, height - 1) * width
                + torch.clamp(jx, 0, width - 1))
        md = to_device(mesh_dist, _F32, R.device).reshape(-1, height * width)
        dist = torch.gather(md.expand(P, -1), 1, flat.reshape(P, -1))
        dist = torch.where(valid, dist.reshape(P, gi, gi), float("inf"))
        L = torch.sqrt(inv_scale[perm[0]] ** 2
                       + (uy[:, :, None] * inv_scale[perm[1]]) ** 2
                       + (ux[:, None, :] * inv_scale[perm[2]]) ** 2)
        return self.cz[:, None, None] + sgn * dist / L


def _march_frame_fields(grid: DenseGrid, g: FrameGeom, perm, flip: bool,
                        opt: RenderOptions):
    """The march kernel's per-pose scalar params (P, 30) and per-pixel z
    interval (P, 2, gi, gi) from a pose batch's geometry."""
    inv_scale_t = 1.0 / g.scale
    params = slab_march._pack_params(
        g.cz, g.cy, g.cx, g.u0, g.du, g.v0, g.dv,
        -1.0 if flip else 1.0,
        (inv_scale_t[perm[0]], inv_scale_t[perm[1]], inv_scale_t[perm[2]]),
        (inv_scale_t[0], inv_scale_t[1], inv_scale_t[2]),
        float(opt.sigma_thresh), float(opt.stop_thresh),
        g.lo[1], g.hi[1], g.lo[2], g.hi[2], g.dirM, g.z0_depth)
    zb = torch.stack([g.z_lo_pix, g.z_hi_pix], 1)
    return params, zb


def _bbox_full(opt: RenderOptions) -> bool:
    """Is render_bbox the default full cube?"""
    return tuple(float(v) for v in opt.render_bbox) == (
        0.0, 0.0, 0.0, 1.0, 1.0, 1.0)


def _march_finalize(grid: DenseGrid, payload, params, zb, R, u0, du, v0, dv,
                    fx, fy, perm: Tuple[int, int, int], flip: bool,
                    width: int, height: int, opt: RenderOptions, gi: int,
                    out_dtype=None, crop=None, fits=None, origin=None,
                    bg_pix=None):
    """March a pose batch through the fused kernel (one launch), finalize
    planar (rt_core.cuh:176-194 semantics) and warp to the screen (``fits``:
    the warp's fit plan, queued ahead of the march; ``origin``: the poses'
    (P, 3) camera origins, which an NDC tree's warp reads; ``bg_pix``: the
    mesh background, display_warp.mesh_background). The march's two knobs
    are slab_march._BF16_SHADE and slab_march._DIR_WIN, read here at call
    time, as the reference reads pallas_slab's."""
    slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)
    blo, bhi = opt.basis_minmax
    rotm = _rodrigues_matrix(opt.rot_dirs)
    acc4 = slab_march.march_slabs(
        payload, params, grid.qscale, zb, grid.G, gi, grid.data_dim,
        grid.basis_dim, perm, slab_ids=slab_ids,
        basis_lo=int(blo), basis_hi=int(bhi), sig2=grid.quantized,
        extra=grid.extra, fmt=int(grid.fmt),
        depth=bool(opt.render_depth),
        rot=(None if rotm is None
             else tuple(float(v) for v in rotm.reshape(-1))),
        flip=flip, bbox_full=_bbox_full(opt),
        shade_bf16=slab_march._BF16_SHADE, dir_win=slab_march._DIR_WIN,
        k_per_step=slab_march._K_STEP, crop=crop)
    return _warp_to_screen(_finalize_planar(acc4, opt), opt, R, fx, fy,
                           width, height, gi, perm, u0, du, v0, dv,
                           grid.scale, out_dtype=out_dtype, planar=True,
                           fits=fits, ndc=grid.ndc, origin=origin,
                           bg_pix=bg_pix)


def _finalize_planar(acc4: torch.Tensor, opt: RenderOptions) -> torch.Tensor:
    """(P, 4, gi, gi) march accumulator [r, g, b, T] -> the planar
    intermediate image [r, g, b, alpha] (rt_core.cuh:176-194 semantics:
    rays that stopped early renormalize their colour and report alpha 1).
    Depth mode: acc[0] is the accumulated depth; the image is [dep, dep,
    dep, 1] with dep = min(0.3 * depth, 1), renormalized as the colour."""
    T = acc4[:, 3]
    stopped = T < float(opt.stop_thresh)
    renorm = stopped & opt.renormalize
    if opt.render_depth:
        dep = torch.clamp(acc4[:, 0] * 0.3, max=1.0)
        dep = torch.where(renorm, dep / (1.0 - T), dep)
        return torch.stack([dep, dep, dep, torch.ones_like(dep)], 1)
    rgb = torch.where(renorm[:, None], acc4[:, :3] / (1.0 - T)[:, None],
                      acc4[:, :3])
    alpha = torch.where(stopped, 1.0, 1.0 - T)
    return torch.cat([rgb, alpha[:, None]], 1)


def render_frames(grid: DenseGrid, transforms, fx, fy,
                  perm: Tuple[int, int, int], flip: bool,
                  width: int, height: int, opt: RenderOptions,
                  gi: int = 512, payload=None, out_dtype=None,
                  unit_slope_box: bool = False):
    """Render a batch of poses sharing one (perm, flip) group; the permuted
    payload is materialized once for the batch (or passed in via
    ``payload``, see prepare_payload). Returns (N, H, W, 4) on the grid's
    device: float32, or uint8 when ``out_dtype=torch.uint8`` (the RGBA8
    display write-out, volrend.cu:166-172). ``unit_slope_box``: a
    split-frame class pass (render_frame_split). Meshes are
    render_frame's and render_frame_split's, as in the reference."""
    return _render_batch(grid, transforms, fx, fy, perm, flip, width,
                         height, opt, gi, payload, out_dtype, unit_slope_box)


def _render_batch(grid: DenseGrid, transforms, fx, fy,
                  perm: Tuple[int, int, int], flip: bool, width: int,
                  height: int, opt: RenderOptions, gi: int, payload=None,
                  out_dtype=None, unit_slope_box: bool = False,
                  mesh_dist=None, mesh_rgb=None):
    """render_frames, with an optional mesh pass's buffers (mesh_dist
    (P, H, W) or (H, W), mesh_rgb (P, H, W, 3) or (H, W, 3)): the march
    clipped at the mesh and the warp composited over it."""
    _kernel_ok(grid)
    crop = inplane_crop(grid, perm, float(opt.sigma_thresh))
    if payload is None:
        payload = _permuted_grid(grid, perm, crop=crop)
    g = FrameGeom(grid, transforms, fx, fy, perm, flip, width, height, opt,
                  gi, unit_slope_box=unit_slope_box, mesh_dist=mesh_dist)
    bg_pix = None
    if mesh_dist is not None:
        bg_pix = display_warp.mesh_background(mesh_dist, mesh_rgb,
                                              g.R.shape[0], height, width,
                                              grid.device)
    # the warp's fit decisions go to the card ahead of the march, so the
    # host reads them while kernel M runs
    fits = None
    if display_warp.usable(width, height, gi):
        fits = display_warp.plan_fits(g.R, g.fx, g.fy, width, height, gi,
                                      perm, g.u0, g.du, g.v0, g.dv, g.scale,
                                      ndc=grid.ndc, origin=g.origin_w)
    params, zb = _march_frame_fields(grid, g, perm, flip, opt)
    return _march_finalize(grid, payload, params, zb, g.R, g.u0, g.du, g.v0,
                           g.dv, g.fx, g.fy, perm, flip, width, height, opt,
                           gi, out_dtype=out_dtype, crop=crop, fits=fits,
                           origin=g.origin_w, bg_pix=bg_pix)


def render_frame(grid: DenseGrid, transform, fx, fy,
                 perm: Tuple[int, int, int], flip: bool,
                 width: int, height: int, opt: RenderOptions,
                 gi: int = 512, payload=None,
                 mesh_dist=None, mesh_rgb=None, out_dtype=None):
    """Render one pinhole frame; returns (H, W, 4) (float32, or uint8 with
    out_dtype=torch.uint8). transform: (3,4) C2W. perm/flip: from
    choose_axis. mesh_dist/mesh_rgb: optional (H, W) euclidean mesh
    distance (inf where none) and (H, W, 3) mesh colour, the buffers of
    ops/rasterize.py: the march is clipped at the mesh surface and its
    remaining transmittance composited over the mesh colour, alpha 1 on
    mesh pixels (volrend.cu:143-163). World trees only: NDC trees take
    meshes on the exact renderer, as in the reference (ValueError)."""
    if mesh_dist is not None and grid.ndc is not None:
        raise ValueError("mesh compositing on the slab path supports world "
                         "trees only; use the exact renderer")
    if (mesh_dist is None) != (mesh_rgb is None):
        raise ValueError("mesh_dist and mesh_rgb come together")
    tr = torch.as_tensor(transform, dtype=_F32).reshape(1, 3, 4)
    return _render_batch(grid, tr, fx, fy, perm, flip, width, height, opt,
                         gi, payload, out_dtype, mesh_dist=mesh_dist,
                         mesh_rgb=mesh_rgb)[0]


def _warp_to_screen(inter, opt: RenderOptions, R, fx, fy,
                    width: int, height: int, gi: int, perm,
                    u0, du, v0, dv, scale, out_dtype=None,
                    planar: bool = False, precise: bool = False,
                    fits=None, ndc=None, origin=None, bg_pix=None):
    """Projective bilinear warp of a batch of intermediate images
    ((P, gi, gi, 4), or planar (P, 4, gi, gi)) to (P, H, W, 4) screens plus
    background compositing: the superquad warp where it applies, else the
    reference quad-gather warp.

    precise: the training path's warp, differentiable w.r.t. ``inter``.
    With ``display_warp._PRECISE_SQ`` on (read at call time; off by
    default, as in the reference) and ``usable_precise``, each pose whose
    (2, 2)-block, 4 x 4-window level fits takes the precise superquad warp
    (``display_warp.warp_precise``: f32 tables and a hand-written
    backward); every other pose takes the reference quad-gather warp with
    an f32 quad table, differentiated by autograd (the gather's backward
    is a scatter-add). ``fits``: the fit decisions, computed by the
    caller without waiting for the device: for the precise warp a host
    (P,) bool array of the per-pose predicates (slab_grad.
    render_frame_train computes it from the camera), for the display warp
    a display_warp.FitPlan (render_frames queues it ahead of the march);
    None computes them here and reads them back, which waits for the
    queued work. ``ndc``/``origin``: an NDC tree's sidecar and the poses'
    (P, 3) camera origins. ``bg_pix``: the display path's mesh background
    (display_warp.mesh_background: (P, H, W, 4) f16 [r, g, b, hit]),
    composited by kernel W's mesh mode or the reference warp; the
    training path takes none."""
    if precise:
        if bg_pix is not None:
            raise ValueError("the training warp takes no mesh background")
        if planar:
            inter = inter.movedim(1, -1)
        geom = (R, fx, fy, width, height, gi, perm, u0, du, v0, dv, scale)
        if (display_warp._PRECISE_SQ
                and display_warp.usable_precise(width, height, gi)):
            out = _warp_precise_routed(inter, opt, geom, fits, ndc, origin)
        else:
            out = _warp_to_screen_ref(inter, opt, *geom, precise=True,
                                      ndc=ndc, origin=origin)
        return display_warp.to_display_dtype(out, out_dtype)
    if display_warp.usable(width, height, gi):
        return display_warp.warp_to_screen_sq(
            inter, opt, R, fx, fy, width, height, gi, perm,
            u0, du, v0, dv, scale, out_dtype=out_dtype, planar=planar,
            plan=fits, ndc=ndc, origin=origin, bg_pix=bg_pix)
    if planar:
        inter = inter.movedim(1, -1)
    return display_warp.to_display_dtype(
        _warp_to_screen_ref(inter, opt, R, fx, fy, width, height, gi,
                            perm, u0, du, v0, dv, scale, ndc=ndc,
                            origin=origin, bg_pix=bg_pix), out_dtype)


def _warp_precise_routed(inter, opt: RenderOptions, geom, fits=None,
                         ndc=None, origin=None):
    """The precise warp per pose (the reference's lax.cond on the fit
    predicate): the superquad warp for the poses that fit, the reference
    warp for the others. geom = the _warp_to_screen_ref geometry args;
    ``ndc``/``origin`` an NDC tree's."""
    gi = geom[5]
    if fits is None:
        fits = display_warp._level_fits(
            *display_warp._pixel_slopes(*geom, ndc, origin), gi,
            display_warp._PRECISE_B, display_warp._PRECISE_WIN).cpu().numpy()
    fits = np.asarray(fits, bool).reshape(-1)
    bg = float(opt.background_brightness)
    idx = np.argsort(~fits, kind="stable")       # fitting poses first
    nfit = int(fits.sum())
    parts = []
    for sel, sq in ((idx[:nfit], True), (idx[nfit:], False)):
        if sel.size == 0:
            continue
        if sel.size == len(fits):            # the whole batch: no copies
            it, sub = inter, geom + (ndc, origin)
        else:
            s = torch.as_tensor(sel, device=inter.device)
            it = inter.index_select(0, s)
            sub = display_warp._select_geom(geom + (ndc, origin), s)
        args = sub[:12]
        sub_ndc = dict(ndc=ndc, origin=sub[13] if ndc is not None else None)
        parts.append(display_warp.warp_precise(it, bg, *args, **sub_ndc)
                     if sq else _warp_to_screen_ref(it, opt, *args,
                                                    precise=True, **sub_ndc))
    if len(parts) == 1:
        return parts[0]
    inv = torch.as_tensor(np.argsort(idx), device=inter.device)
    return torch.cat(parts).index_select(0, inv)


def _warp_to_screen_ref(inter, opt: RenderOptions, R, fx, fy,
                        width: int, height: int, gi: int, perm,
                        u0, du, v0, dv, scale, precise: bool = False,
                        ndc=None, origin=None, bg_pix=None):
    """Reference warp: per-pixel quad-row gather (the exact display
    semantics the superquad warp is held against), in plain PyTorch.

    inter: (P, gi, gi, 4); R (P, 3, 3); u0/du/v0/dv (P,). The quad table
    and the bilinear combine are float16, as on the reference's display
    path, or float32 with ``precise`` (the training path: f16 would
    quantize the outputs below a gradient step). Linear in ``inter`` and
    differentiable by autograd. Returns (P, H, W, 4) float32. An NDC tree
    (``ndc``) maps each pixel's ray through world2ndc from its pose's
    ``origin`` (P, 3). ``bg_pix``: a mesh background ((P, H, W, 4) [r, g,
    b, hit], display_warp.mesh_background): the remaining transmittance
    composites over the mesh colour where hit, and alpha is 1 there
    (volrend.cu:152-163). Display-path calls (not ``precise``) count their
    poses in ``poses``, training calls in ``precise_poses``: a run shows
    with them that no pose fell back here."""
    if precise:
        _warp_to_screen_ref.precise_poses += inter.shape[0]
    else:
        _warp_to_screen_ref.poses += inter.shape[0]
    dev = inter.device
    fx = torch.as_tensor(fx, dtype=_F32, device=dev)
    fy = torch.as_tensor(fy, dtype=_F32, device=dev)
    px = (torch.arange(width, dtype=_F32, device=dev) - 0.5 * width) / fx
    py = -(torch.arange(height, dtype=_F32, device=dev) - 0.5 * height) / fy
    d_cam = torch.stack([
        px[None, :].expand(height, width),
        py[:, None].expand(height, width),
        torch.full((height, width), -1.0, dtype=_F32, device=dev)], -1)
    d_world_s = torch.einsum("hwc,pkc->phwk", d_cam, R)
    if ndc is not None:
        # the screen->slope map is a homography of the warped rays; this
        # per-pixel resample absorbs it, as in the world-tree case
        ndir_s, _ = world2ndc(ndc, d_world_s, origin[:, None, None, :])
        d_tree_s = ndir_s * scale
    else:
        d_tree_s = d_world_s * scale
    us, vs = _slopes_from_dirs(d_tree_s, perm)                 # (P, H, W)
    gy = (us - u0[:, None, None]) / du[:, None, None]
    gx = (vs - v0[:, None, None]) / dv[:, None, None]
    ok = (gy >= 0) & (gy <= gi - 1) & (gx >= 0) & (gx <= gi - 1)
    gy = torch.clamp(gy, 0.0, gi - 1 - 1e-6)
    gx = torch.clamp(gx, 0.0, gi - 1 - 1e-6)
    y0 = torch.floor(gy).to(torch.int32)
    x0 = torch.floor(gx).to(torch.int32)
    fy_ = (gy - y0)[..., None]
    fx_ = (gx - x0)[..., None]
    # all four bilinear corners as one quad row [v00|v01|v10|v11]
    # (float16: display-range rgba; f32 when precise)
    inter16 = inter.to(_F32 if precise else torch.float16)
    quad = torch.cat([inter16[:, :-1, :-1], inter16[:, :-1, 1:],
                      inter16[:, 1:, :-1], inter16[:, 1:, 1:]], -1)
    P = inter.shape[0]
    y0c = torch.clamp(y0, max=gi - 2)
    x0c = torch.clamp(x0, max=gi - 2)
    flat = (y0c * (gi - 1) + x0c).reshape(P, -1).long()
    q = torch.gather(quad.reshape(P, (gi - 1) * (gi - 1), 16), 1,
                     flat[..., None].expand(-1, -1, 16)
                     ).reshape(P, height, width, 4, 4)
    if not precise:
        fy_ = fy_.to(torch.float16)
        fx_ = fx_.to(torch.float16)
    v00, v01, v10, v11 = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    out = ((v00 * (1 - fx_) + v01 * fx_) * (1 - fy_)
           + (v10 * (1 - fx_) + v11 * fx_) * fy_)
    out = torch.where(ok[..., None], out, torch.zeros_like(out)).to(_F32)
    bg = float(opt.background_brightness)
    if bg_pix is None:
        rgb = out[..., :3] + bg * (1.0 - out[..., 3:4])
        return torch.cat([rgb, out[..., 3:4]], -1)
    mesh = bg_pix.to(_F32)
    hit = mesh[..., 3:4] > 0.5
    bgp = torch.where(hit, mesh[..., :3], bg)
    rgb = out[..., :3] + bgp * (1.0 - out[..., 3:4])
    return torch.cat([rgb, torch.where(hit, 1.0, out[..., 3:4])], -1)


#: poses warped through the reference warp (plain counters, so a run can
#: show that no pose fell back): display fallbacks, and training-path
#: poses (every pose with _PRECISE_SQ off; the misfit poses with it on)
_warp_to_screen_ref.poses = 0
_warp_to_screen_ref.precise_poses = 0


def _evict_perm(cache: dict, perm) -> None:
    """Drop a perm's stale payload entries before inserting a new crop
    variant: each payload is hundreds of MB at bench scale, and a viewer
    sigma_thresh slider session would otherwise keep one per crop."""
    for k in [k for k in cache
              if isinstance(k, tuple) and len(k) == 2 and k[0] == perm]:
        del cache[k]


def _cached_payload(grid: DenseGrid, perm, opt: RenderOptions,
                    cache: Optional[dict]):
    """The payload of ``perm`` from ``cache`` (keyed by (perm, crop): the
    crop depends on opt.sigma_thresh, so a threshold change misses the
    cache), built and stored on a miss; None without a cache."""
    if cache is None:
        return None
    key = (perm, inplane_crop(grid, perm, float(opt.sigma_thresh)))
    if key not in cache:
        _evict_perm(cache, perm)
        cache[key] = prepare_payload(grid, perm, opt)
    return cache[key]


def split_classes(grid: DenseGrid, transform, fx, fy, width: int,
                  height: int) -> Tuple[Tuple[int, bool], ...]:
    """The (axis, sign) classes of a pose's rays by their dominant tree
    axis, found on a 33 x 33 probe grid that includes the image boundary
    (the classes' regions are cones, so the probe finds every non-empty
    one); sorted."""
    tf = _host(transform).reshape(3, 4)
    n = 33
    pxg, pyg = np.meshgrid(np.linspace(0, width, n),
                           np.linspace(0, height, n))
    d_cam = np.stack([(pxg.reshape(-1) - 0.5 * width) / fx,
                      -(pyg.reshape(-1) - 0.5 * height) / fy,
                      -np.ones(n * n)], -1)
    d_tree = (d_cam @ tf[:, :3].T) * _host(grid.scale)
    m = np.argmax(np.abs(d_tree), -1)
    neg = d_tree[np.arange(n * n), m] < 0
    return tuple(sorted({(int(a), bool(f)) for a, f in zip(m, neg)}))


def render_frame_split(grid: DenseGrid, transform, fx, fy, width: int,
                       height: int, opt: RenderOptions, gi: int = 384,
                       payload_cache: Optional[dict] = None,
                       mesh_dist=None, mesh_rgb=None) -> torch.Tensor:
    """Render ANY world-tree pinhole pose by split-frame slab passes;
    returns (H, W, 4) float32 on the grid's device.

    Steep/wide/interior poses break the single-axis gate (rays straddle
    the slab axis, or boundary slopes exceed MAX_SLAB_SLOPE). But every
    ray has a dominant tree axis, and within the class of rays dominated
    by axis m with one sign every slope magnitude is <= 1. So each
    (axis, sign) class (split_classes) renders as one full-frame pass of
    render_frames over the fixed unit slope box with perm (axis, axis+1,
    axis+2), and the passes are stitched per pixel by the argmax class of
    the pixel's ray, in f32 (plain tensor ops). ``payload_cache``: as for
    render_image, shared by the passes. mesh_dist/mesh_rgb: a mesh pass's
    buffers, as for render_frame: every class pass clips at the mesh and
    composites over it, and the stitch keeps the owning pass's pixels, so
    mesh pixels keep alpha 1. NDC trees raise ValueError (the NDC warp's
    slope caustic is not axis-separable; the exact renderer takes such
    poses)."""
    if grid.ndc is not None:
        raise ValueError("render_frame_split supports world trees only")
    if (mesh_dist is None) != (mesh_rgb is None):
        raise ValueError("mesh_dist and mesh_rgb come together")
    classes = split_classes(grid, transform, fx, fy, width, height)
    tr = to_device(transform, _F32, grid.device).reshape(1, 3, 4)
    outs = []
    for axis, flip in classes:
        perm = (axis, (axis + 1) % 3, (axis + 2) % 3)
        outs.append(_render_batch(
            grid, tr, fx, fy, perm, flip, width, height, opt, gi,
            payload=_cached_payload(grid, perm, opt, payload_cache),
            unit_slope_box=True, mesh_dist=mesh_dist,
            mesh_rgb=mesh_rgb)[0])
    dev = grid.device
    px = (torch.arange(width, dtype=_F32, device=dev) - 0.5 * width) / fx
    py = -(torch.arange(height, dtype=_F32, device=dev) - 0.5 * height) / fy
    d_cam = torch.stack([px[None, :].expand(height, width),
                         py[:, None].expand(height, width),
                         torch.full((height, width), -1.0, dtype=_F32,
                                    device=dev)], -1)
    d_tree = torch.einsum("hwc,kc->hwk", d_cam, tr[0, :, :3]) * grid.scale
    m = torch.argmax(torch.abs(d_tree), -1)
    neg = torch.gather(d_tree, -1, m[..., None])[..., 0] < 0
    out = torch.zeros((height, width, 4), dtype=_F32, device=dev)
    for (axis, flip), img in zip(classes, outs):
        sel = (m == axis) & (neg == flip)
        out = torch.where(sel[..., None], img, out)
    return out


def _mesh_buffers(grid: DenseGrid, cam, opt: RenderOptions, meshes,
                  host_tree):
    """The host mesh pass of a frame (cuda_renderer.cpp:103-112): the
    visible meshes and, with ``opt.show_grid`` and a ``host_tree``, its
    wireframe, rasterized into (H, W) distance and (H, W, 3) colour
    buffers, both f16 as the reference uploads them; (None, None) when no
    mesh covers a pixel. NDC trees raise ValueError (the exact renderer
    takes meshes on them, as in the reference)."""
    mesh_list = list(meshes) if meshes else []
    if opt.show_grid and host_tree is not None:
        from volrend_torch.ops.composite import wireframe_mesh
        mesh_list.append(wireframe_mesh(host_tree, opt.grid_max_depth))
    if not mesh_list:
        return None, None
    if grid.ndc is not None:
        raise ValueError("mesh compositing on the slab path supports world "
                         "trees only; use the exact renderer")
    from volrend_torch.ops.rasterize import rasterize_meshes
    buf = rasterize_meshes(mesh_list, cam)
    if not np.isfinite(buf.dist).any():
        return None, None
    return buf.dist.astype(np.float16), buf.color.astype(np.float16)


def render_image(grid: DenseGrid, cam, opt: RenderOptions,
                 gi: Optional[int] = None,
                 payload_cache: Optional[dict] = None,
                 meshes: Optional[Sequence] = None,
                 host_tree=None, out_dtype=None) -> np.ndarray:
    """Camera-object convenience wrapper; returns (H, W, 4) on the host.

    gi: intermediate resolution; None picks default_gi(grid).
    payload_cache: optional mutable dict keyed by (perm, crop): pre-permuted
    payloads are built lazily and reused across calls.
    Steep world-tree poses (slope >= MAX_SLAB_SLOPE, or rays straddling the
    slab axis) render as split frames (render_frame_split), stitched in
    f32 and converted to ``out_dtype`` once. NDC poses the slab path cannot
    take (an interior camera, rays straddling the NDC z axis) raise
    ValueError: the exact renderer (render_exact) takes them.
    meshes: mesh overlays (models/mesh.py) rasterized on the host, as the
    reference's GL mesh pass (cuda_renderer.cpp:103-112), and composited
    on world trees (render_frame's mesh_dist/mesh_rgb); host_tree: the
    source N3Tree, for the ``opt.show_grid`` wireframe. NDC trees with
    meshes raise ValueError, as in the reference."""
    if gi is None:
        gi = default_gi(grid)
    perm, flip, slope = choose_axis(
        grid, cam.transform, cam.fx, cam.fy, cam.width, cam.height)
    if not (np.isfinite(slope) and slope < MAX_SLAB_SLOPE):
        if grid.ndc is not None:
            raise ValueError("pose not renderable by the slab path (rays "
                             "straddle the slab axis); use render_exact")
        md, mr = _mesh_buffers(grid, cam, opt, meshes, host_tree)
        out = render_frame_split(grid, cam.transform, cam.fx, cam.fy,
                                 cam.width, cam.height, opt, gi=gi,
                                 payload_cache=payload_cache, mesh_dist=md,
                                 mesh_rgb=mr)
        return display_warp.to_display_dtype(out, out_dtype).cpu().numpy()
    md, mr = _mesh_buffers(grid, cam, opt, meshes, host_tree)
    out = render_frame(grid, cam.transform, cam.fx, cam.fy, perm, flip,
                       cam.width, cam.height, opt, gi,
                       payload=_cached_payload(grid, perm, opt,
                                               payload_cache),
                       mesh_dist=md, mesh_rgb=mr, out_dtype=out_dtype)
    return out.cpu().numpy()
