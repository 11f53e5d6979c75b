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
   quad-gather warp (``_warp_to_screen_ref``) when a pose misfits.

Every function takes a batch of poses: per-pose values are tensors with a
leading pose dimension (P, ...), the pose-invariant ones (fx, fy, grid
metadata) are shared. Only the display path's world-tree SH int8 route is
ported here; steep poses (split-frame), NDC trees and mesh overlays raise
``NotImplementedError`` naming the slice that brings them (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.ops import display_warp, slab_march
from volrend_torch.ops.dense_grid import DenseGrid
from volrend_torch.ops.render_exact import _rodrigues_matrix
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

__all__ = ["choose_axis", "compatible", "render_frame", "render_frames",
           "render_image", "prepare_payload", "default_gi", "inplane_crop"]

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

_SLICE_B = "slice B of the port (ROADMAP.md)"


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
    sign); inf when not."""
    if grid.ndc is not None:
        raise NotImplementedError(f"NDC trees come with {_SLICE_B}")
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


def _kernel_ok(grid: DenseGrid, opt: RenderOptions) -> None:
    """Raise unless the grid and options are the display path's: a world
    tree with an SH int8 payload (other formats/options: later slices)."""
    if grid.ndc is not None:
        raise NotImplementedError(f"NDC trees come with {_SLICE_B}")
    bt = BasisType(grid.fmt)
    if not (bt == BasisType.SH and grid.basis_dim in (1, 4, 9, 16, 25)
            and grid.data_dim == 3 * grid.basis_dim + 1):
        raise NotImplementedError(
            f"format {bt.name}{grid.basis_dim} comes with {_SLICE_B}")
    if not grid.quantized:
        raise NotImplementedError(
            "the march takes the int8 bake; a bf16 (f16-bake) payload "
            f"comes with {_SLICE_B}")


def _permuted_grid(grid: DenseGrid, perm, crop=None) -> torch.Tensor:
    """Channel-planar slab-major payload (z, Dp, y, x), in-plane-sliced to
    ``crop`` when given (a fresh contiguous tensor)."""
    planar = grid.data.permute(perm[0], 3, perm[1], perm[2])
    if crop is not None:
        y0, Gy, x0, Gx = crop
        planar = planar[:, :, y0:y0 + Gy, x0:x0 + Gx]
    return planar.contiguous()


def prepare_payload(grid: DenseGrid, perm: Tuple[int, int, int],
                    opt: RenderOptions) -> torch.Tensor:
    """Materialize the slab-major payload for one slab axis ONCE (scene
    prep) so repeated ``render_frames`` calls skip the per-call permute.
    Cache by the FULL ``perm`` (only flip is free: it is the march order)."""
    _kernel_ok(grid, opt)
    crop = inplane_crop(grid, perm, float(opt.sigma_thresh))
    return _permuted_grid(grid, perm, crop=crop)


def default_gi(grid: DenseGrid) -> int:
    """Intermediate-plane resolution matched to the volume: gi = G rounded
    up to a multiple of 128, in [128, 512]."""
    return int(min(512, max(128, -(-grid.G // 128) * 128)))


class FrameGeom:
    """Per-frame slab geometry for a batch of P poses sharing (perm, flip):
    slope grid, per-pixel z intervals, camera in tree coords. Per-pose
    fields carry a leading P dimension.

    transforms: (P, 3, 4) or (3, 4) C2W [right|up|back|center]."""

    def __init__(self, grid: DenseGrid, transforms, fx, fy,
                 perm: Tuple[int, int, int], flip: bool,
                 width: int, height: int, opt: RenderOptions, gi: int):
        if grid.ndc is not None:
            raise NotImplementedError(f"NDC trees come with {_SLICE_B}")
        dev = grid.device
        tr = to_device(transforms, _F32, dev).reshape(-1, 3, 4)
        self.R = R = tr[:, :, :3]
        self.fx = fx = to_device(fx, _F32, dev)
        self.fy = fy = to_device(fy, _F32, dev)
        self.scale = scale = grid.scale
        self.origin_w = o_w = tr[:, :, 3]
        c_t = grid.offset + scale * o_w                         # (P, 3)
        self.cz, self.cy, self.cx = (c_t[:, perm[0]], c_t[:, perm[1]],
                                     c_t[:, perm[2]])
        cz, cy, cx = self.cz, self.cy, self.cx

        # ---- intermediate slope grid ----------------------------------------
        corners_cam = to_device(_cam_corners(width, height, 1.0, 1.0), _F32,
                                dev)
        # rescale the unit-focal boundary by the actual fx/fy
        corners_cam = torch.stack([corners_cam[:, 0] * (1.0 / fx),
                                   corners_cam[:, 1] * (1.0 / fy),
                                   corners_cam[:, 2]], -1)
        d_world_c = torch.einsum("nc,pkc->pnk", corners_cam, R)
        d_tree_c = d_world_c * scale
        uc, vc = _slopes_from_dirs(d_tree_c, perm)              # (P, n)
        umin, umax = torch.amin(uc, -1), torch.amax(uc, -1)
        vmin, vmax = torch.amin(vc, -1), torch.amax(vc, -1)
        # half-texel guard band, proportional to each axis's slope range
        ur = torch.clamp(umax - umin, min=1e-6)
        vr = torch.clamp(vmax - vmin, min=1e-6)
        upad = 0.5 * ur / gi
        vpad = 0.5 * vr / gi
        self.u0 = u0 = umin - upad
        u1 = umax + upad
        self.v0 = v0 = vmin - vpad
        v1 = vmax + vpad
        self.du = du = (u1 - u0) / (gi - 1)
        self.dv = dv = (v1 - v0) / (gi - 1)
        io = torch.arange(gi, dtype=_F32, device=dev)
        # rows (axis perm[1]) / columns (axis perm[2]), (P, gi)
        self.uy = uy = u0[:, None] + du[:, None] * io
        self.ux = ux = v0[:, None] + dv[:, None] * io

        self.sgn = sgn = -1.0 if flip else 1.0

        # ---- shading-direction affine map -----------------------------------
        # the world view direction at a voxel is affine in the voxel's slope
        # coordinates (u, v): dir_world[a] = dirM[a,0] + dirM[a,1]*u +
        # dirM[a,2]*v; for world trees dir ~ sgn * permuted(1, u, v) / scale
        slot = {perm[0]: 0, perm[1]: 1, perm[2]: 2}
        inv_scale = 1.0 / scale
        dirM = torch.zeros((3, 3), dtype=_F32, device=dev)
        for a in range(3):
            dirM[a, slot[a]] = sgn * inv_scale[a]
        self.dirM = dirM.expand(R.shape[0], 3, 3)
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
        # t > 0: nothing behind the camera centre
        if flip:
            z_hi_pix = torch.minimum(z_hi_pix, cz[:, None, None])
        else:
            z_lo_pix = torch.maximum(z_lo_pix, cz[:, None, None])
        self.z_lo_pix, self.z_hi_pix = z_lo_pix, z_hi_pix


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
                    out_dtype=None, crop=None):
    """March a pose batch through the fused kernel (one launch), finalize
    planar (rt_core.cuh:176-194 semantics) and warp to the screen."""
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
        flip=flip, bbox_full=_bbox_full(opt), shade_bf16=False,
        dir_win=True, k_per_step=slab_march._K_STEP, crop=crop)
    return _warp_to_screen(_finalize_planar(acc4, opt), opt, R, fx, fy,
                           width, height, gi, perm, u0, du, v0, dv,
                           grid.scale, out_dtype=out_dtype, planar=True)


def _finalize_planar(acc4: torch.Tensor, opt: RenderOptions) -> torch.Tensor:
    """(P, 4, gi, gi) march accumulator [r, g, b, T] -> the planar
    intermediate image [r, g, b, alpha] (rt_core.cuh:176-194 semantics:
    rays that stopped early renormalize their colour and report alpha 1)."""
    T = acc4[:, 3]
    stopped = T < float(opt.stop_thresh)
    renorm = stopped & opt.renormalize
    rgb = torch.where(renorm[:, None], acc4[:, :3] / (1.0 - T)[:, None],
                      acc4[:, :3])
    alpha = torch.where(stopped, 1.0, 1.0 - T)
    return torch.cat([rgb, alpha[:, None]], 1)


def render_frames(grid: DenseGrid, transforms, fx, fy,
                  perm: Tuple[int, int, int], flip: bool,
                  width: int, height: int, opt: RenderOptions,
                  gi: int = 512, payload=None, out_dtype=None):
    """Render a batch of poses sharing one (perm, flip) group; the permuted
    payload is materialized once for the batch (or passed in via
    ``payload``, see prepare_payload). Returns (N, H, W, 4) on the grid's
    device: float32, or uint8 when ``out_dtype=torch.uint8`` (the RGBA8
    display write-out, volrend.cu:166-172)."""
    _kernel_ok(grid, opt)
    crop = inplane_crop(grid, perm, float(opt.sigma_thresh))
    if payload is None:
        payload = _permuted_grid(grid, perm, crop=crop)
    g = FrameGeom(grid, transforms, fx, fy, perm, flip, width, height, opt,
                  gi)
    params, zb = _march_frame_fields(grid, g, perm, flip, opt)
    return _march_finalize(grid, payload, params, zb, g.R, g.u0, g.du, g.v0,
                           g.dv, g.fx, g.fy, perm, flip, width, height, opt,
                           gi, out_dtype=out_dtype, crop=crop)


def render_frame(grid: DenseGrid, transform, fx, fy,
                 perm: Tuple[int, int, int], flip: bool,
                 width: int, height: int, opt: RenderOptions,
                 gi: int = 512, payload=None,
                 mesh_dist=None, mesh_rgb=None, out_dtype=None):
    """Render one pinhole frame; returns (H, W, 4) (float32, or uint8 with
    out_dtype=torch.uint8). transform: (3,4) C2W. perm/flip: from
    choose_axis. Mesh compositing (mesh_dist/mesh_rgb) comes with a later
    slice."""
    if mesh_dist is not None or mesh_rgb is not None:
        raise NotImplementedError(f"mesh overlays come with {_SLICE_B}")
    tr = torch.as_tensor(transform, dtype=_F32).reshape(1, 3, 4)
    return render_frames(grid, tr, fx, fy, perm, flip, width, height, opt,
                         gi=gi, payload=payload, out_dtype=out_dtype)[0]


def _warp_to_screen(inter, opt: RenderOptions, R, fx, fy,
                    width: int, height: int, gi: int, perm,
                    u0, du, v0, dv, scale, out_dtype=None,
                    planar: bool = False, precise: bool = False):
    """Projective bilinear warp of a batch of intermediate images
    ((P, gi, gi, 4), or planar (P, 4, gi, gi)) to (P, H, W, 4) screens plus
    background compositing: the superquad warp where it applies, else the
    reference quad-gather warp.

    precise: the training path's warp — the reference quad-gather warp with
    an f32 quad table, differentiable by autograd (the gather's backward
    is a scatter-add). The reference routes here too while its precise
    superquad warp is parked off (display_warp._PRECISE_SQ = False); that
    warp and its adjoint kernels come with ROADMAP item 17. (The NDC and
    mesh-background variants come with slice B.)"""
    if precise:
        if planar:
            inter = inter.movedim(1, -1)
        return display_warp.to_display_dtype(
            _warp_to_screen_ref(inter, opt, R, fx, fy, width, height, gi,
                                perm, u0, du, v0, dv, scale, precise=True),
            out_dtype)
    if display_warp.usable(width, height, gi):
        return display_warp.warp_to_screen_sq(
            inter, opt, R, fx, fy, width, height, gi, perm,
            u0, du, v0, dv, scale, out_dtype=out_dtype, planar=planar)
    if planar:
        inter = inter.movedim(1, -1)
    return display_warp.to_display_dtype(
        _warp_to_screen_ref(inter, opt, R, fx, fy, width, height, gi,
                            perm, u0, du, v0, dv, scale), out_dtype)


def _warp_to_screen_ref(inter, opt: RenderOptions, R, fx, fy,
                        width: int, height: int, gi: int, perm,
                        u0, du, v0, dv, scale, precise: bool = False):
    """Reference warp: per-pixel quad-row gather (the exact display
    semantics the superquad warp is held against), in plain PyTorch.

    inter: (P, gi, gi, 4); R (P, 3, 3); u0/du/v0/dv (P,). The quad table
    and the bilinear combine are float16, as on the reference's display
    path, or float32 with ``precise`` (the training path: f16 would
    quantize the outputs below a gradient step). Linear in ``inter`` and
    differentiable by autograd. Returns (P, H, W, 4) float32. Display-path
    calls (not ``precise``) count their poses in ``poses``: a display run
    shows with it that no pose fell back here."""
    if not precise:
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
    rgb = out[..., :3] + bg * (1.0 - out[..., 3:4])
    return torch.cat([rgb, out[..., 3:4]], -1)


#: poses warped through the reference fallback (a plain counter, so a run
#: can show that no pose fell back)
_warp_to_screen_ref.poses = 0


def render_image(grid: DenseGrid, cam, opt: RenderOptions,
                 gi: Optional[int] = None,
                 payload_cache: Optional[dict] = None,
                 meshes: Optional[Sequence] = None,
                 host_tree=None, out_dtype=None) -> np.ndarray:
    """Camera-object convenience wrapper; returns (H, W, 4) on the host.

    gi: intermediate resolution; None picks default_gi(grid).
    payload_cache: optional mutable dict keyed by (perm, crop): pre-permuted
    payloads are built lazily and reused across calls.
    Steep poses (slope >= MAX_SLAB_SLOPE: the split-frame renderer), NDC
    trees and mesh overlays (meshes, opt.show_grid) come with slice B and
    raise NotImplementedError here."""
    if gi is None:
        gi = default_gi(grid)
    if grid.ndc is not None:
        raise NotImplementedError(f"NDC trees come with {_SLICE_B}")
    if meshes or (opt.show_grid and host_tree is not None):
        raise NotImplementedError(f"mesh overlays come with {_SLICE_B}")
    perm, flip, slope = choose_axis(
        grid, cam.transform, cam.fx, cam.fy, cam.width, cam.height)
    if not (np.isfinite(slope) and slope < MAX_SLAB_SLOPE):
        raise NotImplementedError(
            "steep/wide/interior poses (split-frame slab passes) come with "
            f"{_SLICE_B}")
    payload = None
    if payload_cache is not None:
        key = (perm, inplane_crop(grid, perm, float(opt.sigma_thresh)))
        if key not in payload_cache:
            for k in [k for k in payload_cache if k[0] == perm]:
                del payload_cache[k]
            payload_cache[key] = prepare_payload(grid, perm, opt)
        payload = payload_cache[key]
    out = render_frame(grid, cam.transform, cam.fx, cam.fy, perm, flip,
                       cam.width, cam.height, opt, gi, payload=payload,
                       out_dtype=out_dtype)
    return out.cpu().numpy()
