"""Superquad display warp: the fast projective screen resample (the
counterpart of ``volrend_tpu/ops/display_warp.py``).

The display path's last step warps the (gi, gi, 4) intermediate slope-grid
image to the (H, W, 4) screen with a projective bilinear resample. The
superquad form groups screen pixels into (By, Bx) blocks; every block reads
the (Wy, Wx) intermediate cells around its footprint, 4 channels each, and
each subpixel tent-combines its bilinear taps inside that window. The
reference runs it as two TPU kernels with XLA geometry between them:

- **kernel B** (``csrc/warp_build.cu``, wrapper ``build_table``) quantizes
  the planar intermediate to affine int8 (q = round(v * 255) - 128) and
  writes the (H3 * W3, 4 * Wy * Wx) window-row table;
- **kernel C** (``csrc/warp_combine.cu``, wrapper ``combine_emit``) gathers
  each block's row, computes the tent weights from the subpixel's window
  position, dequantizes, masks, composites over the background and writes
  interleaved (H, W, 4) RGBA (uint8 or float32).

The port's display path fuses both with the geometry into **kernel W**
(``csrc/warp_display.cu``, wrapper ``warp_display``): per screen block it
computes the subpixel positions from a (P, 16) row of per-pose scalars
(``display_params``), the window corner, the window's int8 codes straight
from the planar intermediate, and kernel C's combine and emit, writing the
frames in place; nothing else is materialized. Its fit mode
(``level_fit_counts``) counts each pose's blocks that misfit a level's
window. ``render_frames`` queues those counts ahead of the march
(``plan_fits``: a ``FitPlan``), so the host reads them while kernel M runs.
A pose whose blocks misfit their window in bulk (wide-FOV / grazing
geometry) falls through the cascade of (block, window) levels and finally
to the reference quad-gather warp (``slab_render._warp_to_screen_ref``).

An NDC (LLFF) tree's pixel->slope map runs through
``render_exact.world2ndc``, and is a homography too: every ray of a pose
starts from the same origin, so the warped direction is proportional to
three linear forms of the camera direction, and the slope ratios cancel
the rest (``display_params_ndc``). Its poses take kernel W
and its fit mode on those rows, as world trees' do. Kernels B and C keep
their table modes for the precise warp below; ``_table_warp`` composes
them with the PyTorch geometry, the yardstick kernel W is held to.

Mesh overlays: kernel W's mesh-background mode composites each pixel over
a per-pose (P, H, W, 4) f16 background [r, g, b, hit] (``mesh_background``,
from the host rasterizer's buffers): the mesh colour replaces the flat
background where hit, and alpha is 1 there (the reference's combine
``has_mesh`` mode). Kernel C needs no such mode: the display paths that
reach it (NDC trees) refuse meshes, as the reference does, and the precise
training warp takes no background.

The training path's **precise** superquad warp (``_PreciseWarp``, behind
the ``_PRECISE_SQ`` switch, off by default as in the reference) runs
kernels B and C on an f32 table ((2, 2) blocks, 4 x 4 window; C at that
level with its sizes as constants) and differentiates them by hand: kernel
5 (``csrc/warp_combine_adj.cu``, wrapper ``combine_adjoint``) transposes
the tent-combine and adds each block's taps straight into the table
cotangent, and kernel 6 (``csrc/warp_build_adj.cu``, wrapper
``build_adjoint``) transposes the table build.

Every function takes a batch of poses: per-pose tensors carry a leading
pose dimension. On CUDA tensors the wrappers launch the kernels; on CPU
tensors they run the plain PyTorch versions (``warp_display_ref``,
``level_fit_counts_ref``, ``build_table_ref``, ``combine_emit_ref``,
``combine_adjoint_ref``, ``build_adjoint_ref``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from volrend_torch import kernels
from volrend_torch.ops.render_exact import world2ndc
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

_F32 = torch.float32

#: production cascade: ((By, Bx), (Wy, Wx)) levels, tried biggest block
#: first with per-pose misfit gates falling through to the next level and
#: finally the reference warp (the reference's _CASCADE)
_CASCADE: Tuple = (((2, 2), (4, 4)), ((4, 4), (5, 5)))

#: affine int8 window table: q = round(v*255) - 128, v = q/255 + 128/255
_QSCALE = 1.0 / 255.0
_QSHIFT = 128.0 / 255.0

#: the precise (training) warp's fixed level: (2, 2) blocks, 4 x 4 window
_PRECISE_B = (2, 2)
_PRECISE_WIN = (4, 4)

#: checks only: kernel C's f32 table and frame at the precise level run the
#: generic per-pixel kernel instead of the constant-size one, so the card
#: tests and chip_smoke.py can hold the two bit-equal. Read at call time.
_COMBINE_GENERIC = False

def _chan(cy: int, cx: int, c: int, win=(4, 4)) -> int:
    """Window-table channel of cell (cy, cx) in [0, Wy) x [0, Wx), colour
    c: row-major over the cells with the 4 colours minor. Every table of
    this module and of the kernels (``csrc/warp_table.cuh``) has this
    order."""
    return (cy * _win2d(win)[1] + cx) * 4 + c


def _block2d(block) -> Tuple[int, int]:
    """Normalize a block spec to (By, Bx): ints are square blocks."""
    if isinstance(block, tuple):
        return int(block[0]), int(block[1])
    return int(block), int(block)


def _win2d(win) -> Tuple[int, int]:
    """Normalize a window spec to (Wy, Wx)."""
    if isinstance(win, tuple):
        return int(win[0]), int(win[1])
    return int(win), int(win)


def usable(width: int, height: int, gi: int, block=2, win=(4, 4)) -> bool:
    """Static gate: the superquad path needs block-divisible screen dims, a
    window margin in the intermediate grid, and sub-cell-per-pixel motion.
    ``block`` is an int (square) or (By, Bx); ``win`` the (Wy, Wx) gather
    window."""
    by, bx = _block2d(block)
    wy, wx = _win2d(win)
    return (width % bx == 0 and height % by == 0 and gi >= 8
            and gi >= 2 * max(wy, wx)
            and gi <= min(width, height))


def _is_level(x) -> bool:
    """Is ``x`` one ((By,Bx),(Wy,Wx)) cascade level?"""
    return (isinstance(x, tuple) and len(x) == 2
            and all(isinstance(e, tuple) and len(e) == 2
                    and all(isinstance(i, int) for i in e) for e in x))


def _norm_cascade(block) -> Tuple:
    """Normalize a ``block`` argument to ((By,Bx),(Wy,Wx)) level tuples.
    None = the production _CASCADE; a bare int/(By,Bx) = that block with
    the classic 4x4 window (plus the (2,2)x(4,4) safety level); a single
    ((By,Bx),(Wy,Wx)) level gets the same safety level added."""
    if block is None:
        return _CASCADE
    if _is_level(block):
        levels = (((2, 2), (4, 4)), block)
    elif (isinstance(block, tuple) and block
          and all(_is_level(lv) for lv in block)):
        levels = block
    else:
        levels = (((2, 2), (4, 4)), (_block2d(block), (4, 4)))
    seen, out = set(), []
    for lv in levels:
        key = (_block2d(lv[0]), _win2d(lv[1]))
        if key not in seen:
            seen.add(key)
            out.append(key)
    return tuple(out)


def to_display_dtype(x: torch.Tensor, out_dtype) -> torch.Tensor:
    """Convert a float rgba frame to the requested display dtype (uint8 =
    the reference's RGBA8 write-out, rounded with a [0, 1] clamp and keeping
    the computed alpha; None = keep)."""
    if out_dtype is None or x.dtype == out_dtype:
        return x
    if out_dtype == torch.uint8:
        return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
    return x.to(out_dtype)


# ---------------------------------------------------------------------------
# geometry (per pose batch)
# ---------------------------------------------------------------------------

def _lin_forms(R, scale, perm, xs, ys):
    """The three permuted tree-dir components as linear forms of the pixel
    coordinates: d_tree[perm[k]] = scale_k * (xs*R[k,0] + ys*R[k,1] -
    R[k,2]). R (P, 3, 3); xs/ys broadcast against a (P, 1, ...) batch."""
    sc = torch.as_tensor(scale, dtype=_F32, device=R.device
                         ).expand(3).reshape(3)
    out = []
    for k in range(3):
        a = R[:, perm[k]] * sc[perm[k]]                          # (P, 3)
        shape = (-1,) + (1,) * (xs.dim())
        out.append(xs * a[:, 0].reshape(shape) + ys * a[:, 1].reshape(shape)
                   - a[:, 2].reshape(shape))
    return out


def _safe_inv(den):
    return 1.0 / torch.where(torch.abs(den) < 1e-12,
                             torch.full_like(den, 1e-12), den)


def _ndc_slopes(R, xs, ys, perm, u0, du, v0, dv, scale, ndc, origin):
    """Slope-grid coordinates of the camera rays (xs, ys, -1) of an NDC
    tree (xs, ys broadcast to the ray grid's shape): the world dirs warped
    by world2ndc from each pose's ``origin`` (P, 3), then the guarded
    slope division of slab_render._slopes_from_dirs. (P, ...) each."""
    from volrend_torch.ops.slab_render import _slopes_from_dirs
    xs, ys = torch.broadcast_tensors(xs, ys)
    d_cam = torch.stack([xs, ys, torch.full_like(xs, -1.0)], -1)
    d_world = torch.einsum("...c,pkc->p...k", d_cam, R)
    o = origin.reshape((-1,) + (1,) * xs.dim() + (3,))
    ndir, _ = world2ndc(ndc, d_world, o)
    us, vs = _slopes_from_dirs(ndir * scale, perm)
    shape = (-1,) + (1,) * xs.dim()
    return ((us - u0.reshape(shape)) / du.reshape(shape),
            (vs - v0.reshape(shape)) / dv.reshape(shape))


def _pixel_slopes(R, fx, fy, width: int, height: int, gi: int,
                  perm: Tuple[int, int, int], u0, du, v0, dv, scale,
                  ndc=None, origin=None):
    """Full-resolution (P, H, W) slope-grid coordinates of every screen
    pixel (the pixel->slope map of a world-space pinhole is a homography,
    so the three tree-dir components are linear forms of the pixel
    coordinates; an NDC tree's map runs through world2ndc from each pose's
    ``origin``)."""
    dev = R.device
    if ndc is not None:
        xs = (torch.arange(width, dtype=_F32, device=dev) - 0.5 * width) / fx
        ys = -(torch.arange(height, dtype=_F32, device=dev)
               - 0.5 * height) / fy
        return _ndc_slopes(R, xs[None, :], ys[:, None], perm, u0, du, v0, dv,
                           scale, ndc, origin)
    xs = ((torch.arange(width, dtype=_F32, device=dev) - 0.5 * width)
          / fx)[None, :]                                          # (1, W)
    ys = (-(torch.arange(height, dtype=_F32, device=dev) - 0.5 * height)
          / fy)[:, None]                                          # (H, 1)
    den, nu, nv = _lin_forms(R, scale, perm, xs, ys)
    inv = _safe_inv(den)
    gy = (nu * inv - u0[:, None, None]) / du[:, None, None]        # (P,H,W)
    gx = (nv * inv - v0[:, None, None]) / dv[:, None, None]
    return gy, gx


def _block_extents(gyf, gxf, gi: int, B):
    """Per-block masked tap extents (P, Hh, Wh) over each block's IN-GRID
    subpixels (an off-grid subpixel at the image border must not drag the
    shared window away from its in-grid block-mates)."""
    By, Bx = _block2d(B)
    P, H, W = gyf.shape
    Hh, Wh = H // By, W // Bx
    gyb = gyf.reshape(P, Hh, By, Wh, Bx)
    gxb = gxf.reshape(P, Hh, By, Wh, Bx)
    ok = ((gyb >= 0) & (gyb <= gi - 1) & (gxb >= 0) & (gxb <= gi - 1))
    gybc = torch.clamp(gyb, 0.0, gi - 1 - 1e-6)
    gxbc = torch.clamp(gxb, 0.0, gi - 1 - 1e-6)
    big = 1e9
    any_in = torch.any(torch.any(ok, 4), 2)
    red = (2, 4)

    def ext(v, fill, fn):
        return torch.where(any_in, fn(torch.where(ok, v, fill), red), 0.0)

    ymin = ext(gybc, big, torch.amin)
    ymax = ext(gybc, -big, torch.amax)
    xmin = ext(gxbc, big, torch.amin)
    xmax = ext(gxbc, -big, torch.amax)
    return ymin, ymax, xmin, xmax, any_in


def _level_misfits(gyf, gxf, gi: int, B, win=(4, 4)):
    """(P, Hh, Wh) bool: the blocks whose in-grid tap extents overflow the
    level's window (a block with no in-grid subpixel fits)."""
    Wy, Wx = _win2d(win)
    ymin, ymax, xmin, xmax, _ = _block_extents(gyf, gxf, gi, B)
    return ((ymax >= torch.floor(ymin) + (Wy - 1.0))
            | (xmax >= torch.floor(xmin) + (Wx - 1.0)))


def _level_fits(gyf, gxf, gi: int, B, win=(4, 4)):
    """Per-pose bulk-misfit predicate (P,) bool for one (block, window)
    level: fewer than 0.1% of the blocks misfit their window (decided by
    _fits_from_counts, as the display warp's fit plan decides)."""
    misfit = _level_misfits(gyf, gxf, gi, B, win)
    return _fits_from_counts(misfit.sum((1, 2))[None], ((B, win),),
                             gyf.shape[1], gyf.shape[2])[0]


def _sub_slopes(R, fx, fy, width: int, height: int, gi: int,
                perm: Tuple[int, int, int], u0, du, v0, dv, scale,
                ndc=None, origin=None, B=2):
    """Per-subpixel slope-grid coordinates in (P, By*Bx, Hh, Wh) layout
    (an NDC tree's through world2ndc from each pose's ``origin``)."""
    By, Bx = _block2d(B)
    Hh, Wh = height // By, width // Bx
    dev = R.device
    # subpixel s = p*Bx + q, made on the device (a copy from host memory
    # would wait for the work queued before it)
    s = torch.arange(By * Bx, device=dev)
    po = torch.div(s, Bx, rounding_mode="floor").to(_F32)
    qo = torch.remainder(s, Bx).to(_F32)
    if ndc is not None:
        xs = (torch.arange(Wh, dtype=_F32, device=dev)[None, :] * Bx
              + qo[:, None] - 0.5 * width) / fx                  # (S, Wh)
        ys = -(torch.arange(Hh, dtype=_F32, device=dev)[None, :] * By
               + po[:, None] - 0.5 * height) / fy                # (S, Hh)
        return _ndc_slopes(R, xs[:, None, :], ys[:, :, None], perm, u0, du,
                           v0, dv, scale, ndc, origin)
    xs = ((torch.arange(Wh, dtype=_F32, device=dev)[None, :] * Bx
           + qo[:, None] - 0.5 * width) / fx)[:, None, :]     # (S, 1, Wh)
    ys = (-(torch.arange(Hh, dtype=_F32, device=dev)[None, :] * By
            + po[:, None] - 0.5 * height) / fy)[:, :, None]   # (S, Hh, 1)
    den, nu, nv = _lin_forms(R, scale, perm, xs, ys)
    inv = _safe_inv(den)
    gy = (nu * inv - u0[:, None, None, None]) / du[:, None, None, None]
    gx = (nv * inv - v0[:, None, None, None]) / dv[:, None, None, None]
    return gy, gx


def _level_geometry(geom_args, gi: int, B, win=(4, 4)):
    """Per-subpixel positions/masks + shared window corners for one
    (block, window) level (geom_args = the _sub_slopes arguments).

    Returns (gys, gxs, okm, Y0, X0): (P, By*Bx, Hh, Wh) clipped subpixel
    positions / ok masks and (P, Hh, Wh) int32 window corners."""
    return _window_corners(*_sub_slopes(*geom_args, B=B), gi, win)


def _window_corners(gy, gx, gi: int, win):
    """(P, By*Bx, Hh, Wh) subpixel positions -> (gys, gxs, okm, Y0, X0):
    the positions clipped to the grid, the ok masks and each block's
    window corner, from its in-grid subpixels only."""
    Wy, Wx = _win2d(win)
    ok = (gy >= 0) & (gy <= gi - 1) & (gx >= 0) & (gx <= gi - 1)
    gys = torch.clamp(gy, 0.0, gi - 1 - 1e-6)
    gxs = torch.clamp(gx, 0.0, gi - 1 - 1e-6)
    okm = ok.to(_F32)
    # window corner from the OK subpixels only
    big = 1e9
    any_in = torch.any(ok, 1)
    ymin = torch.where(any_in, torch.amin(torch.where(ok, gys, big), 1), 0.0)
    xmin = torch.where(any_in, torch.amin(torch.where(ok, gxs, big), 1), 0.0)
    Y0 = torch.clamp(torch.floor(ymin).to(torch.int32), 0, gi - Wy)
    X0 = torch.clamp(torch.floor(xmin).to(torch.int32), 0, gi - Wx)
    return gys, gxs, okm, Y0, X0


def _sub_geometry(R, fx, fy, width: int, height: int, gi: int,
                  perm: Tuple[int, int, int], u0, du, v0, dv, scale,
                  ndc=None, origin=None, B=2, win=(4, 4)):
    """Per-subpixel geometry, window corners and the bulk-misfit predicate
    of one (block, window) level in one call (a one-shot wrapper over
    _level_geometry, _pixel_slopes and _level_fits).

    Returns (gys, gxs, okm, Y0, X0, fits): (P, By*Bx, Hh, Wh) clipped
    subpixel positions / ok masks, (P, Hh, Wh) int32 window corners and
    the (P,) bool fit predicates. ``ndc``/``origin``: an NDC tree's
    sidecar and the poses' (P, 3) origins."""
    geom_args = (R, fx, fy, width, height, gi, perm, u0, du, v0, dv, scale,
                 ndc, origin)
    gys, gxs, okm, Y0, X0 = _level_geometry(geom_args, gi, B, win)
    fits = _level_fits(*_pixel_slopes(*geom_args), gi, B, win)
    return gys, gxs, okm, Y0, X0, fits


# ---------------------------------------------------------------------------
# kernel B: the window-table build
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {dev}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _table_dtype(name: str, dtype) -> None:
    if dtype not in (torch.int8, _F32):
        raise ValueError(f"{name}: the table is int8 or float32, not "
                         f"{dtype}")


def build_table(inter: torch.Tensor, win: Tuple[int, int] = (4, 4),
                dtype=torch.int8, planar: bool = True) -> torch.Tensor:
    """f32 intermediate -> (P, H3*W3, 4*Wy*Wx) window-row table, row
    Y*W3 + X, channel _chan(cy, cx, c) = v(inter[c, Y+cy, X+cx]).

    dtype: torch.int8, the display path's affine int8 (v = q, the
    quantized value), or torch.float32, the precise warp's plain copy.
    planar: ``inter`` is (P, 4, gi, gi); else (P, gi, gi, 4). Launches
    kernel B on CUDA tensors (counted in ``launches``, or in
    ``launches_f32`` for an f32 table); runs ``build_table_ref`` on CPU
    tensors."""
    Wy, Wx = _win2d(win)
    _table_dtype("build_table", dtype)
    P = inter.shape[0]
    gi = inter.shape[-1] if planar else inter.shape[1]
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    dev = inter.device
    if dev.type == "cpu":
        return build_table_ref(inter, (Wy, Wx), dtype, planar)
    if dev.type != "cuda":
        raise RuntimeError(f"build_table: no kernel for device {dev}")
    _check("build_table: inter", inter, _F32,
           (P, 4, gi, gi) if planar else (P, gi, gi, 4), dev)
    f32 = dtype == _F32
    table = torch.empty((P, H3 * W3, 4 * Wy * Wx), dtype=dtype, device=dev)
    lib = kernels.lib("warp_build")
    kernels.check(lib.vt_warp_build(
        inter.data_ptr(), table.data_ptr(), P, gi, Wy, Wx, int(f32),
        int(planar), torch.cuda.current_stream(dev).cuda_stream),
        "warp_build")
    if f32:
        build_table.launches_f32 += 1
    else:
        build_table.launches += 1
    return table


build_table.launches = 0
build_table.launches_f32 = 0


def _quantize_affine(v: torch.Tensor) -> torch.Tensor:
    """Affine int8: q = round_half_even(clip(v, 0, 1) * 255) - 128."""
    return (torch.round(torch.clamp(v, 0.0, 1.0) * 255.0) - 128.0
            ).to(torch.int8)


def build_table_ref(inter: torch.Tensor, win: Tuple[int, int] = (4, 4),
                    dtype=torch.int8, planar: bool = True) -> torch.Tensor:
    """Plain PyTorch version of kernel B (same layout, bit-equal)."""
    Wy, Wx = _win2d(win)
    _table_dtype("build_table_ref", dtype)
    itp = inter if planar else inter.movedim(-1, 1)
    P, _, gi, _ = itp.shape
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    q = _quantize_affine(itp) if dtype == torch.int8 else itp.to(_F32)
    cells = [q[:, :, cy:cy + H3, cx:cx + W3]
             for cy in range(Wy) for cx in range(Wx)]
    tbl = torch.stack(cells, 1)                        # (P, WyWx, 4, H3, W3)
    return tbl.permute(0, 3, 4, 1, 2).reshape(P, H3 * W3, 4 * Wy * Wx)


# ---------------------------------------------------------------------------
# kernel C: tent-combine + interleaved screen emit
# ---------------------------------------------------------------------------

def combine_emit(table: torch.Tensor, Y0: torch.Tensor, X0: torch.Tensor,
                 ry: torch.Tensor, rx: torch.Tensor, okm: torch.Tensor,
                 gi: int, height: int, width: int, B, win, bg: float,
                 out_dtype=None, qscale: float = _QSCALE,
                 qshift: float = _QSHIFT) -> torch.Tensor:
    """Per (By, Bx) screen block: gather the block's window row of the
    table at Y0*W3 + X0, tent-combine each subpixel's taps at its window
    position (ry, rx) (clamped to the window), dequantize (x qscale +
    qshift: the affine int8 by default; the precise warp's f32 table takes
    qscale 1, qshift 0), mask with okm and composite over the background
    ``bg``.

    table (P, H3*W3, 4*Wy*Wx) int8 or f32 with H3, W3 = gi - Wy + 1,
    gi - Wx + 1 (see build_table); Y0/X0 (P, Hh, Wh) int32; ry/rx/okm
    (P, By*Bx, Hh, Wh) f32. Returns (P, H, W, 4) uint8 (out_dtype =
    torch.uint8, rounded half to even after a [0, 1] clamp) or f32.
    Launches kernel C on CUDA tensors (counted in ``launches`` and
    ``poses``, or in ``launches_f32`` for an f32 table): an f32 table and
    frame at the precise level run its constant-size kernel, every other
    level and mode the generic per-pixel one (``_COMBINE_GENERIC``
    selects it at the precise level too). Runs ``combine_emit_ref`` on
    CPU."""
    By, Bx = _block2d(B)
    Wy, Wx = _win2d(win)
    P = table.shape[0]
    Hh, Wh = height // By, width // Bx
    dev = table.device
    if dev.type == "cpu":
        return combine_emit_ref(table, Y0, X0, ry, rx, okm, gi, height,
                                width, (By, Bx), (Wy, Wx), bg, out_dtype,
                                qscale, qshift)
    if dev.type != "cuda":
        raise RuntimeError(f"combine_emit: no kernel for device {dev}")
    if out_dtype not in (None, torch.float32, torch.uint8):
        raise ValueError(f"combine_emit: out_dtype {out_dtype} not taken")
    _table_dtype("combine_emit", table.dtype)
    f32 = table.dtype == _F32
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    _check("combine_emit: table", table, table.dtype,
           (P, H3 * W3, 4 * Wy * Wx), dev)
    for name, t, dt in (("Y0", Y0, torch.int32), ("X0", X0, torch.int32)):
        _check(f"combine_emit: {name}", t, dt, (P, Hh, Wh), dev)
    for name, t in (("ry", ry), ("rx", rx), ("okm", okm)):
        _check(f"combine_emit: {name}", t, _F32, (P, By * Bx, Hh, Wh), dev)
    u8 = out_dtype == torch.uint8
    out = torch.empty((P, height, width, 4),
                      dtype=torch.uint8 if u8 else _F32, device=dev)
    lib = kernels.lib("warp_combine")
    kernels.check(lib.vt_warp_combine(
        table.data_ptr(), Y0.data_ptr(), X0.data_ptr(), ry.data_ptr(),
        rx.data_ptr(), okm.data_ptr(), out.data_ptr(), int(u8), int(f32),
        int(_COMBINE_GENERIC), P, height, width, By, Bx, Wy, Wx, H3, W3, float(bg),
        float(qscale), float(qshift),
        torch.cuda.current_stream(dev).cuda_stream),
        "warp_combine")
    if f32:
        combine_emit.launches_f32 += 1
    else:
        combine_emit.launches += 1
        combine_emit.poses += P
    return out


combine_emit.launches = 0
combine_emit.poses = 0
combine_emit.launches_f32 = 0


def combine_emit_ref(table, Y0, X0, ry, rx, okm, gi: int, height: int,
                     width: int, B, win, bg: float, out_dtype=None,
                     qscale: float = _QSCALE, qshift: float = _QSHIFT,
                     mesh=None):
    """Plain PyTorch version of kernel C (f32 arithmetic). ``mesh``: an
    optional (P, H, W, 4) [r, g, b, hit] background (mesh_background): the
    reference combine's has_mesh mode, what kernel W's mesh mode
    computes."""
    By, Bx = _block2d(B)
    Wy, Wx = _win2d(win)
    P, _, C = table.shape
    W3 = gi - Wx + 1
    Hh, Wh = height // By, width // Bx
    flat = (Y0.long() * W3 + X0.long()).reshape(P, Hh * Wh)
    qg = torch.gather(table, 1, flat[..., None].expand(-1, -1, C))
    qg = qg.reshape(P, Hh, Wh, Wy, Wx, 4).to(_F32)
    ryc = torch.clamp(ry, 0.0, Wy - 1.0)                    # (P, S, Hh, Wh)
    rxc = torch.clamp(rx, 0.0, Wx - 1.0)
    cyv = torch.arange(Wy, dtype=_F32, device=table.device)
    cxv = torch.arange(Wx, dtype=_F32, device=table.device)
    wy = torch.clamp(1.0 - torch.abs(ryc[..., None] - cyv), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(rxc[..., None] - cxv), min=0.0)
    # (P, S, Hh, Wh, 4) = sum over the window cells
    rgba = torch.einsum("pshwy,pshwx,phwyxc->pshwc", wy, wx, qg)
    rgba = rgba * qscale + qshift
    alpha = rgba[..., 3:4]
    ok = (okm > 0.5)[..., None]
    if mesh is None:
        rgb = torch.where(ok, rgba[..., :3] + bg * (1.0 - alpha),
                          torch.full_like(rgba[..., :3], bg))
        a = torch.where(ok, alpha, torch.zeros_like(alpha))
    else:
        # the background in the subpixel layout (P, S, Hh, Wh, 4)
        m = mesh.to(_F32).reshape(P, Hh, By, Wh, Bx, 4).permute(
            0, 2, 4, 1, 3, 5).reshape(P, By * Bx, Hh, Wh, 4)
        hit = m[..., 3:4] > 0.5
        bgc = torch.where(hit, m[..., :3], bg)
        rgb = torch.where(ok, rgba[..., :3] + bgc * (1.0 - alpha), bgc)
        a = torch.where(hit, 1.0, torch.where(ok, alpha, 0.0))
    out = torch.cat([rgb, a], -1)                           # (P, S, Hh, Wh, 4)
    out = out.reshape(P, By, Bx, Hh, Wh, 4).permute(0, 3, 1, 4, 2, 5)
    out = out.reshape(P, height, width, 4)
    if out_dtype == torch.uint8:
        return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0
                           ).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# kernel W: the display path's fused warp and its fit mode
# ---------------------------------------------------------------------------

def display_params(R, fx, fy, u0, du, v0, dv, scale,
                   perm: Tuple[int, int, int]) -> torch.Tensor:
    """(P, 16) f32 per-pose scalars of kernel W and its fit mode, packed
    on the device by tensor ops (nothing is read on the host): columns
    0-8 the rows R[:, perm[k]] * scale[perm[k]] of _lin_forms for k = 0,
    1, 2 (the den, nu and nv forms), then fx, fy, u0, du, v0, dv and a
    zero."""
    sc = torch.as_tensor(scale, dtype=_F32, device=R.device
                         ).expand(3).reshape(3)
    return _pack_params([R[:, perm[k]] * sc[perm[k]] for k in range(3)],
                        fx, fy, u0, du, v0, dv)


def _pack_params(forms, fx, fy, u0, du, v0, dv) -> torch.Tensor:
    """The (P, 16) f32 rows from the three (P, 3) forms (den, nu, nv) and
    the pose's fx, fy, u0, du, v0, dv."""
    P, dev = forms[0].shape[0], forms[0].device
    cols = [f.to(_F32) for f in forms]
    cols += [torch.as_tensor(f, dtype=_F32, device=dev).reshape(-1)
             .expand(P)[:, None] for f in (fx, fy)]
    cols += [t.reshape(P, 1) for t in (u0, du, v0, dv)]
    cols.append(torch.zeros((P, 1), dtype=_F32, device=dev))
    return torch.cat(cols, 1).contiguous()


def display_params_ndc(R, fx, fy, u0, du, v0, dv, scale,
                       perm: Tuple[int, int, int], ndc,
                       origin) -> torch.Tensor:
    """display_params for an NDC tree: the (P, 16) rows whose forms give
    world2ndc's slope map from each pose's (P, 3) ``origin`` o.

    A camera ray's world direction has the components l_k = x * R[k, 0] +
    y * R[k, 1] - R[k, 2]. world2ndc moves its origin to the near plane
    (cen_z = -1), so its NDC direction is proportional to (sx * (o_x * l_z
    - o_z * l_x), sy * (o_y * l_z - o_z * l_y), 2 * l_z) / l_z, with sx =
    -2 f / W and sy = -2 f / H of the sidecar ``ndc`` (W, H, f). The slope
    division of _slopes_from_dirs cancels l_z and the normalization, so
    these three linear forms, scaled per tree axis and taken in ``perm``'s
    order, are the den, nu and nv forms. They are computed in float64 and
    rounded once to float32, on the device."""
    width, height, focal = (np.float32(v) for v in ndc)
    sx = float(-(np.float32(2.0) * focal) / width)
    sy = float(-(np.float32(2.0) * focal) / height)
    dev = R.device
    r = R.to(torch.float64)
    o = torch.as_tensor(origin, device=dev).to(torch.float64)
    ndir = (sx * (o[:, 0, None] * r[:, 2] - o[:, 2, None] * r[:, 0]),
            sy * (o[:, 1, None] * r[:, 2] - o[:, 2, None] * r[:, 1]),
            2.0 * r[:, 2])                                   # 3 x (P, 3)
    sc = torch.as_tensor(scale, device=dev).to(torch.float64
                                               ).expand(3).reshape(3)
    return _pack_params([ndir[perm[k]] * sc[perm[k]] for k in range(3)],
                        fx, fy, u0, du, v0, dv)


def _display_positions(prm: torch.Tensor, B, height: int, width: int):
    """_sub_slopes from the packed parameter rows: the (P, By*Bx, Hh, Wh)
    slope-grid positions of every subpixel, with _sub_slopes's operations
    in its order (bit-equal to it)."""
    By, Bx = _block2d(B)
    Hh, Wh = height // By, width // Bx
    dev = prm.device
    s = torch.arange(By * Bx, device=dev)
    po = torch.div(s, Bx, rounding_mode="floor").to(_F32)
    qo = torch.remainder(s, Bx).to(_F32)
    c = prm[:, :, None, None, None]                          # (P, 16, 1,1,1)
    xs = (torch.arange(Wh, dtype=_F32, device=dev)[None, :] * Bx
          + qo[:, None] - 0.5 * width)[None, :, None, :] / c[:, 9]
    ys = -(torch.arange(Hh, dtype=_F32, device=dev)[None, :] * By
           + po[:, None] - 0.5 * height)[None, :, :, None] / c[:, 10]
    den, nu, nv = (xs * c[:, k] + ys * c[:, k + 1] - c[:, k + 2]
                   for k in (0, 3, 6))
    inv = _safe_inv(den)
    return (nu * inv - c[:, 11]) / c[:, 12], (nv * inv - c[:, 13]) / c[:, 14]


def _usable_levels(width: int, height: int, gi: int, block=None):
    """The cascade's levels this screen and grid can take, biggest block
    first."""
    levels = [(B, W) for (B, W) in _norm_cascade(block)
              if usable(width, height, gi, block=B, win=W)]
    levels.sort(key=lambda bw: -bw[0][0] * bw[0][1])
    return levels


def level_fit_counts(prm: torch.Tensor, levels, gi: int, height: int,
                     width: int) -> torch.Tensor:
    """(L, P) int32: for each ((By, Bx), (Wy, Wx)) level and pose (rows of
    ``prm``, see display_params), the count of screen blocks whose in-grid
    tap extents overflow the window (_level_misfits). Launches kernel W's
    fit mode once for all levels (up to 4) on CUDA tensors (counted in
    ``launches``); runs ``level_fit_counts_ref`` on CPU tensors."""
    dev = prm.device
    if dev.type == "cpu":
        return level_fit_counts_ref(prm, levels, gi, height, width)
    if dev.type != "cuda":
        raise RuntimeError(f"level_fit_counts: no kernel for device {dev}")
    P = prm.shape[0]
    _check("level_fit_counts: prm", prm, _F32, (P, 16), dev)
    counts = torch.zeros((len(levels), P), dtype=torch.int32, device=dev)
    if not levels:
        return counts
    if len(levels) > 4:
        raise ValueError(f"level_fit_counts: {len(levels)} levels, the "
                         "kernel takes up to 4")
    dims = [d for B, win in levels for d in _block2d(B) + _win2d(win)]
    kernels.check(kernels.lib("warp_display").vt_warp_fit(
        prm.data_ptr(), counts.data_ptr(), P, len(levels),
        (ctypes.c_int * len(dims))(*dims), gi, height, width,
        torch.cuda.current_stream(dev).cuda_stream), "warp_display")
    level_fit_counts.launches += 1
    return counts


level_fit_counts.launches = 0


def _block_to_pixels(t: torch.Tensor, B) -> torch.Tensor:
    """(P, By*Bx, Hh, Wh) per-subpixel layout -> (P, H, W) screen layout."""
    By, Bx = _block2d(B)
    P, _, Hh, Wh = t.shape
    return t.reshape(P, By, Bx, Hh, Wh).permute(0, 3, 1, 4, 2).reshape(
        P, Hh * By, Wh * Bx)


def level_fit_counts_ref(prm: torch.Tensor, levels, gi: int, height: int,
                         width: int) -> torch.Tensor:
    """Plain PyTorch version of kernel W's fit mode (exact)."""
    out = []
    for B, win in levels:
        gyf, gxf = (_block_to_pixels(t, B)
                    for t in _display_positions(prm, B, height, width))
        out.append(_level_misfits(gyf, gxf, gi, B, win).sum((1, 2)))
    if not out:
        return torch.zeros((0, prm.shape[0]), dtype=torch.int32,
                           device=prm.device)
    return torch.stack(out).to(torch.int32)


def _fits_from_counts(counts, levels, height: int,
                      width: int) -> torch.Tensor:
    """(L, P) bool fit decisions from the (L, P) misfit counts of
    ``levels``: the mean count / (Hh*Wh) < 1e-3 in float32, taken as the
    count times the float32 reciprocal of Hh*Wh, as torch.mean computes it
    on the card and the reference's jnp.mean on the CPU (torch.mean on the
    CPU divides instead; the two differ where the mean is exactly 1e-3).
    The one fit rule of the port's warps."""
    counts = torch.as_tensor(counts)
    inv = torch.tensor(
        [np.float32(1.0) / np.float32((height // _block2d(B)[0])
                                      * (width // _block2d(B)[1]))
         for B, _ in levels], dtype=_F32, device=counts.device)
    return (counts.to(_F32) * inv[:, None]
            < torch.tensor(1e-3, dtype=_F32, device=counts.device))


class FitPlan:
    """A pose batch's fit decisions, computed on the device ahead of the
    warp (display_warp.plan_fits): the parameter rows kernel W reads
    (``prm``), the usable cascade levels biggest block first
    (``levels``), and each level's (L, P) misfit counts on their way to
    the host: a non-blocking copy into pinned memory behind an event, so
    the host waits for the counts only in ``choice``, once whatever the
    caller queued after the plan (kernel M) is already on the card."""

    def __init__(self, prm: torch.Tensor, levels, counts: torch.Tensor,
                 height: int, width: int):
        self.prm, self.levels = prm, levels
        self.height, self.width = height, width
        self._event = None
        if counts.is_cuda:
            host = torch.empty(counts.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(counts, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            counts = host
        self._counts = counts

    def counts(self) -> np.ndarray:
        """(L, P) int32 misfit counts on the host (waits for them)."""
        if self._event is not None:
            self._event.synchronize()
        return self._counts.numpy()

    def choice(self) -> np.ndarray:
        """(P,) the level each pose takes (an index into ``levels``: the
        first that fits), -1 for the reference warp."""
        fits = _fits_from_counts(self.counts(), self.levels, self.height,
                                 self.width).numpy()
        hit = fits.any(0)
        return np.where(hit, fits.argmax(0), -1)


def plan_fits(R, fx, fy, width: int, height: int, gi: int,
              perm: Tuple[int, int, int], u0, du, v0, dv, scale,
              block=None, ndc=None, origin=None) -> FitPlan:
    """Queue the fit decisions of a pose batch (the _sub_slopes geometry
    arguments) for warp_to_screen_sq's ``plan``: the parameter rows
    (display_params, or display_params_ndc for an NDC tree: ``ndc``, the
    poses' (P, 3) ``origin``) and one fit-mode launch over the usable
    levels. Nothing waits for the device."""
    levels = _usable_levels(width, height, gi, block)
    if ndc is None:
        prm = display_params(R, fx, fy, u0, du, v0, dv, scale, perm)
    else:
        prm = display_params_ndc(R, fx, fy, u0, du, v0, dv, scale, perm,
                                 ndc, origin)
    counts = level_fit_counts(prm, levels, gi, height, width)
    return FitPlan(prm, levels, counts, height, width)


def mesh_background(mesh_dist, mesh_rgb, P: int, height: int, width: int,
                    device) -> torch.Tensor:
    """The (P, H, W, 4) float16 mesh background [r, g, b, hit] that kernel
    W's mesh mode and the reference warp composite over, from a mesh
    pass's buffers (ops/rasterize.py): ``mesh_dist`` (H, W) or (P, H, W),
    inf where no mesh (hit = finite), ``mesh_rgb`` (H, W, 3) or
    (P, H, W, 3). f16: 8 bytes a pixel, what the reference uploads, and
    display-range colours lose nothing visible."""
    md = to_device(mesh_dist, _F32, device).reshape(-1, height, width)
    mr = to_device(mesh_rgb, _F32, device).reshape(-1, height, width, 3)
    bg = torch.cat([mr, torch.isfinite(md).to(_F32)[..., None]], -1)
    return bg.to(torch.float16).expand(P, -1, -1, -1).contiguous()


def _check_display(inter, prm, sel, out, B, win, gi: int, mesh=None):
    """Kernel W's inputs on a CUDA device: contiguous (P, 4, gi, gi) f32
    planes, (P, 16) f32 rows, (n,) int32 pose list, (P, H, W, 4) uint8 or
    f32 frames on a 16-byte boundary, an optional contiguous (P, H, W, 4)
    f16 mesh background on an 8-byte boundary, and a level the kernel
    takes: blocks of any side that tile the screen, windows up to 8 x 8
    (as kernel C)."""
    dev = inter.device
    P = inter.shape[0]
    _check("warp_display: inter", inter, _F32, (P, 4, gi, gi), dev)
    _check("warp_display: prm", prm, _F32, (P, 16), dev)
    _check("warp_display: sel", sel, torch.int32, (sel.shape[0],), dev)
    if out.dtype not in (torch.uint8, _F32):
        raise ValueError(f"warp_display: frames are uint8 or float32, not "
                         f"{out.dtype}")
    _check("warp_display: out", out, out.dtype, (P,) + tuple(out.shape[1:3])
           + (4,), dev)
    if mesh is not None:
        _check("warp_display: mesh", mesh, torch.float16, tuple(out.shape),
               dev)
        if mesh.data_ptr() % 8:
            raise ValueError("warp_display: the mesh background must lie "
                             "on an 8-byte boundary")
    By, Bx = _block2d(B)
    Wy, Wx = _win2d(win)
    H, W = out.shape[1], out.shape[2]
    if (By < 1 or Bx < 1 or H % By or W % Bx or not 1 <= Wy <= 8
            or not 1 <= Wx <= 8 or gi < max(Wy, Wx)
            or out.data_ptr() % 16 or not 1 <= sel.shape[0] <= 65535):
        raise ValueError(f"warp_display: level {(By, Bx)} x {(Wy, Wx)} on "
                         f"{H}x{W} frames, gi={gi}, {sel.shape[0]} poses "
                         "not taken")


def warp_display(inter: torch.Tensor, prm: torch.Tensor, sel: torch.Tensor,
                 out: torch.Tensor, B, win, gi: int, bg: float,
                 mesh: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp the poses ``sel`` (int32 indices into the batch) of the planar
    intermediate images ``inter`` (P, 4, gi, gi) f32 to their screens at
    one cascade level ((By, Bx) blocks, (Wy, Wx) window), writing them in
    place into ``out`` (P, H, W, 4) uint8 or f32: what _level_geometry,
    kernel B's int8 table and kernel C compute together. ``prm``: the
    (P, 16) rows of display_params. ``mesh``: an optional (P, H, W, 4) f16
    mesh background (mesh_background), which selects the kernel's mesh
    mode. Launches kernel W on CUDA tensors (counted in ``launches`` and
    ``poses``, the mesh mode in ``mesh_launches`` and ``mesh_poses``);
    runs ``warp_display_ref`` on CPU tensors. Returns ``out``."""
    dev = inter.device
    if dev.type == "cpu":
        return warp_display_ref(inter, prm, sel, out, B, win, gi, bg, mesh)
    if dev.type != "cuda":
        raise RuntimeError(f"warp_display: no kernel for device {dev}")
    _check_display(inter, prm, sel, out, B, win, gi, mesh)
    (By, Bx), (Wy, Wx) = _block2d(B), _win2d(win)
    lib = kernels.lib("warp_display")
    args = (inter.data_ptr(), prm.data_ptr(), sel.data_ptr(), out.data_ptr(),
            sel.shape[0], int(out.dtype == torch.uint8), inter.shape[0], gi,
            out.shape[1], out.shape[2], By, Bx, Wy, Wx, float(bg),
            float(_QSCALE), float(_QSHIFT))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mesh is None:
        kernels.check(lib.vt_warp_display(*args, stream), "warp_display")
        warp_display.launches += 1
        warp_display.poses += sel.shape[0]
    else:
        kernels.check(lib.vt_warp_display_mesh(*args, mesh.data_ptr(),
                                               stream), "warp_display")
        warp_display.mesh_launches += 1
        warp_display.mesh_poses += sel.shape[0]
    return out


warp_display.launches = 0
warp_display.poses = 0
warp_display.mesh_launches = 0
warp_display.mesh_poses = 0


def warp_display_ref(inter, prm, sel, out, B, win, gi: int, bg: float,
                     mesh=None):
    """Plain PyTorch version of kernel W: the positions from the parameter
    rows, the window corners, kernel B's and C's plain versions (with the
    mesh background of the poses ``sel``, when given), and the frames of
    ``sel`` written into ``out``."""
    sel = sel.long()
    H, W = out.shape[1], out.shape[2]
    gy, gx = _display_positions(prm.index_select(0, sel), B, H, W)
    gys, gxs, okm, Y0, X0 = _window_corners(gy, gx, gi, win)
    out[sel] = combine_emit_ref(
        build_table_ref(inter.index_select(0, sel), win), Y0, X0,
        gys - Y0.to(_F32)[:, None], gxs - X0.to(_F32)[:, None], okm, gi, H,
        W, B, win, bg, out_dtype=out.dtype if out.dtype == torch.uint8
        else None, mesh=None if mesh is None else mesh.index_select(0, sel))
    return out


# ---------------------------------------------------------------------------
# the warp with its per-pose cascade
# ---------------------------------------------------------------------------

def _select_geom(geom_args, sel: torch.Tensor):
    """The _sub_slopes geometry arguments (12, or 14 with ndc and origin)
    of the poses ``sel`` (int64 indices)."""
    R, fx, fy, w, h, gi, perm, u0, du, v0, dv, scale = geom_args[:12]
    sub = (R.index_select(0, sel), fx, fy, w, h, gi, perm,
           u0.index_select(0, sel), du.index_select(0, sel),
           v0.index_select(0, sel), dv.index_select(0, sel), scale)
    if len(geom_args) > 12 and geom_args[12] is not None:
        sub += (geom_args[12], geom_args[13].index_select(0, sel))
    return sub


def _table_warp(geom_args, planes: torch.Tensor, B, win, bg: float,
                out_dtype):
    """The display warp at one cascade level by kernel B's int8 table and
    kernel C's combine (on CPU tensors their plain versions): the PyTorch
    geometry of _level_geometry (``geom_args``: the _sub_slopes arguments
    of the batch, an NDC tree's included), then the table of the
    (P, 4, gi, gi) ``planes`` and the combine. Returns (P, H, W, 4)
    frames, uint8 with ``out_dtype=torch.uint8``, else f32. The
    composition kernel W is held to, world and NDC trees alike; no display
    path runs it."""
    gi, h, w = geom_args[5], geom_args[4], geom_args[3]
    gys, gxs, okm, Y0, X0 = _level_geometry(geom_args, gi, B, win)
    tbl = build_table(planes.contiguous(), win)
    return combine_emit(
        tbl, Y0.contiguous(), X0.contiguous(),
        (gys - Y0.to(_F32)[:, None]).contiguous(),
        (gxs - X0.to(_F32)[:, None]).contiguous(), okm.contiguous(), gi, h,
        w, B, win, bg, out_dtype=out_dtype)


def warp_to_screen_sq(inter, opt: RenderOptions, R, fx, fy,
                      width: int, height: int, gi: int,
                      perm: Tuple[int, int, int],
                      u0, du, v0, dv, scale, block=None, out_dtype=None,
                      planar: bool = False, plan: Optional[FitPlan] = None,
                      ndc=None, origin=None, bg_pix=None):
    """Warp a batch of intermediate images ((P, gi, gi, 4), or planar
    (P, 4, gi, gi) with ``planar=True``) to (P, H, W, 4) screens with the
    background composited.

    block: cascade spec (see _norm_cascade; None = the production
    _CASCADE). Each pose takes the biggest level whose fit predicate holds,
    else the reference warp. plan: the batch's fit decisions queued
    earlier by plan_fits (render_frames queues them ahead of the march; a
    plan carries its own levels, so ``block`` is then not read); None
    queues them here and waits for them. Each level then warps its poses
    with one launch of kernel W, in place into the frames, an NDC tree's
    (``ndc``, the poses' (P, 3) ``origin``) on display_params_ndc's rows
    too. ``bg_pix``: a world tree's
    (P, H, W, 4) f16 mesh background (mesh_background), composited by
    kernel W's mesh mode and, for the poses no level fits, the reference
    warp; NDC trees take none (ValueError, as in the reference)."""
    if bg_pix is not None and ndc is not None:
        raise ValueError("mesh compositing on the slab path supports world "
                         "trees only")
    from volrend_torch.ops import slab_render
    dev = inter.device
    P = inter.shape[0]
    itp = inter if planar else inter.movedim(-1, 1)
    itp = itp.to(_F32).contiguous()
    fx = torch.as_tensor(fx, dtype=_F32, device=dev)
    fy = torch.as_tensor(fy, dtype=_F32, device=dev)
    geom_args = (R, fx, fy, width, height, gi, perm, u0, du, v0, dv, scale,
                 ndc, origin)
    if plan is None:
        plan = plan_fits(*geom_args[:12], block, ndc, origin)
    choice = plan.choice()

    u8 = out_dtype == torch.uint8
    out = torch.empty((P, height, width, 4),
                      dtype=torch.uint8 if u8 else _F32, device=dev)
    bg = float(opt.background_brightness)
    for li, (B, W) in enumerate(plan.levels):
        idx = np.nonzero(choice == li)[0]
        if idx.size == 0:
            continue
        sel = (torch.arange(P, dtype=torch.int32, device=dev)
               if idx.size == P else to_device(idx, torch.int32, dev))
        warp_display(itp, plan.prm, sel, out, B, W, gi, bg, bg_pix)
    idx = np.nonzero(choice < 0)[0]
    if idx.size:
        sel = to_device(idx, torch.int64, dev)
        sub = _select_geom(geom_args, sel)
        ref = slab_render._warp_to_screen_ref(
            itp.index_select(0, sel).movedim(1, -1), opt, *sub[:12],
            ndc=ndc, origin=None if ndc is None else sub[13],
            bg_pix=None if bg_pix is None else bg_pix.index_select(0, sel))
        out[sel] = to_display_dtype(ref, out_dtype)
    return out


# ---------------------------------------------------------------------------
# the precise (training) superquad warp with a hand-written backward
# ---------------------------------------------------------------------------
#
#   forward:  kernel B (f32 table) -> kernel C (f32 table, qscale 1,
#             qshift 0; each block gathers its own row)
#   backward: kernel 5 (tent + composite adjoint per block, added into
#             the zero-filled table cotangent at the block's row) ->
#             kernel 6 (build adjoint: each pixel sums its 16 cells)
#
# Geometry cotangents are zero by contract (training differentiates the
# intermediate image only, as the reference's custom VJP does).

#: training-path option (the reference's, off by default there too): warp
#: with the precise superquad instead of autograd through the reference
#: quad-gather warp. Read at call time by slab_render._warp_to_screen.
_PRECISE_SQ = False


def usable_precise(width: int, height: int, gi: int) -> bool:
    """Static gate for the training-path superquad warp."""
    return usable(width, height, gi, block=_PRECISE_B, win=_PRECISE_WIN)


def combine_adjoint(g: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
                    okm: torch.Tensor, Y0: torch.Tensor, X0: torch.Tensor,
                    gi: int, bg: float) -> torch.Tensor:
    """Transpose of the precise level's f32 tent-combine with the
    composite adjoint, scattered into the table cotangent.

    g (P, H, W, 4) f32 cotangent of combine_emit's output; ry/rx/okm
    (P, 4, H/2, W/2) f32 and Y0/X0 (P, H/2, W/2) int32 (the forward's).
    Returns the (P, H3*W3, 64) f32 cotangent of the table (H3 = W3 =
    gi - 3): each block's window-cell cotangents, channel _chan(cy, cx, c),
    summed into the block's row Y0*W3 + X0. Launches kernel 5 on CUDA
    tensors (counted in ``launches``; it adds with atomics, so rows that
    blocks share sum in a run-dependent order); runs
    ``combine_adjoint_ref`` on CPU tensors."""
    By, Bx = _PRECISE_B
    Wy, Wx = _PRECISE_WIN
    P, H, W, _ = g.shape
    Hh, Wh = H // By, W // Bx
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    dev = g.device
    if dev.type == "cpu":
        return combine_adjoint_ref(g, ry, rx, okm, Y0, X0, gi, bg)
    if dev.type != "cuda":
        raise RuntimeError(f"combine_adjoint: no kernel for device {dev}")
    _check("combine_adjoint: g", g, _F32, (P, Hh * By, Wh * Bx, 4), dev)
    for name, t in (("ry", ry), ("rx", rx), ("okm", okm)):
        _check(f"combine_adjoint: {name}", t, _F32, (P, By * Bx, Hh, Wh),
               dev)
    for name, t in (("Y0", Y0), ("X0", X0)):
        _check(f"combine_adjoint: {name}", t, torch.int32, (P, Hh, Wh), dev)
    dtbl = torch.zeros((P, H3 * W3, 4 * Wy * Wx), dtype=_F32, device=dev)
    lib = kernels.lib("warp_combine_adj")
    kernels.check(lib.vt_warp_combine_adj(
        g.data_ptr(), ry.data_ptr(), rx.data_ptr(), okm.data_ptr(),
        Y0.data_ptr(), X0.data_ptr(), dtbl.data_ptr(), P, Hh, Wh, H3, W3,
        float(bg), torch.cuda.current_stream(dev).cuda_stream),
        "warp_combine_adj")
    combine_adjoint.launches += 1
    return dtbl


combine_adjoint.launches = 0


def combine_adjoint_ref(g, ry, rx, okm, Y0, X0, gi: int,
                        bg: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 5 (f32 arithmetic): each block's
    row of window-cell cotangents, then ``index_add_`` into the table
    (the reference's ``.at[flat].add``)."""
    By, Bx = _PRECISE_B
    Wy, Wx = _PRECISE_WIN
    P, H, W, _ = g.shape
    Hh, Wh = H // By, W // Bx
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    # subpixel split: (P, S, Hh, Wh, 4) with s = sy*Bx + sx
    gs = g.reshape(P, Hh, By, Wh, Bx, 4).permute(0, 2, 4, 1, 3, 5).reshape(
        P, By * Bx, Hh, Wh, 4)
    ok = (okm > 0.5)[..., None]
    dalpha = gs[..., 3:] - bg * (gs[..., 0:1] + gs[..., 1:2] + gs[..., 2:3])
    d = torch.where(ok, torch.cat([gs[..., :3], dalpha], -1), 0.0)
    ryc = torch.clamp(ry, 0.0, Wy - 1.0)
    rxc = torch.clamp(rx, 0.0, Wx - 1.0)
    cyv = torch.arange(Wy, dtype=_F32, device=g.device)
    cxv = torch.arange(Wx, dtype=_F32, device=g.device)
    wy = torch.clamp(1.0 - torch.abs(ryc[..., None] - cyv), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(rxc[..., None] - cxv), min=0.0)
    rows = torch.einsum("pshwy,pshwx,pshwc->phwyxc", wy, wx, d)
    # each block's table row, as a row of the poses' stacked tables
    flat = (Y0.long() * W3 + X0.long()
            + torch.arange(P, device=g.device)[:, None, None] * (H3 * W3))
    dtbl = torch.zeros((P * H3 * W3, 4 * Wy * Wx), dtype=_F32,
                       device=g.device)
    dtbl.index_add_(0, flat.reshape(-1), rows.reshape(-1, 4 * Wy * Wx))
    return dtbl.reshape(P, H3 * W3, 4 * Wy * Wx)


def build_adjoint(dtbl: torch.Tensor, gi: int,
                  win=_PRECISE_WIN) -> torch.Tensor:
    """Transpose of the f32 table build: (P, H3*W3, 4*Wy*Wx) f32 table
    cotangent -> (P, gi, gi, 4) f32 d_inter, each pixel the sum of its
    Wy*Wx window cells. Launches kernel 6 on CUDA tensors (counted in
    ``launches``); runs ``build_adjoint_ref`` on CPU tensors."""
    Wy, Wx = _win2d(win)
    P = dtbl.shape[0]
    dev = dtbl.device
    if dev.type == "cpu":
        return build_adjoint_ref(dtbl, gi, (Wy, Wx))
    if dev.type != "cuda":
        raise RuntimeError(f"build_adjoint: no kernel for device {dev}")
    _check("build_adjoint: dtbl", dtbl, _F32,
           (P, (gi - Wy + 1) * (gi - Wx + 1), 4 * Wy * Wx), dev)
    out = torch.empty((P, gi, gi, 4), dtype=_F32, device=dev)
    lib = kernels.lib("warp_build_adj")
    kernels.check(lib.vt_warp_build_adj(
        dtbl.data_ptr(), out.data_ptr(), P, gi, Wy, Wx,
        torch.cuda.current_stream(dev).cuda_stream), "warp_build_adj")
    build_adjoint.launches += 1
    return out


build_adjoint.launches = 0


def build_adjoint_ref(dtbl, gi: int, win=_PRECISE_WIN) -> torch.Tensor:
    """Plain PyTorch version of kernel 6 (the same sum order)."""
    Wy, Wx = _win2d(win)
    P = dtbl.shape[0]
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    t = dtbl.reshape(P, H3, W3, Wy, Wx, 4)
    out = torch.zeros((P, gi, gi, 4), dtype=_F32, device=dtbl.device)
    for cy in range(Wy):
        for cx in range(Wx):
            out[:, cy:cy + H3, cx:cx + W3] += t[:, :, :, cy, cx]
    return out


class _PreciseWarp(torch.autograd.Function):
    """The precise superquad warp (the reference's ``make_warp_precise``):
    (P, gi, gi, 4) f32 intermediate images -> (P, H, W, 4) f32 screens,
    with the hand-written backward above. The geometry inputs get no
    gradient."""

    @staticmethod
    def forward(ctx, inter, R, fx, fy, u0, du, v0, dv, scale, origin,
                statics):
        bg, width, height, gi, perm, ndc = statics
        geom_args = (R, fx, fy, width, height, gi, perm, u0, du, v0, dv,
                     scale, ndc, origin)
        gys, gxs, okm, Y0, X0 = _level_geometry(geom_args, gi, _PRECISE_B,
                                                _PRECISE_WIN)
        ry = (gys - Y0.to(_F32)[:, None]).contiguous()
        rx = (gxs - X0.to(_F32)[:, None]).contiguous()
        okm = okm.contiguous()
        tbl = build_table(inter.to(_F32).contiguous(), _PRECISE_WIN,
                          dtype=_F32, planar=False)
        Y0, X0 = Y0.contiguous(), X0.contiguous()
        out = combine_emit(tbl, Y0, X0, ry, rx, okm, gi, height, width,
                           _PRECISE_B, _PRECISE_WIN, bg, qscale=1.0,
                           qshift=0.0)
        ctx.save_for_backward(ry, rx, okm, Y0, X0)
        ctx.statics = statics
        return out

    @staticmethod
    def backward(ctx, g):
        ry, rx, okm, Y0, X0 = ctx.saved_tensors
        bg, _, _, gi, _, _ = ctx.statics
        dtbl = combine_adjoint(g.to(_F32).contiguous(), ry, rx, okm, Y0, X0,
                               gi, bg)
        d_inter = build_adjoint(dtbl, gi)
        return (d_inter,) + (None,) * 10


def warp_precise(inter, bg: float, R, fx, fy, width: int, height: int,
                 gi: int, perm: Tuple[int, int, int], u0, du, v0, dv,
                 scale, ndc=None, origin=None) -> torch.Tensor:
    """The precise superquad warp of (P, gi, gi, 4) intermediate images to
    (P, H, W, 4) f32 screens over the background ``bg``, differentiable
    w.r.t. ``inter`` (kernels B, C forward; 5, 6 backward). ``ndc``/
    ``origin``: an NDC tree's sidecar and the poses' (P, 3) origins. The
    caller checks usable_precise and each pose's fit predicate
    (slab_render._warp_to_screen does)."""
    dev = inter.device
    fx = torch.as_tensor(fx, dtype=_F32, device=dev)
    fy = torch.as_tensor(fy, dtype=_F32, device=dev)
    return _PreciseWarp.apply(inter, R, fx, fy, u0, du, v0, dv, scale,
                              origin, (float(bg), width, height, gi,
                                       tuple(perm), ndc))
