"""Superquad display warp: the fast projective screen resample (the
counterpart of ``volrend_tpu/ops/display_warp.py``).

The display path's last step warps the (gi, gi, 4) intermediate slope-grid
image to the (H, W, 4) screen with a projective bilinear resample. The
superquad form groups screen pixels into (By, Bx) blocks; every block reads
ONE row of a window table — the (Wy, Wx) intermediate cells around the
block's footprint, 4 channels each — and each subpixel tent-combines its
bilinear taps inside that window:

- **kernel B** (``csrc/warp_build.cu``, wrapper ``build_table``) quantizes
  the planar intermediate to affine int8 (q = round(v * 255) - 128) and
  writes the (H3 * W3, 4 * Wy * Wx) window-row table;
- **kernel C** (``csrc/warp_combine.cu``, wrapper ``combine_emit``) gathers
  each block's row, computes the tent weights from the subpixel's window
  position, dequantizes, masks, composites over the background and writes
  interleaved (H, W, 4) RGBA (uint8 or float32).

A pose whose blocks misfit their window in bulk (wide-FOV / grazing
geometry) falls through the cascade of (block, window) levels and finally
to the reference quad-gather warp (``slab_render._warp_to_screen_ref``).
The fit predicates of a whole pose batch are computed in one pass and
brought to the host in one transfer; the branching is plain Python.

Every function takes a batch of poses: per-pose tensors carry a leading
pose dimension. On CUDA tensors the wrappers launch the kernels; on CPU
tensors they run the plain PyTorch versions ``build_table_ref`` and
``combine_emit_ref``. World trees only (NDC and mesh backgrounds come with
a later slice).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from volrend_torch import kernels
from volrend_torch.utils.options import RenderOptions

_F32 = torch.float32

#: production cascade: ((By, Bx), (Wy, Wx)) levels, tried biggest block
#: first with per-pose misfit gates falling through to the next level and
#: finally the reference warp (the reference's _CASCADE)
_CASCADE: Tuple = (((2, 2), (4, 4)), ((4, 4), (5, 5)))

#: affine int8 window table: q = round(v*255) - 128, v = q/255 + 128/255
_QSCALE = 1.0 / 255.0
_QSHIFT = 128.0 / 255.0


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
# geometry (per pose batch; world trees)
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


def _pixel_slopes(R, fx, fy, width: int, height: int, gi: int,
                  perm: Tuple[int, int, int], u0, du, v0, dv, scale):
    """Full-resolution (P, H, W) slope-grid coordinates of every screen
    pixel (the pixel->slope map of a world-space pinhole is a homography,
    so the three tree-dir components are linear forms of the pixel
    coordinates)."""
    dev = R.device
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


def _level_fits(gyf, gxf, gi: int, B, win=(4, 4)):
    """Per-pose bulk-misfit predicate (P,) bool for one (block, window)
    level: fewer than 0.1% of the blocks misfit their window."""
    Wy, Wx = _win2d(win)
    ymin, ymax, xmin, xmax, _ = _block_extents(gyf, gxf, gi, B)
    misfit = ((ymax >= torch.floor(ymin) + (Wy - 1.0))
              | (xmax >= torch.floor(xmin) + (Wx - 1.0)))
    return torch.mean(misfit.to(_F32), (1, 2)) < 1e-3


def _sub_slopes(R, fx, fy, width: int, height: int, gi: int,
                perm: Tuple[int, int, int], u0, du, v0, dv, scale, B=2):
    """Per-subpixel slope-grid coordinates in (P, By*Bx, Hh, Wh) layout."""
    By, Bx = _block2d(B)
    Hh, Wh = height // By, width // Bx
    dev = R.device
    po, qo = np.mgrid[0:By, 0:Bx].reshape(2, -1).astype(np.float32)
    po = torch.as_tensor(po, device=dev)
    qo = torch.as_tensor(qo, device=dev)
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
    Wy, Wx = _win2d(win)
    gy, gx = _sub_slopes(*geom_args, B=B)
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


# ---------------------------------------------------------------------------
# kernel B: the window-table build
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {dev}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def build_table(inter: torch.Tensor, win: Tuple[int, int] = (4, 4)
                ) -> torch.Tensor:
    """(P, 4, gi, gi) f32 planar intermediate -> (P, H3*W3, 4*Wy*Wx) int8
    affine window-row table, row Y*W3 + X, channel (cy*Wx + cx)*4 + c =
    q(inter[c, Y+cy, X+cx]). Launches kernel B on CUDA tensors; runs
    ``build_table_ref`` on CPU tensors."""
    Wy, Wx = _win2d(win)
    P, _, gi, _ = inter.shape
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    dev = inter.device
    if dev.type == "cpu":
        return build_table_ref(inter, (Wy, Wx))
    if dev.type != "cuda":
        raise RuntimeError(f"build_table: no kernel for device {dev}")
    _check("build_table: inter", inter, _F32, (P, 4, gi, gi), dev)
    table = torch.empty((P, H3 * W3, 4 * Wy * Wx), dtype=torch.int8,
                        device=dev)
    lib = kernels.lib("warp_build")
    kernels.check(lib.vt_warp_build(
        inter.data_ptr(), table.data_ptr(), P, gi, Wy, Wx,
        torch.cuda.current_stream(dev).cuda_stream), "warp_build")
    build_table.launches += 1
    return table


build_table.launches = 0


def _quantize_affine(v: torch.Tensor) -> torch.Tensor:
    """Affine int8: q = round_half_even(clip(v, 0, 1) * 255) - 128."""
    return (torch.round(torch.clamp(v, 0.0, 1.0) * 255.0) - 128.0
            ).to(torch.int8)


def build_table_ref(inter: torch.Tensor, win: Tuple[int, int] = (4, 4)
                    ) -> torch.Tensor:
    """Plain PyTorch version of kernel B (same layout, bit-equal)."""
    Wy, Wx = _win2d(win)
    P, _, gi, _ = inter.shape
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    q = _quantize_affine(inter)                                 # (P,4,gi,gi)
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
                 out_dtype=None) -> torch.Tensor:
    """Per (By, Bx) screen block: gather the block's window row of the int8
    table at Y0*W3 + X0, tent-combine each subpixel's taps at its window
    position (ry, rx) (clamped to the window), dequantize the affine int8
    (x _QSCALE + _QSHIFT), mask with okm and composite over the background
    ``bg``.

    table (P, H3*W3, 4*Wy*Wx) int8 with H3, W3 = gi - Wy + 1, gi - Wx + 1
    (see build_table); Y0/X0 (P, Hh, Wh) int32; ry/rx/okm
    (P, By*Bx, Hh, Wh) f32. Returns (P, H, W, 4) uint8 (out_dtype =
    torch.uint8, rounded half to even after a [0, 1] clamp) or f32.
    Launches kernel C on CUDA tensors; runs ``combine_emit_ref`` on CPU."""
    By, Bx = _block2d(B)
    Wy, Wx = _win2d(win)
    P = table.shape[0]
    Hh, Wh = height // By, width // Bx
    dev = table.device
    if dev.type == "cpu":
        return combine_emit_ref(table, Y0, X0, ry, rx, okm, gi, height,
                                width, (By, Bx), (Wy, Wx), bg, out_dtype)
    if dev.type != "cuda":
        raise RuntimeError(f"combine_emit: no kernel for device {dev}")
    if out_dtype not in (None, torch.float32, torch.uint8):
        raise ValueError(f"combine_emit: out_dtype {out_dtype} not taken")
    H3, W3 = gi - Wy + 1, gi - Wx + 1
    _check("combine_emit: table", table, torch.int8,
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
        rx.data_ptr(), okm.data_ptr(), out.data_ptr(), int(u8), P, height,
        width, By, Bx, Wy, Wx, H3, W3, float(bg), _QSCALE, _QSHIFT,
        torch.cuda.current_stream(dev).cuda_stream),
        "warp_combine")
    combine_emit.launches += 1
    combine_emit.poses += P
    return out


combine_emit.launches = 0
combine_emit.poses = 0


def combine_emit_ref(table, Y0, X0, ry, rx, okm, gi: int, height: int,
                     width: int, B, win, bg: float, out_dtype=None):
    """Plain PyTorch version of kernel C (f32 arithmetic)."""
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
    rgba = rgba * _QSCALE + _QSHIFT
    alpha = rgba[..., 3:4]
    ok = (okm > 0.5)[..., None]
    rgb = torch.where(ok, rgba[..., :3] + bg * (1.0 - alpha),
                      torch.full_like(rgba[..., :3], bg))
    a = torch.where(ok, alpha, torch.zeros_like(alpha))
    out = torch.cat([rgb, a], -1)                           # (P, S, Hh, Wh, 4)
    out = out.reshape(P, By, Bx, Hh, Wh, 4).permute(0, 3, 1, 4, 2, 5)
    out = out.reshape(P, height, width, 4)
    if out_dtype == torch.uint8:
        return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0
                           ).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# the warp with its per-pose cascade
# ---------------------------------------------------------------------------

def warp_to_screen_sq(inter, opt: RenderOptions, R, fx, fy,
                      width: int, height: int, gi: int,
                      perm: Tuple[int, int, int],
                      u0, du, v0, dv, scale, block=None, out_dtype=None,
                      planar: bool = False):
    """Warp a batch of intermediate images ((P, gi, gi, 4), or planar
    (P, 4, gi, gi) with ``planar=True``) to (P, H, W, 4) screens with the
    background composited.

    block: cascade spec (see _norm_cascade; None = the production
    _CASCADE). Each pose takes the biggest level whose fit predicate holds,
    else the reference warp. The predicates of all poses and levels are
    computed in one pass and read on the host in one transfer; each level
    then runs its poses through kernels B and C together. (The
    reference's NDC and mesh-background variants come with slice B.)"""
    from volrend_torch.ops import slab_render
    dev = inter.device
    P = inter.shape[0]
    itp = inter if planar else inter.movedim(-1, 1)
    itp = itp.to(_F32).contiguous()
    fx = torch.as_tensor(fx, dtype=_F32, device=dev)
    fy = torch.as_tensor(fy, dtype=_F32, device=dev)
    geom_args = (R, fx, fy, width, height, gi, perm, u0, du, v0, dv, scale)

    levels = [(B, W) for (B, W) in _norm_cascade(block)
              if usable(width, height, gi, block=B, win=W)]
    levels.sort(key=lambda bw: -bw[0][0] * bw[0][1])     # biggest block first
    choice = np.full(P, -1)
    if levels:
        gyf, gxf = _pixel_slopes(*geom_args)
        fits = torch.stack([_level_fits(gyf, gxf, gi, B, W)
                            for B, W in levels]).cpu().numpy()    # (L, P)
        del gyf, gxf
        for p in range(P):
            hit = np.nonzero(fits[:, p])[0]
            if hit.size:
                choice[p] = int(hit[0])

    u8 = out_dtype == torch.uint8
    out = torch.empty((P, height, width, 4),
                      dtype=torch.uint8 if u8 else _F32, device=dev)
    for li, (B, W) in enumerate(levels):
        idx = np.nonzero(choice == li)[0]
        if idx.size == 0:
            continue
        sel = torch.as_tensor(idx, device=dev)
        sub = (R.index_select(0, sel), fx, fy, width, height, gi, perm,
               u0.index_select(0, sel), du.index_select(0, sel),
               v0.index_select(0, sel), dv.index_select(0, sel), scale)
        gys, gxs, okm, Y0, X0 = _level_geometry(sub, gi, B, W)
        tbl = build_table(itp.index_select(0, sel), W)
        ry = (gys - Y0.to(_F32)[:, None]).contiguous()
        rx = (gxs - X0.to(_F32)[:, None]).contiguous()
        out[sel] = combine_emit(
            tbl, Y0.contiguous(), X0.contiguous(), ry, rx,
            okm.contiguous(), gi, height, width, B, W,
            float(opt.background_brightness), out_dtype=out_dtype)
    idx = np.nonzero(choice < 0)[0]
    if idx.size:
        sel = torch.as_tensor(idx, device=dev)
        ref = slab_render._warp_to_screen_ref(
            itp.index_select(0, sel).movedim(1, -1), opt,
            R.index_select(0, sel), fx, fy, width, height, gi, perm,
            u0.index_select(0, sel), du.index_select(0, sel),
            v0.index_select(0, sel), dv.index_select(0, sel), scale)
        out[sel] = to_display_dtype(ref, out_dtype)
    return out
