"""The fused slab march and its backward (the counterpart of
``volrend_tpu/ops/pallas_slab.py``).

Per (perm, flip) pose group the payload is channel-planar and slab-major,
(Gz, Dp, Gy, Gx). ``march_slabs`` walks the occupied slabs front to back
and, per slab and per intermediate pixel of the (gi, gi) slope grid:

- dequantizes and shades every voxel the pixel's ray can cross:
  sigma masked by the sigma threshold, and srgb = sigma * sigmoid(sum_k
  code * basis_k * qs_k);
- warps [sigma, sigma*r, sigma*g, sigma*b] onto the pixel with the
  separable box-integration two-tap weights (``_overlap_mats`` — each weight
  is the exact overlap of the ray's within-slab span with a cell; edge cells
  extend to +-inf, cell indices stay global under the in-plane crop);
- composites tau = sigma_w * dt_pix * frac_z front to back with the
  stop-threshold freeze.

Two option sets are taken, both SH:

- the display path's: an int8 payload (colour codes, then the 14-bit
  sigma's hi and lo planes, Dp = D + 1; ``sig2=True``) with the view
  direction taken once per K-slab window at the window centre
  (``dir_win=True``);
- the training path's: a bf16 payload with Dp = D (sigma in plane D-1,
  ``sig2=False``) with the view direction per slab (``dir_win=False``),
  all slabs or a culled list. ``march_slabs_bwd`` is its payload cotangent.

On CUDA tensors ``march_slabs`` launches kernel M (``csrc/slab_march.cu``),
one launch per pose batch, and ``march_slabs_bwd`` the backward kernel
(``csrc/slab_march_bwd.cu``); on CPU tensors they run ``march_slabs_ref``
and ``march_slabs_bwd_ref``, the same functions in plain PyTorch (dense
overlap matrices, as the reference builds them). Kernel and plain version
differ only in summation order. Unlike the reference kernels, neither rounds
the warp weights or the stacked channels to bf16.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from volrend_torch import kernels
from volrend_torch.models.data_format import BasisType
from volrend_torch.ops import basis as basis_mod
from volrend_torch.utils.device import to_device

__all__ = ["march_slabs", "march_slabs_ref", "march_slabs_bwd",
           "march_slabs_bwd_ref", "march_bwd_inputs"]

_F32 = torch.float32

#: display-path slabs per window (the view direction is shared by the
#: window's slabs; K-aligned occupancy masks)
_K_STEP = 4

# params vector layout (f32): see _pack_params (+1 slot appended by
# march_slabs: [30] = z_base, the global z of the payload's first slab)
_NP = 31


def _col(v, P: int, device) -> torch.Tensor:
    """Scalar / (P,) value -> (P,) f32 tensor on ``device``."""
    t = to_device(v, _F32, device)
    return t.expand(P) if t.dim() == 0 else t.reshape(P)


def _pack_params(cz, cy, cx, u0, du, v0, dv, sgn, spp, inv_scale,
                 sigma_thresh, stop_thresh, lo1, hi1, lo2, hi2,
                 dirM, z0_depth) -> torch.Tensor:
    """Per-pose scalar params, (P, 30) f32 (the reference's 30-slot layout
    with a leading pose dimension). Per-pose values are (P,) tensors,
    shared ones scalars. params[20:29] = dirM row-major: the affine map
    from a voxel's slope-grid coordinates to its (unnormalized) world view
    direction, dir[a] = dirM[a,0] + dirM[a,1]*u + dirM[a,2]*v.
    params[29] = the depth-mode t origin along the slab axis."""
    P = cz.shape[0]
    dev = cz.device
    cols = [cz, cy, cx, u0, du, v0, dv, sgn, spp[0], spp[1], spp[2],
            inv_scale[0], inv_scale[1], inv_scale[2],
            sigma_thresh, stop_thresh, lo1, hi1, lo2, hi2]
    head = torch.stack([_col(c, P, dev) for c in cols], -1)
    dirM = torch.as_tensor(dirM, dtype=_F32, device=dev).reshape(P, 9)
    return torch.cat([head, dirM, _col(z0_depth, P, dev)[:, None]], -1)


def _zb_planes(params: torch.Tensor, zbounds: torch.Tensor, G: int,
               gi: int) -> torch.Tensor:
    """Extend the (P, 2, gi, gi) zbounds with the two per-frame-constant
    composite planes: plane 2 = dt_pix (per-pixel slab thickness along the
    ray, world units), plane 3 = the depth-mode tview base."""
    u0, du, v0, dv = (params[:, i, None, None] for i in (3, 4, 5, 6))
    spp0, spp1, spp2 = (params[:, i, None, None] for i in (8, 9, 10))
    io = torch.arange(gi, dtype=_F32, device=params.device)
    up_r = u0 + du * io[None, :, None]
    vp_r = v0 + dv * io[None, None, :]
    up = up_r * spp1
    vp = vp_r * spp2
    dt_pix = (1.0 / G) * torch.sqrt(up * up + vp * vp + spp0 * spp0)
    tview = torch.sqrt(1.0 + up_r * up_r + vp_r * vp_r)
    return torch.cat([zbounds, dt_pix[:, None], tview[:, None]], 1)


def _march_k(Gz: int, k_per_step: int) -> int:
    """Slabs per window: k_per_step, shrunk to divide the slab count."""
    K = max(1, min(k_per_step, Gz))
    while Gz % K:
        K -= 1
    return K


def _window_masks(slab_ids: Sequence[int], K: int
                  ) -> Tuple[List[int], List[int]]:
    """Group march-ordered slab ids into K-aligned windows (in first-visit
    order) with occupancy bit masks (bit dz set = slab w*K+dz occupied)."""
    win_order, win_mask = [], {}
    for sid in slab_ids:
        w = sid // K
        if w not in win_mask:
            win_mask[w] = 0
            win_order.append(w)
        win_mask[w] |= 1 << (sid % K)
    return win_order, [win_mask[w] for w in win_order]


def _later_slices(unsupported: List[str]) -> None:
    if unsupported:
        raise NotImplementedError(
            "march_slabs takes the display path's SH int8 options and the "
            "training path's SH bf16 options only; "
            + ", ".join(unsupported) + " come with slices B-D (ROADMAP.md)")


def _common_unsupported(D, bd, fmt, rot, basis_lo, basis_hi,
                        bbox_full) -> List[str]:
    unsupported = []
    if BasisType(fmt) != BasisType.SH or bd not in basis_mod.SH_SUPPORTED_DIMS:
        unsupported.append(f"format {BasisType(fmt).name}{bd}")
    if D != 3 * bd + 1:
        unsupported.append(f"data_dim {D} for SH{bd}")
    if rot is not None:
        unsupported.append("rot_dirs")
    if not bbox_full:
        unsupported.append("a non-full render_bbox")
    if (basis_lo, basis_hi) != (0, 24):
        unsupported.append(f"basis window ({basis_lo}, {basis_hi})")
    return unsupported


def _check_options(gplanar, G, D, bd, sig2, fmt, depth, rot, basis_lo,
                   basis_hi, bbox_full, shade_bf16, dir_win, z_base,
                   acc_init):
    """The display path's option set (int8) or the training path's (bf16);
    anything else is a later slice."""
    unsupported = _common_unsupported(D, bd, fmt, rot, basis_lo, basis_hi,
                                      bbox_full)
    train = gplanar.dtype == torch.bfloat16
    if depth:
        unsupported.append("depth mode")
    if shade_bf16:
        unsupported.append("bf16 shading")
    if train:
        if dir_win:
            unsupported.append("window shading directions (dir_win=True) "
                               "on a bf16 (f16-bake) payload")
    else:
        if not sig2:
            unsupported.append("a bf16 (f16-bake) payload")
        if not dir_win:
            unsupported.append("per-slab shading directions (dir_win=False) "
                               "on the int8 payload")
    if z_base is not None or acc_init is not None:
        unsupported.append("z-sharded segments")
    _later_slices(unsupported)
    if gplanar.dim() != 4 or gplanar.dtype not in (torch.int8,
                                                   torch.bfloat16):
        raise ValueError(f"payload must be (Gz, Dp, Gy, Gx) int8 or bf16, "
                         f"got {tuple(gplanar.shape)} {gplanar.dtype}")
    if train and sig2:
        raise ValueError("a bf16 payload holds sigma in one plane (sig2 "
                         "is the int8 split)")
    Dp = D if train else D + 1
    if gplanar.shape[1] != Dp:
        raise ValueError(f"{gplanar.dtype} payload has {gplanar.shape[1]} "
                         f"planes; expected {Dp}")
    if gplanar.shape[0] != G:
        raise ValueError("payload must hold all G slabs")


def march_slabs(gplanar, params, qscale, zbounds, G: int,
                gi: int, D: int, bd: int,
                perm: Tuple[int, int, int],
                slab_ids: Optional[Tuple[int, ...]] = None,
                basis_lo: int = 0, basis_hi: int = 24, sig2: bool = False,
                extra=None, fmt: int = 1, depth: bool = False,
                rot: Optional[Tuple[float, ...]] = None,
                flip: bool = False, k_per_step: int = 4,
                bbox_full: bool = False, shade_bf16: bool = False,
                dir_win: bool = False, z_base=None, acc_init=None,
                crop: Optional[Tuple[int, int, int, int]] = None):
    """Run the fused march for a batch of poses sharing one payload;
    returns acc (P, 4, gi, gi): [r, g, b, T].

    gplanar: (G, Dp, Gy, Gx) channel-planar permuted payload: int8 codes
        with Dp = D+1 (colour codes + 14-bit sigma over the last two
        planes; sig2=True, dir_win=True: the display path), or bf16 with
        Dp = D (sigma in plane D-1; sig2=False, dir_win=False: the training
        path, view directions per slab).
    params: (P, 30) f32 (see _pack_params). qscale: (Dp,) f32, each basis
        function's scale shared across rgb (the int8 bake's; ones for
        training).
    zbounds: (P, 2, gi, gi) f32 per-pixel live z interval.
    slab_ids: slab z-indices in march order, pre-culled of empty slabs;
        None means all G slabs in ascending order.
    flip: True when the march runs toward -z (descending slab ids).
    crop: optional (y0, Gy, x0, Gx) in-plane occupancy crop of the payload
        (slab_render.inplane_crop); None = uncropped.
    The remaining arguments mirror the reference's signature; only the
    display and training paths' values are taken (see _check_options).
    """
    _check_options(gplanar, G, D, bd, sig2, fmt, depth, rot, basis_lo,
                   basis_hi, bbox_full, shade_bf16, dir_win, z_base,
                   acc_init)
    m = march_inputs(gplanar, params, zbounds, G, gi, slab_ids,
                     k_per_step, crop)
    dev = gplanar.device
    if not m["wins"]:
        acc = torch.zeros((m["params"].shape[0], 4, gi, gi), dtype=_F32,
                          device=dev)
        acc[:, 3] = 1.0
        return acc
    if dev.type == "cuda":
        return _march_cuda(gplanar, qscale, D=D, bd=bd, flip=flip, **m)
    if dev.type == "cpu":
        return march_slabs_ref(gplanar, qscale, D=D, bd=bd, flip=flip, **m)
    raise RuntimeError(f"march_slabs: no kernel for device {dev}")


march_slabs.launches = 0
march_slabs.poses = 0


def march_inputs(gplanar, params, zbounds, G: int, gi: int,
                 slab_ids: Optional[Sequence[int]] = None,
                 k_per_step: int = _K_STEP,
                 crop: Optional[Tuple[int, int, int, int]] = None) -> dict:
    """The march's prepared inputs, shared by kernel M and its plain
    version: params (P, 31) (z_base appended), zb (P, 4, gi, gi)
    (_zb_planes), the K-aligned windows and occupancy masks in march
    order, and the statics G, gi, K, y0, x0."""
    Gz, _, Gy, Gx = gplanar.shape
    y0, x0 = (crop[0], crop[2]) if crop is not None else (0, 0)
    if crop is not None and (crop[1], crop[3]) != (Gy, Gx):
        raise ValueError(f"payload in-plane shape {(Gy, Gx)} != crop {crop}")
    if slab_ids is None:
        slab_ids = tuple(range(Gz))
    K = _march_k(Gz, k_per_step)
    params = torch.as_tensor(params, dtype=_F32)
    if params.dim() != 2 or params.shape[1] < 30:
        raise ValueError("params must be (P, 30) (see _pack_params)")
    P = params.shape[0]
    params = torch.cat([params[:, :30],
                        torch.zeros((P, 1), dtype=_F32,
                                    device=params.device)], 1).contiguous()
    zb = _zb_planes(params, zbounds, G, gi).contiguous()
    wins, masks = _window_masks(slab_ids, K)
    return dict(params=params, zb=zb, wins=wins, masks=masks, G=G, gi=gi,
                K=K, y0=y0, x0=x0)


def _march_cuda(gplanar, qscale, params, zb, wins, masks, G, gi, D, bd, K,
                flip, y0, x0):
    """Launch kernel M over the whole pose batch (one launch); a bf16
    payload selects the training mode (per-slab view directions)."""
    dev = gplanar.device
    Gz, Dp, Gy, Gx = gplanar.shape
    P = params.shape[0]
    train = gplanar.dtype == torch.bfloat16
    for name, t, dt, shape in (
            ("payload", gplanar, gplanar.dtype, (G, Dp, Gy, Gx)),
            ("params", params, _F32, (P, _NP)),
            ("qscale", qscale, _F32, (Dp,)),
            ("zbounds", zb, _F32, (P, 4, gi, gi))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"march_slabs: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {dev}")
    wm = to_device(np.asarray([wins, masks], np.int32), torch.int32, dev)
    acc = torch.empty((P, 4, gi, gi), dtype=_F32, device=dev)
    lib = kernels.lib("slab_march")
    kernels.check(lib.vt_march_slabs(
        gplanar.data_ptr(), params.data_ptr(), qscale.data_ptr(),
        zb.data_ptr(), wm.data_ptr(), len(wins), acc.data_ptr(),
        P, G, gi, Dp, Gy, Gx, y0, x0, bd, K, int(bool(flip)), int(train),
        torch.cuda.current_stream(dev).cuda_stream), "slab_march")
    march_slabs.launches += 1
    march_slabs.poses += P
    return acc


def _overlap_mat(c0G, slope_G, s0, s1, cell, G: int):
    """(gi, n) box-integration weights of one slab along one axis: row i
    holds the overlap of ray i's within-slab span with each cell (edge
    cells extended to +-inf), divided by the span length.

    c0G: camera coordinate * G; slope_G: (gi,) ray slope * G; cell: (n,)
    GLOBAL f32 cell indices."""
    big = 1e9
    hi = torch.where(cell >= G - 1.0, big, cell + 1.0)
    lo = torch.where(cell <= 0.0, -big, cell)
    p0 = c0G + s0 * slope_G
    p1 = c0G + s1 * slope_G
    pmin = torch.minimum(p0, p1)[:, None]
    pmax = torch.maximum(p0, p1)[:, None]
    inv = 1.0 / torch.clamp(pmax - pmin, min=1e-9)
    return torch.clamp((torch.minimum(hi[None], pmax)
                        - torch.maximum(lo[None], pmin)) * inv, 0.0, 1.0)


def _dirs(dirp, prm, s) -> torch.Tensor:
    """(Gy, Gx, 3) unit view directions of the voxels through the slab
    plane at camera distance ``s``: s * dir = dirM[:,0] * s + dirp, the
    scale-invariant affine map of params 20:29 (sign(s) folded in)."""
    dw = torch.stack([dirp[a] + prm[20 + 3 * a] * s for a in range(3)], -1)
    return dw * (torch.rsqrt(torch.sum(dw * dw, -1, keepdim=True))
                 * torch.sign(torch.as_tensor(s)))


def _slab_sigma(slab, qs, D: int, sig2: bool) -> torch.Tensor:
    """Dequantized sigma plane of one (Dp, Gy, Gx) f32 slab."""
    if sig2:
        return (slab[D - 1] * 128.0 + slab[D]) * qs[D - 1]
    return slab[D - 1] * qs[D - 1]


def march_slabs_ref(gplanar, qscale, params, zb, wins: Sequence[int],
                    masks: Sequence[int], G: int, gi: int, D: int, bd: int,
                    K: int, flip: bool, y0: int = 0, x0: int = 0):
    """Plain PyTorch version of kernel M: the same function, with the warp
    as dense (gi, Gy) @ (Gy, Gx) @ (Gx, gi) overlap-matrix products as the
    reference builds them (in f32). Inputs as ``march_inputs`` prepares
    them (params (P, 31), zb (P, 4, gi, gi)); returns acc (P, 4, gi, gi).
    The payload's dtype selects the mode, as for the kernel: int8 carries
    the sig2 split with view directions per window (display), bf16 takes
    them per slab (training)."""
    dev = gplanar.device
    Gz, Dp, Gy, Gx = gplanar.shape
    P = params.shape[0]
    sig2 = gplanar.dtype == torch.int8
    slab_dirs = not sig2
    qs = qscale.to(_F32)
    ycell = torch.arange(Gy, dtype=_F32, device=dev) + y0
    xcell = torch.arange(Gx, dtype=_F32, device=dev) + x0
    yc = (ycell + 0.5) * (1.0 / G)
    xc = (xcell + 0.5) * (1.0 / G)
    ray = torch.arange(gi, dtype=_F32, device=dev)
    hG = 0.5 / G
    out = []
    for p in range(P):
        prm = params[p]
        cz, cy, cx = prm[0], prm[1], prm[2]
        u0, du, v0, dv = prm[3], prm[4], prm[5], prm[6]
        sigma_thresh, stop_thresh, zbase = prm[14], prm[15], prm[30]
        ujG = (u0 + du * ray) * G
        vkG = (v0 + dv * ray) * G
        ycm = (yc - cy)[:, None]
        xcm = (xc - cx)[None, :]
        dirp = [prm[21 + 3 * a] * ycm + prm[22 + 3 * a] * xcm
                for a in range(3)]
        zlo, zhi, dtp = zb[p, 0], zb[p, 1], zb[p, 2]
        rgb = torch.zeros((3, gi, gi), dtype=_F32, device=dev)
        T = torch.ones((gi, gi), dtype=_F32, device=dev)
        for w, m in zip(wins, masks):
            if not slab_dirs:
                # view directions once per window, at the window centre
                sc = ((w * K) + 0.5 * K) / G + zbase - cz
                bkq = basis_mod.eval_sh_basis(_dirs(dirp, prm, sc), bd
                                              ) * qs[:bd]     # (Gy,Gx,bd)
            order = range(K - 1, -1, -1) if flip else range(K)
            for dzi in order:
                if not (m >> dzi) & 1:
                    continue
                sid = w * K + dzi
                z = (sid + 0.5) / G + zbase
                s0 = z - hG - cz
                s1 = z + hG - cz
                if slab_dirs:
                    bkq = basis_mod.eval_sh_basis(
                        _dirs(dirp, prm, z - cz), bd) * qs[:bd]
                slab = gplanar[sid].to(_F32)                   # (Dp,Gy,Gx)
                sigma = _slab_sigma(slab, qs, D, sig2)
                sigma = torch.where(sigma > sigma_thresh, sigma, 0.0)
                codes = slab[:3 * bd].reshape(3, bd, Gy, Gx)
                raw = torch.sum(codes * bkq.permute(2, 0, 1)[None], 1)
                chans = torch.cat([sigma[None],
                                   sigma[None] * torch.sigmoid(raw)])
                m_r = _overlap_mat(cy * G, ujG, s0, s1, ycell, G)
                m_c = _overlap_mat(cx * G, vkG, s0, s1, xcell, G)
                warped = m_r @ chans @ m_c.T                    # (4,gi,gi)
                sig_w = warped[0]
                frac = torch.clamp((torch.clamp(zhi, max=z + hG)
                                    - torch.clamp(zlo, min=z - hG)) * G,
                                   0.0, 1.0)
                tau = sig_w * dtp * frac
                att = torch.exp(-tau)
                sig_inv = 1.0 / torch.clamp(sig_w, min=1e-12)
                live = (T >= stop_thresh) & (tau > 0.0)
                wgt = torch.where(live, T * (1.0 - att), 0.0)
                rgb = rgb + (wgt * sig_inv)[None] * warped[1:]
                T = torch.where(live, T * att, T)
        out.append(torch.cat([rgb, T[None]]))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Backward march (training path)
# ---------------------------------------------------------------------------

def march_slabs_bwd(gplanar, params, qscale, zbounds, gacc4, acc4,
                    G: int, gi: int, D: int, bd: int,
                    perm: Tuple[int, int, int],
                    basis_lo: int = 0, basis_hi: int = 24,
                    extra=None, fmt: int = 1,
                    rot: Optional[Tuple[float, ...]] = None,
                    flip: bool = False,
                    k_per_step: Optional[int] = None,
                    bbox_full: bool = False,
                    z_base=None, state_init=None, out_dtype=_F32):
    """Payload cotangent of the training-mode ``march_slabs`` for one pose.

    gplanar: (Gz, D, G, G) channel-planar bf16 payload — the array the
        forward marched. params: (30,) f32 (see _pack_params); qscale:
        (D,) f32; zbounds: (2, gi, gi) f32 per-pixel live z interval.
    gacc4: (4, gi, gi) upstream cotangent [g_r, g_g, g_b, g_T].
    acc4: (4, gi, gi) the forward output [r, g, b, T].
    state_init: optional (2, gi, gi) incoming (T, A) suffix state; None =
        (1, 0), the whole-grid march.
    z_base: the global z of the payload's first slab (z-sharded segments,
        slice D); only None is taken.
    Returns (Gz, D, G, G) in ``out_dtype`` (f32, or bf16 for the lean
    trainer). Marches every slab in forward order (a slab culled from the
    forward has no voxel above the sigma threshold, so its cotangent is
    zero). ``perm``, ``extra`` and ``k_per_step`` mirror the reference's
    signature and are not needed here.
    """
    unsupported = _common_unsupported(D, bd, fmt, rot, basis_lo, basis_hi,
                                      bbox_full)
    if z_base is not None:
        unsupported.append("z-sharded segments (z_base)")
    _later_slices(unsupported)
    if (gplanar.dtype != torch.bfloat16 or gplanar.dim() != 4
            or tuple(gplanar.shape[1:]) != (D, G, G)):
        raise ValueError(f"payload must be (Gz, {D}, {G}, {G}) bf16, got "
                         f"{tuple(gplanar.shape)} {gplanar.dtype}")
    if out_dtype not in (_F32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    dev = gplanar.device
    prm, zb, gacc4, aux = march_bwd_inputs(params, zbounds, gacc4, acc4, G,
                                           gi, state_init)
    qscale = qscale.to(_F32).contiguous()
    if dev.type == "cuda":
        return _march_bwd_cuda(gplanar, prm, qscale, zb, gacc4, aux, G, gi,
                               D, bd, flip, out_dtype)
    if dev.type == "cpu":
        return march_slabs_bwd_ref(gplanar, qscale, prm, zb, gacc4, aux, G,
                                   gi, D, bd, flip, out_dtype)
    raise RuntimeError(f"march_slabs_bwd: no kernel for device {dev}")


march_slabs_bwd.launches = 0


def march_bwd_inputs(params, zbounds, gacc4, acc4, G: int, gi: int,
                     state_init=None):
    """The backward's prepared inputs, shared by its kernel and its plain
    version: params (31,) (z_base 0 appended), zb (4, gi, gi) (_zb_planes),
    gacc4 (4, gi, gi) f32, and aux (4, gi, gi) = [ctot, T_end * g_T, T_in,
    A_in] with ctot = sum_c gacc_c * acc_c and (T_in, A_in) = state_init or
    (1, 0)."""
    dev = gacc4.device
    prm = torch.cat([torch.as_tensor(params, dtype=_F32).reshape(-1)[:30],
                     torch.zeros(1, dtype=_F32, device=dev)]).contiguous()
    zb = _zb_planes(prm[None], zbounds.to(_F32).reshape(1, 2, gi, gi), G,
                    gi)[0].contiguous()
    gacc4 = gacc4.to(_F32).contiguous()
    acc4 = acc4.to(_F32)
    if state_init is None:
        state_init = torch.stack([torch.ones((gi, gi), dtype=_F32, device=dev),
                                  torch.zeros((gi, gi), dtype=_F32,
                                              device=dev)])
    aux = torch.cat([torch.sum(gacc4[:3] * acc4[:3], 0)[None],
                     (gacc4[3] * acc4[3])[None],
                     state_init.to(_F32).reshape(2, gi, gi)]).contiguous()
    return prm, zb, gacc4, aux


def _march_bwd_cuda(gplanar, params, qscale, zb, gacc4, aux, G, gi, D, bd,
                    flip, out_dtype):
    """Launch the backward kernel (its two passes: re-march + scatter, then
    the per-voxel shade adjoint) for one pose."""
    dev = gplanar.device
    Gz = gplanar.shape[0]
    for name, t, shape in (("params", params, (_NP,)), ("qscale", qscale, (D,)),
                           ("zbounds", zb, (4, gi, gi)),
                           ("gacc4", gacc4, (4, gi, gi)),
                           ("aux", aux, (4, gi, gi))):
        if (t.device != dev or t.dtype != _F32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"march_slabs_bwd: {name} must be a contiguous "
                             f"float32 tensor of shape {shape} on {dev}")
    if not gplanar.is_contiguous():
        raise ValueError("march_slabs_bwd: the payload must be contiguous")
    gbuf = torch.zeros((Gz, 4, G, G), dtype=_F32, device=dev)
    out = torch.empty((Gz, D, G, G), dtype=out_dtype, device=dev)
    lib = kernels.lib("slab_march_bwd")
    kernels.check(lib.vt_march_slabs_bwd(
        gplanar.data_ptr(), params.data_ptr(), qscale.data_ptr(),
        zb.data_ptr(), gacc4.data_ptr(), aux.data_ptr(), gbuf.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), Gz, G, gi, bd,
        int(bool(flip)), torch.cuda.current_stream(dev).cuda_stream),
        "slab_march_bwd")
    march_slabs_bwd.launches += 1
    return out


def march_slabs_bwd_ref(gplanar, qscale, params, zb, gacc4, aux, G: int,
                        gi: int, D: int, bd: int, flip: bool,
                        out_dtype=_F32):
    """Plain PyTorch version of the backward kernel: the reference's
    algebra (pallas_slab._make_bwd_kernel) with the forward recompute and
    the transposed warp as dense overlap-matrix products, in f32. Inputs as
    ``march_bwd_inputs`` prepares them: params (31,), zb (4, gi, gi) from
    _zb_planes, aux (4, gi, gi) = [ctot, T_end * g_T, T_in, A_in]."""
    dev = gplanar.device
    Gz = gplanar.shape[0]
    qs = qscale.to(_F32)
    prm = params
    cz, cy, cx = prm[0], prm[1], prm[2]
    u0, du, v0, dv = prm[3], prm[4], prm[5], prm[6]
    sigma_thresh, stop_thresh, zbase = prm[14], prm[15], prm[30]
    cell = torch.arange(G, dtype=_F32, device=dev)
    vc = (cell + 0.5) * (1.0 / G)
    ray = torch.arange(gi, dtype=_F32, device=dev)
    ujG = (u0 + du * ray) * G
    vkG = (v0 + dv * ray) * G
    dirp = [prm[21 + 3 * a] * (vc - cy)[:, None]
            + prm[22 + 3 * a] * (vc - cx)[None, :] for a in range(3)]
    zlo, zhi, dtp = zb[0], zb[1], zb[2]
    g_acc = gacc4[:3]
    ctot, gT = aux[0], aux[1]
    T, A = aux[2].clone(), aux[3].clone()
    qcol = qs[:3 * bd].reshape(3, bd, 1, 1)
    hG = 0.5 / G
    out = torch.zeros((Gz, D, G, G), dtype=out_dtype, device=dev)
    for sid in (range(Gz - 1, -1, -1) if flip else range(Gz)):
        z = (sid + 0.5) / G + zbase
        s0, s1 = z - hG - cz, z + hG - cz
        slab = gplanar[sid].to(_F32)                              # (D,G,G)
        sigma = _slab_sigma(slab, qs, D, False)
        ok = sigma > sigma_thresh
        sigma = torch.where(ok, sigma, 0.0)
        bk = basis_mod.eval_sh_basis(_dirs(dirp, prm, z - cz), bd
                                     ).permute(2, 0, 1)            # (bd,G,G)
        raw = torch.sum(slab[:3 * bd].reshape(3, bd, G, G)
                        * (bk * qs[:bd, None, None])[None], 1)
        rgb = torch.sigmoid(raw)
        chans = torch.cat([sigma[None], sigma[None] * rgb])
        m_r = _overlap_mat(cy * G, ujG, s0, s1, cell, G)
        m_c = _overlap_mat(cx * G, vkG, s0, s1, cell, G)
        warped = m_r @ chans @ m_c.T                               # (4,gi,gi)
        sig_w, srgb_w = warped[0], warped[1:]
        frac = torch.clamp((torch.clamp(zhi, max=z + hG)
                            - torch.clamp(zlo, min=z - hG)) * G, 0.0, 1.0)
        dt = dtp * frac
        tau = sig_w * dt
        att = torch.exp(-tau)
        sig_inv = 1.0 / torch.clamp(sig_w, min=1e-12)
        m = (T >= stop_thresh) & (tau > 0.0)
        w = torch.where(m, T * (1.0 - att), 0.0)
        G_pix = torch.sum(g_acc * srgb_w * sig_inv, 0)
        A = A + w * G_pix
        g_tau = torch.where(m, T * att * G_pix - (ctot - A) - gT, 0.0)
        sum_term = torch.sum(g_acc * w * srgb_w, 0)
        g_sig_w = g_tau * dt - torch.where(sig_w >= 1e-12,
                                           sum_term * sig_inv * sig_inv, 0.0)
        T = torch.where(m, T * att, T)
        gch = torch.cat([g_sig_w[None], g_acc * (w * sig_inv)[None]])
        g_vox = m_r.T @ gch @ m_c                                  # (4,G,G)
        g_sigma = torch.where(ok, g_vox[0] + torch.sum(g_vox[1:] * rgb, 0),
                              0.0)
        g_raw = g_vox[1:] * sigma * rgb * (1.0 - rgb)              # (3,G,G)
        out[sid, D - 1] = (g_sigma * qs[D - 1]).to(out_dtype)
        out[sid, :3 * bd] = (g_raw[:, None] * bk[None] * qcol
                             ).reshape(3 * bd, G, G).to(out_dtype)
    return out
