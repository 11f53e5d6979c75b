"""Differentiable fast path: training through the dense-grid slab renderer
(the counterpart of ``volrend_tpu/ops/slab_grad.py``).

    leaf data (K, D) or pyramid --bake--> dense grid --permute--> slab march
        --finalize + precise warp--> (H, W, 4) --loss

1. **Differentiable bake.** The octree->grid bake broadcasts each leaf row
   into its axis-aligned voxel block. It is built coarse to fine — fill
   each depth's blocks, upsample by N, repeat — from ``expand`` + ``reshape``
   and ``torch.where``, so autograd's transpose is the fine-to-coarse
   sum-pool pyramid. The trainable state is the per-level pyramid
   (``data_to_pyramid``): the bake is then pure dense traffic, and entries
   outside a level's mask get exactly zero gradient, so leaf <-> pyramid
   round trips are exact. On the card the pyramid's bake is one gather
   kernel (``_BakeKernel``, ``csrc/bake_pyramid.cu``) from the level whose
   mask covers each voxel; for the kernel march it also writes each
   voxel's live bit, from which the march's coarse occupancy is reduced.
   Its backward is the chain's transpose written out.
2. **The march**, two backends with one semantics:
   - ``"kernel"``: a ``torch.autograd.Function`` whose forward is kernel M
     in its training mode (the bake's own tensor seen through the pose
     group's permutation, per-slab view directions) and whose backward is
     the backward march kernel (``slab_march.march_slabs_bwd``), which
     re-marches the slabs with the suffix algebra of ``ops/grad.py`` and
     writes the cotangent in the bake's layout;
   - ``"scan"``: the march as plain PyTorch (``_march_fwd_impl``),
     differentiated by autograd (the reference's ``backend="scan"``; its
     custom re-march VJP for the scan, ``_march_diff``, computes the same
     gradient with less memory and is not ported).
   ``backend="auto"`` takes the kernel path wherever the reference would
   take its Pallas kernels; on CPU tensors the kernel wrappers run their
   plain versions.
3. **The screen warp** (``slab_render._warp_to_screen(precise=True)``):
   autograd through the reference quad-gather warp with an f32 table, or,
   with ``display_warp._PRECISE_SQ`` on, the precise superquad warp with
   its hand-written backward for the poses whose window fits (decided on
   the host from the camera and cached per pose, so the step does not
   wait for the device).

Training semantics match the reference: no early-stop renormalization,
smooth alpha = 1 - T_end, early termination at stop_thresh kept as an
epsilon-sized truncation.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from volrend_torch import kernels
from volrend_torch.models.data_format import BasisType
from volrend_torch.ops import basis as basis_mod
from volrend_torch.ops import (display_warp, render_exact, slab_march,
                               slab_render)
from volrend_torch.ops.dense_grid import DenseGrid, full_resolution
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

__all__ = ["BakeMap", "build_bake_map", "bake_from_data",
           "data_to_pyramid", "pyramid_to_data", "bake_from_pyramid",
           "bake_from_pyramid_ref", "live_bits_ref",
           "render_frame_train", "loss_and_grad_frame",
           "render_frame_train_zsharded", "loss_and_grad_frames_sharded",
           "segment_states"]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# Differentiable bake
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BakeMap:
    """Static octree->grid block map, one level per depth.

    rows[j]  : int64 (K_j,) leaf row indices (into the flattened tree data)
               of the leaves with side 1/N^(j+1) (block count B = N^(j+1))
    coords[j]: int64 (K_j,) flat block index (z*B + y)*B + x at that level
    masks[j] : bool (B, B, B, 1) — True at this level's leaf blocks
    """
    rows: Tuple[torch.Tensor, ...]
    coords: Tuple[torch.Tensor, ...]
    masks: Tuple[torch.Tensor, ...] = ()
    G: int = 1
    N: int = 2
    D: int = 4
    sizes: Tuple[int, ...] = ()


def build_bake_map(dev, G: Optional[int] = None,
                   chunk: int = 2 ** 20) -> BakeMap:
    """Enumerate each leaf's (row, block) at its own depth level.

    dev: TreeArrays. G: grid resolution (default: the tree's full
    resolution; must be N**k with every leaf at least one voxel in size).
    The levels' block centres are queried with the exact octree query
    (``render_exact._query``) in chunks of ``chunk`` blocks."""
    if G is None:
        G = full_resolution(dev)
    N = dev.N
    meta = render_exact.tree_meta(dev)
    device = dev.child.device
    levels = []
    covered = 0
    B = N
    while B <= G:
        n = B * B * B
        leaf = torch.empty(n, dtype=torch.int64, device=device)
        size = torch.empty(n, dtype=torch.int64, device=device)
        for c0 in range(0, n, chunk):
            ids = torch.arange(c0, min(n, c0 + chunk), dtype=torch.int32,
                               device=device)
            pos = (torch.stack([torch.div(ids, B * B, rounding_mode="floor"),
                                torch.remainder(torch.div(
                                    ids, B, rounding_mode="floor"), B),
                                torch.remainder(ids, B)], -1).to(_F32)
                   + 0.5) / B
            li, cs, _ = render_exact._query(dev.child, dev.lut, pos, meta)
            leaf[c0:c0 + ids.shape[0]] = li.long()
            size[c0:c0 + ids.shape[0]] = cs.to(torch.int32).long()
        mask = size == B
        coords = torch.nonzero(mask).reshape(-1)
        rows = leaf[coords]
        levels.append((rows, coords, mask.reshape(B, B, B, 1)))
        covered += int(rows.numel()) * (G // B) ** 3
        B *= N
    if covered != G * G * G:
        raise ValueError(
            f"bake map covers {covered} of {G ** 3} voxels: G={G} is finer "
            f"than the tree supports or not a power of N")
    return BakeMap(
        rows=tuple(r for r, _, _ in levels),
        coords=tuple(c for _, c, _ in levels),
        masks=tuple(m for _, _, m in levels),
        G=G, N=N, D=dev.data_dim,
        sizes=tuple(int(r.numel()) for r, _, _ in levels))


def level_map(bmap: BakeMap) -> torch.Tensor:
    """The (G, G, G) uint8 map of the level whose mask covers each voxel:
    what the bake kernel finds by walking the masks (plain version, for
    checks; the kernel stores no map). Raises unless every voxel is
    covered exactly once."""
    G = bmap.G
    dev = bmap.masks[0].device
    lmap = torch.zeros((G, G, G), dtype=torch.uint8, device=dev)
    cover = torch.zeros((G, G, G), dtype=torch.uint8, device=dev)
    for j, m in enumerate(bmap.masks):
        up = _upsample(m, G // m.shape[0])[..., 0]
        lmap.masked_fill_(up, j)
        cover += up
    if not bool(torch.all(cover == 1)):
        raise ValueError("the bake map's levels do not cover every voxel "
                         "exactly once")
    return lmap


def _upsample(g: torch.Tensor, N: int) -> torch.Tensor:
    """(B, B, B, D) -> (B*N, B*N, B*N, D): each block broadcast into its
    N^3 children (autograd's transpose is the N^3 sum-pool)."""
    B, D = g.shape[0], g.shape[-1]
    return g[:, None, :, None, :, None, :].expand(
        B, N, B, N, B, N, D).reshape(B * N, B * N, B * N, D)


def bake_from_data(data, bmap: BakeMap) -> torch.Tensor:
    """Bake leaf payload rows (K, >=D) into the dense (G, G, G, D) grid;
    differentiable w.r.t. ``data``."""
    N, G, D = bmap.N, bmap.G, bmap.D
    data = data[:, :D]
    g = None
    B = 1
    for rows, coords in zip(bmap.rows, bmap.coords):
        Bn = B * N
        if g is None:
            g = torch.zeros((Bn, Bn, Bn, D), dtype=data.dtype,
                            device=data.device)
        else:
            g = _upsample(g, N)
        if rows.numel():
            g = g.reshape(-1, D).index_put((coords,), data[rows]
                                           ).reshape(Bn, Bn, Bn, D)
        B = Bn
    if B != G:
        raise ValueError(f"bake map resolution {B} != G {G}")
    return g


def data_to_pyramid(data, bmap: BakeMap) -> Tuple[torch.Tensor, ...]:
    """(K, >=D) leaf rows -> per-level dense pyramid (set-up/restore
    time). Entries outside each level's mask are zero."""
    D = bmap.D
    data = torch.as_tensor(data)[:, :D]
    pyr = []
    for rows, coords, mask in zip(bmap.rows, bmap.coords, bmap.masks):
        B = mask.shape[0]
        p = torch.zeros((B * B * B, D), dtype=data.dtype, device=data.device)
        if rows.numel():
            p[coords] = data[rows]
        pyr.append(p.reshape(B, B, B, D))
    return tuple(pyr)


def pyramid_to_data(pyr, bmap: BakeMap, K: int,
                    data_dim: Optional[int] = None) -> torch.Tensor:
    """Pyramid -> (K, data_dim) leaf rows (checkpoint/export time). Rows
    not covered by any level (non-leaf rows) come out zero."""
    D = bmap.D
    data = torch.zeros((K, data_dim or D), dtype=pyr[0].dtype,
                       device=pyr[0].device)
    for p, rows, coords in zip(pyr, bmap.rows, bmap.coords):
        if rows.numel():
            data[rows, :D] = p.reshape(-1, D)[coords]
    return data


def bake_from_pyramid(pyr, bmap: BakeMap, live_thresh: Optional[float] = None):
    """Bake the pyramid into the dense (G, G, G, D) grid — no scatters.
    Differentiable w.r.t. every level; the transpose is masked sum-pools
    (entries outside a level's mask get exactly zero gradient).

    With ``live_thresh``, returns ``(bake, live)``: ``live`` the bake's live
    bits at that sigma threshold (``slab_march.LiveBits``), from which
    ``slab_march.march_occupancy`` reduces any view's coarse occupancy.
    On CUDA tensors one kernel writes both (``_BakeKernel``: ``csrc/
    bake_pyramid.cu``, f32 levels); on CPU tensors ``bake_from_pyramid_ref``
    and ``live_bits_ref``."""
    out = _BakeKernel.apply(bmap, live_thresh, *pyr)
    if live_thresh is None:
        return out
    bake, bits = out
    return bake, slab_march.LiveBits(bits, _f32(live_thresh))


def _f32(x: float) -> float:
    return float(np.float32(x))


def bake_from_pyramid_ref(pyr, bmap: BakeMap) -> torch.Tensor:
    """Plain PyTorch version of ``bake_from_pyramid`` (the bake alone):
    coarse to fine, each level's mask over the upsampled coarser bake."""
    N, G = bmap.N, bmap.G
    g = None
    for p, mask in zip(pyr, bmap.masks):
        if g is None:
            g = torch.where(mask, p, torch.zeros((), dtype=p.dtype,
                                                 device=p.device))
        else:
            g = torch.where(mask, p, _upsample(g, N))
    if g.shape[0] != G:
        raise ValueError(f"bake map resolution {g.shape[0]} != G {G}")
    return g


def live_bits_ref(bake, thresh: float):
    """Plain PyTorch version of the bake kernel's live bits: a bit a voxel
    of a (G, G, G, D) bake, set when its sigma (channel D - 1) rounded to
    bf16 is above ``thresh`` (as f32); ``slab_march.LiveBits``."""
    G = bake.shape[0]
    on = bake[..., -1].to(torch.bfloat16).to(_F32) > _f32(thresh)
    nw = -(-G // 32)
    pad = torch.zeros((G, G, nw * 32), dtype=torch.int64, device=bake.device)
    pad[..., :G] = on
    sh = torch.arange(32, dtype=torch.int64, device=bake.device)
    words = torch.sum(pad.reshape(G, G, nw, 32) << sh, -1)
    # the words' low 32 bits as int32 (two's complement)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return slab_march.LiveBits(words.to(torch.int32), _f32(thresh))


#: the data widths the bake kernel takes (bake_pyramid.cu): 3 nb + 1 for
#: nb = 1..25 basis functions or lobes (4 is also RGBA's)
_BAKE_DIMS = tuple(3 * nb + 1 for nb in range(1, 26))


class _BakeKernel(torch.autograd.Function):
    """The pyramid bake with its live bits. Forward: on CUDA tensors one
    launch of ``vt_bake_pyramid`` (a gather from the level whose mask
    covers each voxel; with ``thresh`` it also writes the live bits), on
    CPU tensors
    ``bake_from_pyramid_ref`` and ``live_bits_ref``. Backward: the plain
    version's transpose written out, finest level first: a level's
    gradient is ``where(mask_j, g, 0)`` and the rest, ``where(mask_j, 0,
    g)``, is sum-pooled by N^3 onto the next coarser level (what autograd
    computes through the plain version, op for op; the rest is pooled and
    freed before the level's gradient is made, so one bake-sized tensor
    besides the incoming gradient is alive at a time, where autograd's
    where-backward makes two). Saves no tensor: the masks are the bake
    map's."""

    @staticmethod
    def forward(ctx, bmap, thresh, *pyr):
        ctx.bmap = bmap
        dev = pyr[0].device
        if dev.type == "cpu":
            bake = bake_from_pyramid_ref(pyr, bmap)
            bits = None if thresh is None else live_bits_ref(bake,
                                                             thresh).bits
        elif dev.type == "cuda":
            bake, bits = _bake_cuda(pyr, bmap, thresh)
        else:
            raise RuntimeError(f"bake_from_pyramid: no kernel for device "
                               f"{dev}")
        if bits is None:
            return bake
        ctx.mark_non_differentiable(bits)
        return bake, bits

    @staticmethod
    def backward(ctx, g, *_):
        bmap = ctx.bmap
        N = bmap.N
        grads = [None] * len(bmap.masks)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        for j in range(len(bmap.masks) - 1, -1, -1):
            m = bmap.masks[j]
            if j:  # the rest's pool first: it is freed before the level's
                B = m.shape[0] // N
                pooled = torch.where(m, zero, g).reshape(
                    B, N, B, N, B, N, -1).sum((1, 3, 5))
            grads[j] = torch.where(m, g, zero)
            if j:
                g = pooled
        return (None, None, *grads)


def _bake_cuda(pyr, bmap: BakeMap, thresh):
    """One ``vt_bake_pyramid`` launch: (bake, live bits or None)."""
    G, D = bmap.G, bmap.D
    dev = pyr[0].device
    if D not in _BAKE_DIMS:
        raise ValueError(f"the bake kernel takes D = 3 nb + 1 for nb in "
                         f"1..25, got {D}")
    if len(pyr) != len(bmap.masks):
        raise ValueError(f"{len(pyr)} levels for a bake map of "
                         f"{len(bmap.masks)}")
    sides = []
    for p, m in zip(pyr, bmap.masks):
        B = m.shape[0]
        if (p.dtype != _F32 or p.device != dev or tuple(p.shape) != (
                B, B, B, D) or not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(f"the bake kernel takes contiguous, 16-byte "
                             f"aligned f32 levels (B, B, B, {D}) on {dev}, "
                             f"got {p.dtype} {tuple(p.shape)}")
        if (m.dtype != torch.bool or m.device != dev
                or not m.is_contiguous()):
            raise ValueError(f"the bake map's masks must be contiguous bool "
                             f"tensors on {dev}")
        sides.append(B)
    bake = torch.empty((G, G, G, D), dtype=_F32, device=dev)
    bits = None
    if thresh is not None:
        bits = torch.empty((G, G, -(-G // 32)), dtype=torch.int32,
                           device=dev)
    L = len(sides)
    ptrs = (ctypes.c_void_p * L)(*(p.data_ptr() for p in pyr))
    mptrs = (ctypes.c_void_p * L)(*(m.data_ptr() for m in bmap.masks))
    csides = (ctypes.c_int * L)(*sides)
    kernels.check(kernels.lib("bake_pyramid").vt_bake_pyramid(
        ptrs, mptrs, csides, L, G, D,
        _f32(0.0 if thresh is None else thresh), bake.data_ptr(),
        0 if bits is None else bits.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "bake_pyramid")
    bake_from_pyramid.launches += 1
    return bake, bits


bake_from_pyramid.launches = 0


# ---------------------------------------------------------------------------
# The scan march (plain PyTorch, differentiated by autograd)
# ---------------------------------------------------------------------------

class SlabCfg(NamedTuple):
    """Static march configuration."""
    G: int
    gi: int
    D: int
    bd: int
    fmt: int
    perm: Tuple[int, int, int]
    flip: bool
    ids: Tuple[int, ...]
    opt: RenderOptions


def _boxtap(p0, p1, G: int):
    """Two-tap weights for box-integrating a piecewise-constant field over
    the span [p0, p1] (continuous cell coordinates): value = f * field[c0]
    + (1 - f) * field[c1]. Exact when the span crosses at most one cell
    boundary; out-of-grid span mass clamps to the edge cells."""
    pmin = torch.minimum(p0, p1)
    pmax = torch.maximum(p0, p1)
    c0 = torch.clamp(torch.floor(pmin).long(), 0, G - 1)
    c1 = torch.clamp(c0 + 1, 0, G - 1)
    span = torch.clamp(pmax - pmin, min=1e-9)
    f = torch.clamp((c0.to(pmin.dtype) + 1.0 - pmin) / span, 0.0, 1.0)
    return c0, c1, f


def _slab_pixels(cfg: SlabCfg, slab, extra, gm, zi: int):
    """One slab (G, G, D) -> per-intermediate-pixel (tau_w, rgb_w): shade
    (SH -> sigmoid rgb, sigma mask), box-integration two-tap warp of
    [sigma, sigma*rgb], sigma-weighted emission. Differentiable w.r.t.
    ``slab``."""
    G, D, bd = cfg.G, cfg.D, cfg.bd
    opt = cfg.opt
    perm = cfg.perm
    dev = slab.device
    cy, cx, cz = gm["cy"], gm["cx"], gm["cz"]
    uy, ux = gm["uy"], gm["ux"]
    scale = gm["scale"]
    z = (zi + 0.5) / G
    s = z - cz
    s0 = z - 0.5 / G - cz
    s1 = z + 0.5 / G - cz

    sigma = slab[..., D - 1]
    vox = (torch.arange(G, dtype=_F32, device=dev) + 0.5) / G
    lo, hi = gm["lo"], gm["hi"]
    # voxel-extent bbox intersection (the per-pixel z-intervals clip rays
    # exactly; boundary voxels must stay)
    h = 0.5 / G
    ok = ((vox[:, None] + h > lo[1]) & (vox[:, None] - h < hi[1])
          & (vox[None, :] + h > lo[2]) & (vox[None, :] - h < hi[2])
          & (sigma > opt.sigma_thresh))
    sigma = torch.where(ok, sigma, 0.0)

    if bd < 0:
        rgb = slab[..., :3]
    else:
        dirM = gm["dirM"]
        uvox = (vox - cy) / s
        vvox = (vox - cx) / s
        dvox = (dirM[:, 0][None, None]
                + uvox[:, None, None] * dirM[:, 1][None, None]
                + vvox[None, :, None] * dirM[:, 2][None, None])
        dvox = dvox / torch.linalg.norm(dvox, dim=-1, keepdim=True)
        rot = render_exact._rodrigues_matrix(opt.rot_dirs)
        if rot is not None:
            dvox = dvox @ torch.as_tensor(rot, dtype=_F32, device=dev).T
        bv = basis_mod.eval_basis(BasisType(cfg.fmt), bd, dvox, extra)
        bv = basis_mod.apply_basis_window(bv.to(_F32), opt.basis_minmax)
        coeffs = slab[..., :3 * bd].reshape(G, G, 3, bd)
        rgb = torch.sigmoid(torch.einsum("yxcb,yxb->yxc", coeffs, bv))

    X = torch.cat([sigma[..., None], sigma[..., None] * rgb], -1)
    c0, c1, fr = _boxtap((cy + s0 * uy) * G, (cy + s1 * uy) * G, G)
    Xr = fr[:, None, None] * X[c0] + (1.0 - fr)[:, None, None] * X[c1]
    d0, d1, fc = _boxtap((cx + s0 * ux) * G, (cx + s1 * ux) * G, G)
    Xw = (fc[None, :, None] * Xr[:, d0]
          + (1.0 - fc)[None, :, None] * Xr[:, d1])
    sig_w = Xw[..., 0]
    inv_scale = 1.0 / scale
    sp0, sp1, sp2 = (inv_scale[perm[0]], inv_scale[perm[1]],
                     inv_scale[perm[2]])
    dt_pix = (1.0 / G) * torch.sqrt(
        (uy * sp1)[:, None] ** 2 + (ux * sp2)[None, :] ** 2 + sp0 ** 2)
    tau_w = sig_w * dt_pix
    rgb_w = Xw[..., 1:] / torch.clamp(sig_w, min=1e-12)[..., None]
    return tau_w, rgb_w


def _composite_update(cfg: SlabCfg, zi: int, tau_w, rgb_w, gm, acc, T,
                      done):
    """Shared forward compositing update for one slab. Boundary slabs
    contribute FRACTIONALLY: tau scales by the overlap of the slab's z
    extent with the pixel's exact [z_lo, z_hi] interval."""
    G = cfg.G
    z = (zi + 0.5) / G
    z_lo, z_hi = gm["z_lo"], gm["z_hi"]
    h = 0.5 / G
    frac = torch.clamp((torch.clamp(z_hi, max=z + h)
                        - torch.clamp(z_lo, min=z - h)) * G, 0.0, 1.0)
    tau_f = tau_w * frac
    att = torch.exp(-tau_f)
    m = (~done) & (tau_f > 0.0)
    w = torch.where(m, T * (1.0 - att), 0.0)
    acc = acc + w[..., None] * rgb_w
    T_new = torch.where(m, T * att, T)
    stopped = m & (T_new < cfg.opt.stop_thresh)
    passed = (z - h > z_hi) if not cfg.flip else (z + h < z_lo)
    done = done | stopped | passed
    return acc, T_new, done, m, w, att, frac


def _march_fwd_impl(cfg: SlabCfg, payload, extra, gm):
    """Training-semantics slab march over ``cfg.ids`` in plain PyTorch.
    payload: (G, G, G, D) permuted (slab, row, col). Returns (acc
    (gi, gi, 3), T (gi, gi)); differentiable by autograd."""
    gi = cfg.gi
    dev = payload.device
    acc = torch.zeros((gi, gi, 3), dtype=_F32, device=dev)
    T = torch.ones((gi, gi), dtype=_F32, device=dev)
    done = gm["z_lo"] > gm["z_hi"]
    for zi in cfg.ids:
        tau_w, rgb_w = _slab_pixels(cfg, payload[zi], extra, gm, zi)
        acc, T, done, _, _, _, _ = _composite_update(
            cfg, zi, tau_w, rgb_w, gm, acc, T, done)
    return acc, T


# ---------------------------------------------------------------------------
# The kernel march: kernel M (training mode) forward, backward kernel
# ---------------------------------------------------------------------------

def _kernel_train_ok(cfg: SlabCfg) -> bool:
    """Can the kernels carry training? The reference's ``_pallas_train_ok``
    (an SH/SG/ASG payload of 3*bd + 1 planes or RGBA of 4; no depth). An
    SG/ASG tree of more than 25 lobes passes here, as in the reference, and
    its march raises ValueError (``slab_march.DISPLAY_LOBES``)."""
    if cfg.opt.render_depth:
        return False
    bt = BasisType(cfg.fmt)
    if bt == BasisType.SH:
        return cfg.bd in (1, 4, 9, 16, 25) and cfg.D == 3 * cfg.bd + 1
    if bt in (BasisType.SG, BasisType.ASG):
        return cfg.bd > 0 and cfg.D == 3 * cfg.bd + 1
    if bt == BasisType.RGBA:
        return cfg.bd < 0 and cfg.D == 4
    return False


def _pack_geom_params(geom, cfg: SlabCfg, inv_scale) -> torch.Tensor:
    """The march kernels' (P, 30) params of a FrameGeom."""
    perm = cfg.perm
    return slab_march._pack_params(
        geom.cz, geom.cy, geom.cx, geom.u0, geom.du, geom.v0, geom.dv,
        -1.0 if cfg.flip else 1.0,
        (inv_scale[perm[0]], inv_scale[perm[1]], inv_scale[perm[2]]),
        (inv_scale[0], inv_scale[1], inv_scale[2]),
        float(cfg.opt.sigma_thresh), float(cfg.opt.stop_thresh),
        geom.lo[1], geom.hi[1], geom.lo[2], geom.hi[2],
        geom.dirM, geom.z0_depth)


def _kernel_statics(cfg: SlabCfg):
    blo, bhi = cfg.opt.basis_minmax
    rotm = render_exact._rodrigues_matrix(cfg.opt.rot_dirs)
    rot = (None if rotm is None
           else tuple(float(v) for v in np.asarray(rotm).reshape(-1)))
    return dict(basis_lo=int(blo), basis_hi=int(bhi), rot=rot,
                fmt=cfg.fmt, flip=cfg.flip,
                bbox_full=slab_render._bbox_full(cfg.opt))


def zsegment(planar: torch.Tensor, i: int, Gl: int) -> torch.Tensor:
    """Slabs [i Gl, (i + 1) Gl) of ``planar`` (the bake seen as (G, D, G,
    G) through its permutation) as the kernels take a z-segment: a copy
    with the slab axis outermost (voxel records in (slab, row, column)
    order), seen as (Gl, D, G, G). No copy when it already is one (slabs
    along the bake's first axis)."""
    return planar.narrow(0, i * Gl, Gl).permute(0, 2, 3, 1).contiguous(
        ).permute(0, 3, 1, 2)


class _MarchKernel(torch.autograd.Function):
    """Slab march on the kernels, the counterpart of the reference's
    ``_march_diff_pallas``: forward is kernel M in its training mode,
    backward the backward march kernel, both on ``planar``, the bake seen
    through the pose group's permutation (f32, or bf16 for the lean
    trainer). On the card the kernels read that view itself, rounding f32 to
    bf16 as they stage it (the values of the reference's bf16 planar cast),
    and it is the residual; on the CPU the plain versions run on a
    contiguous bf16 planar copy. The cotangent comes back in the primal's
    dtype and strides, so that the permutation back hands the bake a
    gradient in its own contiguous layout. ``live``: the pyramid bake's
    live bits (``bake_from_pyramid``), from which the kernels' coarse
    occupancy is reduced; without them it reads every voxel's sigma.
    ``extra``: the tree's SG/ASG lobes (``grid.extra``; not trained, as the
    reference stops their gradient).

    With a ``mesh`` whose ``axis_name`` has n > 1 ranks the march is
    z-sharded (the reference's ``_make_zsharded_march``): rank i marches
    slabs [i Gl, (i + 1) Gl), Gl = G / n (``zsegment``, its coarse
    occupancy the whole one's slice), with ``z_base`` = i Gl / G; one
    all-gather of the (4, gi, gi) parts and the front-to-back fold give the
    whole march on every rank. The backward needs no serialization: each
    segment's incoming (T, A) follows from the forward's parts
    (``segment_states``), M-bwd back-marches the local segment from it
    (``state_init``), and one all-gather into a whole-grid tensor hands
    every rank the whole cotangent, so the bake's adjoint and the
    optimizer run unsharded and identical on every rank. This splits the
    march's work, not the memory: every rank holds the whole bake and its
    whole cotangent, as the reference's replicated bake does."""

    @staticmethod
    def forward(ctx, planar, params, zb, cfg, live=None, extra=None,
                mesh=None, axis_name="z"):
        G = cfg.G
        n = 1 if mesh is None else mesh.size(axis_name)
        i = 0 if n == 1 else mesh.get_local_rank(axis_name)
        Gl = G // n
        seg, occ = planar, None
        qs = torch.ones((cfg.D,), dtype=_F32, device=planar.device)
        if planar.device.type == "cpu":
            seg = planar.narrow(0, i * Gl, Gl)
            seg = torch.empty(seg.shape, dtype=torch.bfloat16).copy_(seg)
        else:
            if n > 1:
                seg = zsegment(planar, i, Gl)
            if live is not None:  # one coarse occupancy for both kernels
                # the bits mode checks the threshold on the host: the params
                # carry opt.sigma_thresh in slot 14 (_pack_geom_params)
                thr = torch.full((15,), cfg.opt.sigma_thresh, dtype=_F32)
                occ = slab_march.march_occupancy(
                    planar, thr, qs, live=live,
                    perm=cfg.perm)[i * Gl:(i + 1) * Gl]
            else:
                occ = slab_march.march_occupancy(seg, params, qs)
        ids, z_base = cfg.ids, None
        if n > 1:
            ids = tuple(range(Gl - 1, -1, -1) if cfg.flip else range(Gl))
            z_base = i * (Gl / G)
        acc4 = slab_march.march_slabs(
            seg, params[None], qs, zb[None], G, cfg.gi, cfg.D, cfg.bd,
            cfg.perm, slab_ids=ids, sig2=False, depth=False,
            shade_bf16=False, dir_win=False, occupancy=occ, extra=extra,
            train=True, z_base=z_base, **_kernel_statics(cfg))[0]
        parts, order = acc4[None], (0,)
        if n > 1:
            from volrend_torch.parallel import mesh as mesh_mod
            from volrend_torch.parallel.dist import fold_segments
            parts = mesh_mod.all_gather(acc4, mesh.get_group(axis_name))
            order = tuple(range(n - 1, -1, -1) if cfg.flip else range(n))
            C, T = fold_segments(parts, order, 0)
            acc4 = torch.cat([C, T[None]])
        ctx.save_for_backward(seg, params, zb, acc4, parts)
        ctx.occ, ctx.extra, ctx.cfg = occ, extra, cfg
        ctx.mesh, ctx.axis_name, ctx.i, ctx.z_base = (mesh, axis_name, i,
                                                      z_base)
        ctx.order = order
        ctx.pdtype = planar.dtype
        ctx.pstride = planar.stride()
        return acc4[:3].movedim(0, -1).contiguous(), acc4[3].clone()

    @staticmethod
    def backward(ctx, g_acc, g_T):
        seg, params, zb, acc4, parts = ctx.saved_tensors
        cfg = ctx.cfg
        gi = cfg.gi
        n = parts.shape[0]
        if g_acc is None:
            g_acc = torch.zeros((gi, gi, 3), dtype=_F32, device=acc4.device)
        if g_T is None:
            g_T = torch.zeros((gi, gi), dtype=_F32, device=acc4.device)
        gacc4 = torch.cat([g_acc.to(_F32).movedim(-1, 0),
                           g_T.to(_F32)[None]])
        state = (None if n == 1
                 else segment_states(parts, gacc4, ctx.order)[ctx.i])
        grad = slab_march.march_slabs_bwd(
            seg, params, torch.ones((cfg.D,), dtype=_F32, device=seg.device),
            zb, gacc4, acc4, cfg.G, gi, cfg.D, cfg.bd, cfg.perm,
            out_dtype=ctx.pdtype, occupancy=ctx.occ, extra=ctx.extra,
            z_base=ctx.z_base, state_init=state, **_kernel_statics(cfg))
        if n > 1:
            from volrend_torch.parallel import mesh as mesh_mod
            # the segments' cotangents, slab-major, straight into one
            # whole-grid tensor (rank order is slab order)
            loc = grad.permute(0, 2, 3, 1)
            full = torch.empty((n,) + tuple(loc.shape), dtype=loc.dtype,
                               device=loc.device)
            mesh_mod.all_gather(loc, ctx.mesh.get_group(ctx.axis_name),
                                out=full)
            grad = full.flatten(0, 1).permute(0, 3, 1, 2)
        elif grad.stride() != ctx.pstride:
            grad = torch.empty_strided(grad.shape, ctx.pstride,
                                       dtype=ctx.pdtype,
                                       device=grad.device).copy_(grad)
        return grad, None, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# Frame-level API
# ---------------------------------------------------------------------------

def render_frame_train(data, bmap: BakeMap, grid: DenseGrid, transform,
                       fx, fy, perm: Tuple[int, int, int], flip: bool,
                       width: int, height: int, opt: RenderOptions,
                       gi: int = 512, use_custom_vjp: bool = True,
                       cull: bool = False, backend: str = "auto",
                       grad_bf16: bool = False, mesh=None,
                       axis_name: str = "z") -> torch.Tensor:
    """Differentiable (H, W, 4) render of one pose from leaf ``data``.

    data: (K, >=D) float32 trainable leaf payloads (flattened tree rows),
        OR a pyramid (tuple/list) from ``data_to_pyramid`` — the
        scatter-free grid-space parameterization (the trainer's state).
    grid: DenseGrid for static metadata (scale/offset/extra/occupancy) —
        its baked payload is NOT used; voxels come from ``data`` via
        ``bmap`` so gradients flow to the leaves.
    use_custom_vjp: False takes the scan march (differentiated by
        autograd, O(n_slabs) residual memory; for tests).
    cull: skip slabs empty at *bake* time (default False for training: a
        culled slab can never receive gradient).
    backend: "auto" (the kernels wherever the reference takes its Pallas
        kernels — ``_kernel_train_ok`` — and ``use_custom_vjp`` holds, else
        the scan), "kernel" or "scan". On CPU tensors the kernel wrappers
        run their plain versions.
    grad_bf16: the lean trainer's mode: the bake is cast to bf16 before the
        kernels read it and the backward kernel emits a bf16 cotangent (a
        per-call setting; the reference's is process-global).
    mesh: z-shard the kernel march over this mesh's ``axis_name``
        (``render_frame_train_zsharded``); None marches the whole grid.
    """
    opt = opt.replace(renormalize=False, render_depth=False)
    if cull:
        ids = grid.slab_ids(perm[0], flip, float(opt.sigma_thresh))
    else:
        ids = tuple(range(grid.G - 1, -1, -1) if flip else range(grid.G))
    cfg = SlabCfg(G=grid.G, gi=gi, D=grid.data_dim, bd=grid.basis_dim,
                  fmt=int(grid.fmt), perm=tuple(perm), flip=bool(flip),
                  ids=tuple(ids), opt=opt)
    if backend == "auto":
        backend = ("kernel" if use_custom_vjp and _kernel_train_ok(cfg)
                   else "scan")
    if mesh is not None and (cull or backend != "kernel"
                             or not _kernel_train_ok(cfg)):
        raise ValueError("a z-sharded march takes the fused kernels (a grid "
                         "and options they take, backend 'kernel') and "
                         "every slab (cull=False)")
    live = None
    if isinstance(data, (tuple, list)):
        pyr = tuple(p.to(_F32) for p in data)
        if backend == "kernel":  # the bake writes the march's live bits
            payload, live = bake_from_pyramid(pyr, bmap,
                                              live_thresh=opt.sigma_thresh)
        else:
            payload = bake_from_pyramid(pyr, bmap)
    else:
        payload = bake_from_data(data.to(_F32), bmap)
    geom = slab_render.FrameGeom(grid, transform, fx, fy, perm, flip,
                                 width, height, opt, gi)
    if backend == "kernel":
        pdt = torch.bfloat16 if grad_bf16 else _F32
        planar = payload.to(pdt).permute(perm[0], 3, perm[1], perm[2])
        with torch.no_grad():
            params = _pack_geom_params(geom, cfg, 1.0 / geom.scale)[0]
            zb = torch.stack([geom.z_lo_pix[0], geom.z_hi_pix[0]])
        acc, T = _MarchKernel.apply(planar, params, zb, cfg, live,
                                    grid.extra.detach(), mesh, axis_name)
    elif backend == "scan":
        pperm = payload.permute(*perm, 3)
        gm = dict(cz=geom.cz[0], cy=geom.cy[0], cx=geom.cx[0],
                  uy=geom.uy[0], ux=geom.ux[0],
                  z_lo=geom.z_lo_pix[0], z_hi=geom.z_hi_pix[0],
                  scale=geom.scale, lo=geom.lo, hi=geom.hi,
                  dirM=geom.dirM[0])
        gm = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
              for k, v in gm.items()}
        acc, T = _march_fwd_impl(cfg, pperm, grid.extra, gm)
    else:
        raise ValueError(f"unknown backend {backend!r} "
                         "(auto, kernel or scan)")
    # training finalize: smooth alpha = 1 - T (no renorm, no hard switch)
    inter = torch.cat([acc, (1.0 - T)[..., None]], -1)[None]
    fits = None
    if (display_warp._PRECISE_SQ
            and display_warp.usable_precise(width, height, gi)):
        fits = _precise_fits_host(grid, transform, fx, fy, perm, width,
                                  height, gi)
    return slab_render._warp_to_screen(
        inter, opt, geom.R, geom.fx, geom.fy, width, height, gi, perm,
        geom.u0, geom.du, geom.v0, geom.dv, geom.scale, precise=True,
        fits=fits, ndc=grid.ndc, origin=geom.origin_w.detach())[0]


#: host copies of grids' scale tensors, read back once per tensor (a read
#: from the device waits for all the work queued before it)
_HOST_SCALE = WeakIdKeyDictionary()


def _precise_fits_host(grid: DenseGrid, transform, fx, fy, perm, width: int,
                       height: int, gi: int) -> np.ndarray:
    """The precise warp's per-pose fit predicates, (P,) bool, computed on
    the host from the camera (the same f32 arithmetic as the device
    geometry), so that routing the warp does not wait for the march queued
    before it; cached per camera and tree sidecar (the transform's bytes
    carry the origin, which an NDC tree's warp reads), since training
    revisits its poses (a full-resolution pass costs milliseconds of host
    time)."""
    scale = grid.scale
    if scale.device.type != "cpu":
        if scale not in _HOST_SCALE:
            _HOST_SCALE[scale] = scale.detach().cpu()
        scale = _HOST_SCALE[scale]
    tr = np.ascontiguousarray(slab_render._host(transform).reshape(-1, 3, 4),
                              np.float32)
    sc = np.ascontiguousarray(scale.numpy(), np.float32)
    ndc = None if grid.ndc is None else tuple(float(v) for v in grid.ndc)
    return _fits_from_camera(tr.tobytes(), tr.shape[0],
                             float(slab_render._host(fx)),
                             float(slab_render._host(fy)), tuple(perm),
                             width, height, gi, sc.tobytes(), ndc)


@functools.lru_cache(maxsize=4096)
def _fits_from_camera(tr: bytes, P: int, fx: float, fy: float, perm,
                      width: int, height: int, gi: int, scale: bytes,
                      ndc=None) -> np.ndarray:
    """_precise_fits_host's computation on hashable host values (f32
    transforms, origins included, and scale as bytes; an NDC tree's
    sidecar); returns a read-only array."""
    T = torch.frombuffer(bytearray(tr), dtype=_F32).reshape(P, 3, 4)
    R, origin = T[:, :, :3], T[:, :, 3]
    sc = torch.frombuffer(bytearray(scale), dtype=_F32)
    fx = torch.tensor(fx, dtype=_F32)
    fy = torch.tensor(fy, dtype=_F32)
    u0, du, v0, dv = slab_render._slope_grid(R, fx, fy, sc, perm, width,
                                             height, gi, ndc=ndc,
                                             origin=origin)
    gyf, gxf = display_warp._pixel_slopes(R, fx, fy, width, height, gi, perm,
                                          u0, du, v0, dv, sc, ndc, origin)
    fits = display_warp._level_fits(gyf, gxf, gi, display_warp._PRECISE_B,
                                    display_warp._PRECISE_WIN).numpy()
    fits.flags.writeable = False
    return fits


def loss_and_grad_frame(data, bmap: BakeMap, grid: DenseGrid, transform,
                        fx, fy, perm, flip, width: int, height: int,
                        target, opt: RenderOptions, gi: int = 512,
                        cull: bool = False, grad_bf16: bool = False):
    """Mean-squared RGB pixel loss for one pose and its gradient w.r.t.
    ``data`` (a (K, D) tensor or a pyramid tuple; the gradient has the same
    structure). ``data`` itself is not modified. ``grad_bf16``: see
    ``render_frame_train``."""
    pyramid = isinstance(data, (tuple, list))
    leaves = [d.detach().requires_grad_(True)
              for d in (data if pyramid else [data])]
    with torch.enable_grad():
        out = render_frame_train(
            tuple(leaves) if pyramid else leaves[0], bmap, grid, transform,
            fx, fy, perm, flip, width, height, opt, gi, cull=cull,
            grad_bf16=grad_bf16)
        target = to_device(target, _F32, out.device)
        diff = out[..., :3] - target[..., :3]
        loss = torch.mean(diff * diff)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), (tuple(grads) if pyramid else grads[0])


def loss_and_grad_frames_sharded(data, bmap: BakeMap, grid: DenseGrid,
                                 transforms, fx, fy, perm, flip, width: int,
                                 height: int, targets, opt: RenderOptions,
                                 mesh, gi: int = 512,
                                 axis_name: str = "frames",
                                 grad_bf16: bool = False):
    """Data parallelism over poses: each rank takes its block of the pose
    batch through the training frame's backward, summing its gradients,
    then ONE all-reduce sums (loss, grads) over the mesh axis — the
    frame-level analog of ``parallel.dist.loss_and_grad_sharded``.

    data: a pyramid (the trainer's state) or (K, D) rows, the same on every
    rank; transforms (F, 3, 4) and targets (F, H, W, >=3): the whole batch
    (arrays or tensors), F divisible by the axis's size; all poses share
    (perm, flip). The loss is the mean squared RGB error over the whole
    batch. Returns (loss 0-d tensor, grads like ``data``), the same on
    every rank."""
    from volrend_torch.parallel import mesh as mesh_mod
    pyramid = isinstance(data, (tuple, list))
    leaves = [d.detach().requires_grad_(True)
              for d in (data if pyramid else [data])]
    dev = leaves[0].device
    trs = to_device(transforms, _F32, dev).reshape(-1, 3, 4)
    n_total = trs.shape[0]
    lo, hi = mesh_mod.shard_range(n_total, mesh.size(axis_name),
                                  mesh.get_local_rank(axis_name))
    norm = 3.0 * width * height * n_total
    g_sum = [torch.zeros_like(x, dtype=_F32) for x in leaves]
    loss_sum = torch.zeros((), dtype=_F32, device=dev)
    for f in range(lo, hi):
        with torch.enable_grad():
            out = render_frame_train(
                tuple(leaves) if pyramid else leaves[0], bmap, grid,
                trs[f], fx, fy, perm, flip, width, height, opt, gi,
                grad_bf16=grad_bf16)
            tgt = to_device(targets[f], _F32, out.device)
            diff = out[..., :3] - tgt[..., :3]
            loss = torch.sum(diff * diff) / norm
            grads = torch.autograd.grad(loss, leaves)
        loss_sum += loss.detach()
        for a, g in zip(g_sum, grads):
            a += g
        del grads
    buf = torch.cat([loss_sum.reshape(1)] + [g.reshape(-1) for g in g_sum])
    del g_sum
    mesh_mod.all_reduce(buf, mesh.get_group(axis_name))
    out, at = [], 1
    for x in leaves:
        out.append(buf[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return buf[0], (tuple(out) if pyramid else out[0])


# ---------------------------------------------------------------------------
# The z-sharded training march (both kernels on z-segments)
# ---------------------------------------------------------------------------

def _inverse(q):
    inv = [0] * len(q)
    for k, a in enumerate(q):
        inv[a] = k
    return tuple(inv)


def segment_states(parts: torch.Tensor, gacc4: torch.Tensor, order
                   ) -> torch.Tensor:
    """Each segment's incoming (T_in, A_in) of the backward, from the
    forward's parts (n, 4, gi, gi) and the cotangent gacc4 (4, gi, gi):
    T_in_d = the product of the upstream segments' T, A_in_d = the sum over
    upstream d' of T_in_d' B_d' with B_d' = sum_c gacc_c C_d'_c (a
    segment's sum of w G_pix is its colour times the cotangent). ``order``:
    the segments in march order. Returns (n, 2, gi, gi)."""
    n = parts.shape[0]
    states = [None] * n
    Tc = torch.ones_like(parts[0, 3])
    Ac = torch.zeros_like(parts[0, 3])
    for d in order:
        states[d] = torch.stack([Tc, Ac])
        Ac = Ac + Tc * torch.sum(gacc4[:3] * parts[d, :3], 0)
        Tc = Tc * parts[d, 3]
    return torch.stack(states)


def render_frame_train_zsharded(data, bmap: BakeMap, grid: DenseGrid,
                                transform, fx, fy,
                                perm: Tuple[int, int, int], flip: bool,
                                width: int, height: int, opt: RenderOptions,
                                mesh, gi: int = 512, axis_name: str = "z",
                                grad_bf16: bool = False) -> torch.Tensor:
    """``render_frame_train`` with the march (kernel M's training mode and
    M-bwd) z-sharded over ``mesh`` (``_MarchKernel`` with a mesh): the
    march's work splits over the ranks; each holds the whole bake and its
    cotangent. Segment semantics apply (stop_thresh = 0; training renders
    already run renormalize=False). Every rank passes the same ``data``
    and pose and gets the same (H, W, 4) frame, and a backward through it
    the same whole gradient. Raises ValueError when the axis's size does
    not divide G, or the kernels do not take the grid."""
    n = mesh.size(axis_name)
    if grid.G % n:
        raise ValueError(f"G={grid.G} not divisible by mesh axis {n}")
    return render_frame_train(
        data, bmap, grid, transform, fx, fy, perm, flip, width, height,
        opt.replace(stop_thresh=0.0), gi, backend="kernel",
        grad_bf16=grad_bf16, mesh=mesh, axis_name=axis_name)
