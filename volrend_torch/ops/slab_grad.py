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
   round trips are exact.
2. **The march**, two backends with one semantics:
   - ``"kernel"``: a ``torch.autograd.Function`` whose forward is kernel M
     in its training mode (bf16 payload, per-slab view directions) and
     whose backward is the backward march kernel (``slab_march.
     march_slabs_bwd``), which re-marches the slabs with the suffix
     algebra of ``ops/grad.py``;
   - ``"scan"``: the march as plain PyTorch (``_march_fwd_impl``),
     differentiated by autograd (the reference's ``backend="scan"``; its
     custom re-march VJP for the scan, ``_march_diff``, computes the same
     gradient with less memory and is not ported).
   ``backend="auto"`` takes the kernel path wherever the reference would
   take its Pallas kernels; on CPU tensors the kernel wrappers run their
   plain versions.

Training semantics match the reference: no early-stop renormalization,
smooth alpha = 1 - T_end, early termination at stop_thresh kept as an
epsilon-sized truncation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.ops import basis as basis_mod
from volrend_torch.ops import render_exact, slab_march, slab_render
from volrend_torch.ops.dense_grid import DenseGrid, full_resolution
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

__all__ = ["BakeMap", "build_bake_map", "bake_from_data",
           "data_to_pyramid", "pyramid_to_data", "bake_from_pyramid",
           "render_frame_train", "loss_and_grad_frame",
           "render_frame_train_zsharded"]

_F32 = torch.float32
_SLICE_D = "slice D of the port (ROADMAP.md item 20)"


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


def bake_from_pyramid(pyr, bmap: BakeMap) -> torch.Tensor:
    """Bake the pyramid into the dense (G, G, G, D) grid — no scatters.
    Differentiable w.r.t. every level; the transpose is masked sum-pools
    (entries outside a level's mask get exactly zero gradient)."""
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
    (an SH/SG/ASG payload of 3*bd + 1 planes or RGBA of 4; no depth).
    Options the port's kernel M does not take yet raise in its wrapper,
    naming their slice."""
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


class _MarchKernel(torch.autograd.Function):
    """Slab march on the kernels, the counterpart of the reference's
    ``_march_diff_pallas``: forward is kernel M in its training mode on the
    payload cast to bf16 at the kernel boundary; backward is the backward
    march kernel on that same bf16 payload (saved as the residual: the
    recompute then sees identical values). The cotangent comes back in the
    primal's dtype: f32, or bf16 when the caller marches a bf16 planar
    (the lean trainer)."""

    @staticmethod
    def forward(ctx, planar, params, zb, cfg):
        # one pass from the permuted view to a contiguous bf16 copy (no f32
        # planar copy is materialized)
        p16 = torch.empty(planar.shape, dtype=torch.bfloat16,
                          device=planar.device).copy_(planar)
        qs = torch.ones((cfg.D,), dtype=_F32, device=planar.device)
        acc4 = slab_march.march_slabs(
            p16, params[None], qs, zb[None], cfg.G, cfg.gi, cfg.D, cfg.bd,
            cfg.perm, slab_ids=cfg.ids, sig2=False, depth=False,
            shade_bf16=False, dir_win=False, **_kernel_statics(cfg))[0]
        ctx.save_for_backward(p16, params, zb, acc4)
        ctx.cfg = cfg
        ctx.pdtype = planar.dtype
        return acc4[:3].movedim(0, -1).contiguous(), acc4[3].clone()

    @staticmethod
    def backward(ctx, g_acc, g_T):
        p16, params, zb, acc4 = ctx.saved_tensors
        cfg = ctx.cfg
        gi = cfg.gi
        if g_acc is None:
            g_acc = torch.zeros((gi, gi, 3), dtype=_F32, device=acc4.device)
        if g_T is None:
            g_T = torch.zeros((gi, gi), dtype=_F32, device=acc4.device)
        gacc4 = torch.cat([g_acc.to(_F32).movedim(-1, 0),
                           g_T.to(_F32)[None]])
        grad = slab_march.march_slabs_bwd(
            p16, params, torch.ones((cfg.D,), dtype=_F32,
                                    device=p16.device),
            zb, gacc4, acc4, cfg.G, gi, cfg.D, cfg.bd, cfg.perm,
            out_dtype=ctx.pdtype, **_kernel_statics(cfg))
        return grad.to(ctx.pdtype), None, None, None


# ---------------------------------------------------------------------------
# Frame-level API
# ---------------------------------------------------------------------------

def render_frame_train(data, bmap: BakeMap, grid: DenseGrid, transform,
                       fx, fy, perm: Tuple[int, int, int], flip: bool,
                       width: int, height: int, opt: RenderOptions,
                       gi: int = 512, use_custom_vjp: bool = True,
                       cull: bool = False, backend: str = "auto",
                       grad_bf16: bool = False) -> torch.Tensor:
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
    grad_bf16: the lean trainer's mode: the payload is cast to bf16 before
        the planar transpose and the backward kernel emits a bf16
        cotangent (a per-call setting; the reference's is process-global).
    """
    opt = opt.replace(renormalize=False, render_depth=False)
    if isinstance(data, (tuple, list)):
        payload = bake_from_pyramid(tuple(p.to(_F32) for p in data), bmap)
    else:
        payload = bake_from_data(data.to(_F32), bmap)
    geom = slab_render.FrameGeom(grid, transform, fx, fy, perm, flip,
                                 width, height, opt, gi)
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
    if backend == "kernel":
        pdt = torch.bfloat16 if grad_bf16 else _F32
        planar = payload.to(pdt).permute(perm[0], 3, perm[1], perm[2])
        with torch.no_grad():
            params = _pack_geom_params(geom, cfg, 1.0 / geom.scale)[0]
            zb = torch.stack([geom.z_lo_pix[0], geom.z_hi_pix[0]])
        acc, T = _MarchKernel.apply(planar, params, zb, cfg)
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
    return slab_render._warp_to_screen(
        inter, opt, geom.R, geom.fx, geom.fy, width, height, gi, perm,
        geom.u0, geom.du, geom.v0, geom.dv, geom.scale, precise=True)[0]


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


def loss_and_grad_frames_sharded(*args, **kw):
    """DP over poses with one all-reduce (the reference's shard_map form)
    comes with the parallel layer."""
    raise NotImplementedError(f"sharded frame training comes with {_SLICE_D}")


def render_frame_train_zsharded(*args, **kw):
    """The z-sharded training march (both kernels on z-segments) comes with
    the parallel layer."""
    raise NotImplementedError(
        f"z-sharded training renders come with {_SLICE_D}")
