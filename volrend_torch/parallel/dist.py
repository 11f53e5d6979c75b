"""Distributed rendering and training on ``torch.distributed`` (the
counterpart of ``volrend_tpu/parallel/dist.py``).

The reference lifts the renderer onto a ``jax.sharding.Mesh`` with
``shard_map``; the port runs one process a rank over a ``mesh.Mesh``, every
rank making the same call:

- data parallelism over rays (the "rays" axis): the tree is replicated,
  each rank renders its block of rays, and a sharded result is gathered to
  every rank; a training step's gradients are summed by one all-reduce;
- context parallelism over the march's t-range (``render_rays_cp``) and
  over the slab grid's z axis (``render_frame_slab_zsharded``): each rank
  integrates its own segment and the segments fold front to back with the
  associative rule (C, T) o (C', T') = (C + T C', T T');
- several scenes on a 2-D ("scene", "rays") mesh (``render_scenes_sharded``).

Conventions (the reference's names and signatures, the mesh passed
explicitly): every rank passes the same whole host arrays the reference's
caller passes, except where the reference's caller passes arrays already
sharded (``shard_rays``' output: this rank's block). A replicated result
comes back whole on every rank; a sharded one comes back gathered to every
rank, so one rank's result compares directly with the reference's. Every
entry point runs on the mesh's device (the card unless the mesh was made
on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from volrend_torch.models.n3tree import TreeArrays
from volrend_torch.ops import grad as grad_mod
from volrend_torch.ops import render_exact
from volrend_torch.parallel.mesh import (Mesh, all_gather, all_reduce,
                                         make_mesh, shard_range)
from volrend_torch.utils.device import to_device
from volrend_torch.utils.options import RenderOptions

__all__ = [
    "make_mesh", "replicate_tree", "shard_rays", "render_rays_sharded",
    "render_image_sharded", "loss_and_grad_sharded", "pad_to_multiple",
    "render_rays_cp", "render_frame_slab_zsharded",
    "render_frames_slab_zsharded", "stack_trees", "render_scenes_sharded",
    "fold_segments",
]

_F32 = torch.float32
_TREE_TENSORS = ("child", "data", "offset", "scale", "extra", "lut")


def replicate_tree(tree: TreeArrays, mesh: Mesh) -> TreeArrays:
    """The tree on the mesh's device: one whole copy a rank, like the
    reference's replicated placement (its per-GPU upload)."""
    return dataclasses.replace(tree, **{
        k: getattr(tree, k).to(mesh.device) for k in _TREE_TENSORS})


def pad_to_multiple(arr: np.ndarray, m: int, axis: int = 0):
    """Pad ``axis`` up to a multiple of m with zeros; returns (padded,
    original_len)."""
    n = arr.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths), n


def _block(arr: np.ndarray, mesh: Mesh, axis_name: str) -> np.ndarray:
    """This rank's block of rows of ``arr`` (padded to the axis's size)."""
    n = mesh.size(axis_name)
    arr, _ = pad_to_multiple(np.asarray(arr), n)
    lo, hi = shard_range(arr.shape[0], n, mesh.get_local_rank(axis_name))
    return arr[lo:hi]


def shard_rays(origins, dirs, mesh: Mesh, axis_name: str = "rays"):
    """Pad the whole ray batch to a multiple of the axis's size and take
    this rank's block onto the mesh's device. Returns (origins, dirs,
    n_valid): the block's f32 tensors and the whole batch's true length."""
    n_valid = np.asarray(origins).shape[0]
    return (to_device(_block(origins, mesh, axis_name), _F32, mesh.device),
            to_device(_block(dirs, mesh, axis_name), _F32, mesh.device),
            n_valid)


def _gather_rows(t: torch.Tensor, mesh: Mesh, axis_name: str):
    """Every rank's block of rows, concatenated in mesh order."""
    g = all_gather(t, mesh.get_group(axis_name))
    return g.reshape((-1,) + tuple(t.shape[1:]))


def render_rays_sharded(tree: TreeArrays, origins, dirs, opt: RenderOptions,
                        mesh: Mesh, axis_name: str = "rays") -> torch.Tensor:
    """Forward render with rays sharded over the mesh: this rank renders
    its block (``shard_rays``' output) and the (R_padded, 4) RGBA of every
    rank's block comes back to every rank (one all-gather; the reference
    returns it sharded, with zero collectives)."""
    out = render_exact.render_rays(tree, origins, dirs, opt)
    return _gather_rows(out, mesh, axis_name)


def render_image_sharded(tree: TreeArrays, cam, opt: RenderOptions,
                         mesh: Mesh, axis_name: str = "rays"
                         ) -> torch.Tensor:
    """Full-frame render sharded over the mesh; returns (H, W, 4) on every
    rank."""
    origins, dirs = cam.pixel_rays(xp=np)
    o, d, n = shard_rays(origins, dirs, mesh, axis_name)
    out = render_rays_sharded(tree, o, d, opt, mesh, axis_name)
    return out[:n].reshape(cam.height, cam.width, 4)


def fold_segments(parts: torch.Tensor, order: Sequence[int], dim: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold segments' [C (3 channels), T] front to back: (C, T) o (C', T')
    = (C + T C', T T'). parts: (n, ...) with the 4 channels on ``dim`` of
    each segment; ``order``: the segments' indices in march order.
    Returns (C, T), T without the channel dim."""
    C = T = None
    for j in order:
        c, t = parts[j].narrow(dim, 0, 3), parts[j].select(dim, 3)
        if C is None:
            C, T = c, t
        else:
            C = C + T.unsqueeze(dim) * c
            T = T * t
    return C, T


def render_rays_cp(tree: TreeArrays, origins, dirs, opt: RenderOptions,
                   mesh: Mesh, axis_name: str = "rays") -> torch.Tensor:
    """Context-parallel compositing: the march's t-range is split into one
    segment a rank. Rays are replicated (every rank passes the whole batch);
    each rank integrates its own t-segment, and the segments fold front to
    back (one all-gather). Per-segment early termination is disabled (a
    segment cannot know its incoming transmittance), so this runs the
    training semantics (stop_thresh=0, no renorm). Returns (R, 4) RGBA on
    every rank."""
    from volrend_torch.ops.render_exact import (_dda_world, _march,
                                                _precalc_basis, prepare_rays,
                                                tree_meta)
    seg_opt = opt.replace(stop_thresh=0.0, renormalize=False)
    n = mesh.size(axis_name)
    i = mesh.get_local_rank(axis_name)
    dev = mesh.device
    o = to_device(origins, _F32, dev)
    d = to_device(dirs, _F32, dev)
    cen, dd, vdir, invdir, delta_scale = prepare_rays(tree, o, d, seg_opt)
    basis_vals = _precalc_basis(tree, vdir, seg_opt)
    tmin, tmax = _dda_world(cen, invdir, seg_opt.render_bbox)
    fi = float(i)
    span = (tmax - tmin) / n
    lo = tmin + fi * span
    last = i == n - 1
    hi = tmax if last else tmin + (fi + 1.0) * span
    # interior boundaries clamp dt so optical depth is not counted twice;
    # the last segment overshoots like the reference's tail
    rgb, alpha = _march(tree.data, tree.child, tree.lut, tree_meta(tree),
                        seg_opt, cen, dd, invdir, delta_scale, basis_vals,
                        lo, hi, differentiable=False, train=True,
                        dt_clamp=None if last else hi)
    seg = torch.cat([rgb, (1.0 - alpha)[:, None]], -1)
    parts = all_gather(seg, mesh.get_group(axis_name))         # (n, R, 4)
    C, T = fold_segments(parts, range(n), -1)
    rgb_out = C + float(seg_opt.background_brightness) * T[:, None]
    return torch.cat([rgb_out, (1.0 - T)[:, None]], -1)


# ---------------------------------------------------------------------------
# The slab path on z-segments
# ---------------------------------------------------------------------------

def _check_segments(G: int, n: int, dir_win: bool) -> int:
    """The segment length Gl = G / n; raises ValueError unless n divides G
    and, with window shading directions, Gl holds whole K-slab windows (a
    window's direction is taken at its centre: only whole windows give each
    slab the direction the whole-grid march gives it)."""
    from volrend_torch.ops import slab_march
    if G % n:
        raise ValueError(f"G={G} not divisible by mesh axis {n}")
    Gl = G // n
    K = slab_march._march_k(G, slab_march._K_STEP)
    if dir_win and Gl % K:
        raise ValueError(
            f"a z-segment of {Gl} slabs does not hold whole {K}-slab "
            f"windows, whose shading direction the whole grid shares; use "
            f"a mesh axis whose segments are multiples of {K} slabs (or "
            f"per-slab directions, slab_march._DIR_WIN = False)")
    return Gl


def _zsegment(grid, perm, Gl: int, i: int) -> torch.Tensor:
    """Segment i of the display payload: slabs [i Gl, (i + 1) Gl) along
    perm[0], channel-planar and slab-major (z, Dp, y, x), made from this
    segment of the bake alone (the f16 bake's cast to bf16)."""
    seg = grid.data.narrow(perm[0], i * Gl, Gl).permute(perm[0], 3, perm[1],
                                                        perm[2])
    if not grid.quantized:
        return seg.to(torch.bfloat16, memory_format=torch.contiguous_format)
    return seg.contiguous()


def _frames_zsharded(grid, transforms, fx, fy, perm, flip, width: int,
                     height: int, opt: RenderOptions, mesh: Mesh, gi: int,
                     axis_name: str) -> torch.Tensor:
    """A pose batch of one (perm, flip) group through the z-sharded march
    (one kernel M launch a rank, one all-gather of the (P, 4, gi, gi)
    parts, the fold, then the display warp); (P, H, W, 4) on every rank."""
    from volrend_torch.ops import display_warp, slab_march, slab_render
    seg_opt = opt.replace(stop_thresh=0.0, renormalize=False)
    slab_render._kernel_ok(grid)
    if grid.device != mesh.device:
        raise ValueError(f"the grid lies on {grid.device}, the mesh's ranks "
                         f"on {mesh.device}")
    n = mesh.size(axis_name)
    i = mesh.get_local_rank(axis_name)
    G = grid.G
    Gl = _check_segments(G, n, slab_march._DIR_WIN)
    g = slab_render.FrameGeom(grid, transforms, fx, fy, perm, flip, width,
                              height, seg_opt, gi)
    fits = None
    if display_warp.usable(width, height, gi):
        fits = display_warp.plan_fits(g.R, g.fx, g.fy, width, height, gi,
                                      perm, g.u0, g.du, g.v0, g.dv, g.scale,
                                      ndc=grid.ndc, origin=g.origin_w)
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip,
                                                 seg_opt)
    blo, bhi = seg_opt.basis_minmax
    rotm = render_exact._rodrigues_matrix(seg_opt.rot_dirs)
    acc4 = slab_march.march_slabs(
        _zsegment(grid, perm, Gl, i), params, grid.qscale, zb, G, gi,
        grid.data_dim, grid.basis_dim, perm,
        slab_ids=tuple(range(Gl - 1, -1, -1) if flip else range(Gl)),
        basis_lo=int(blo), basis_hi=int(bhi), sig2=grid.quantized,
        extra=grid.extra, fmt=int(grid.fmt),
        depth=bool(seg_opt.render_depth),
        rot=(None if rotm is None
             else tuple(float(v) for v in rotm.reshape(-1))),
        flip=flip, bbox_full=slab_render._bbox_full(seg_opt),
        dir_win=slab_march._DIR_WIN, k_per_step=slab_march._K_STEP,
        z_base=i * (Gl / G))
    parts = all_gather(acc4, mesh.get_group(axis_name))  # (n, P, 4, gi, gi)
    C, T = fold_segments(parts, range(n - 1, -1, -1) if flip else range(n),
                         1)
    acc = torch.cat([C, T[:, None]], 1)
    return slab_render._warp_to_screen(
        slab_render._finalize_planar(acc, seg_opt), seg_opt, g.R, g.fx,
        g.fy, width, height, gi, perm, g.u0, g.du, g.v0, g.dv, grid.scale,
        planar=True, fits=fits, ndc=grid.ndc, origin=g.origin_w)


def render_frame_slab_zsharded(grid, transform, fx, fy, width: int,
                               height: int, opt: RenderOptions, mesh: Mesh,
                               gi: int = 512, axis_name: str = "z"
                               ) -> torch.Tensor:
    """The slab path with its payload z-sharded over the mesh: each rank
    builds and marches its own z-segment (1/n of the volume) through kernel
    M (``z_base`` = its global z), the (4, gi, gi) parts are gathered and
    fold front to back in the order the flip gives, then the display warp
    (kernel W and the cascade). Segment semantics: stop_thresh = 0, no
    renormalization (the per-pixel z intervals still skip what no ray
    meets). Raises ValueError for a pose the slab path does not take, a G
    the axis does not divide, or segments that split shading windows.
    Returns the (H, W, 4) frame on every rank."""
    from volrend_torch.ops import slab_render
    transform = np.asarray(transform, np.float32).reshape(3, 4)
    perm, flip, slope = slab_render.choose_axis(grid, transform, fx, fy,
                                                width, height)
    if not (np.isfinite(slope) and slope < slab_render.MAX_SLAB_SLOPE):
        raise ValueError("pose not renderable by the slab path")
    return _frames_zsharded(grid, transform[None], fx, fy, perm, flip, width,
                            height, opt, mesh, gi, axis_name)[0]


def render_frames_slab_zsharded(grid, transforms, fx, fy, width: int,
                                height: int, opt: RenderOptions, mesh: Mesh,
                                gi: int = 512, axis_name: str = "z"
                                ) -> torch.Tensor:
    """Batched ``render_frame_slab_zsharded``: all poses must share one
    (perm, flip) group (split them by ``slab_render.choose_axis`` first);
    each rank's segment is built once and every pose marches in one launch.
    Returns (N, H, W, 4) on every rank."""
    from volrend_torch.ops import slab_render
    transforms = np.asarray(transforms, np.float32).reshape(-1, 3, 4)
    keys = {slab_render.choose_axis(grid, t, fx, fy, width, height)[:2]
            for t in transforms}
    if len(keys) != 1:
        raise ValueError(f"poses span {len(keys)} (perm, flip) groups; "
                         "split them first")
    (perm, flip), = keys
    return _frames_zsharded(grid, transforms, fx, fy, perm, flip, width,
                            height, opt, mesh, gi, axis_name)


# ---------------------------------------------------------------------------
# Several scenes on a 2-D mesh
# ---------------------------------------------------------------------------

def stack_trees(trees) -> TreeArrays:
    """Stack scenes into one leading-axis TreeArrays for multi-scene
    sharding. Trees must share meta (N, data_dim, format, depths);
    capacities are padded to the largest."""
    metas = {(t.N, t.data_dim, t.basis_dim, int(t.fmt), t.max_depth,
              t.lut_depth) for t in trees}
    if len(metas) != 1:
        raise ValueError("scenes must share tree meta to stack")
    kmax = max(t.child.shape[0] for t in trees)

    def padded(t, name):
        x = getattr(t, name)
        pad = kmax - x.shape[0]
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return dataclasses.replace(trees[0], **{
        k: torch.stack([padded(t, k) if k in ("child", "data")
                        else getattr(t, k) for t in trees])
        for k in _TREE_TENSORS})


def _scene(stacked: TreeArrays, s: int) -> TreeArrays:
    return dataclasses.replace(stacked, **{
        k: getattr(stacked, k)[s] for k in _TREE_TENSORS})


def render_scenes_sharded(stacked: TreeArrays, origins, dirs,
                          opt: RenderOptions, mesh: Mesh) -> torch.Tensor:
    """Render S scenes' ray batches on a 2-D ("scene", "rays") mesh: each
    scene group renders S / mesh.size("scene") scenes and splits their rays
    over the "rays" axis. origins/dirs: the whole (S, R, 3) batches; S must
    be a multiple of the "scene" axis's size and R of the "rays" axis's.
    Returns (S, R, 4) on every rank."""
    origins = np.asarray(origins)
    S, R = origins.shape[:2]
    n_scene, n_rays = mesh.size("scene"), mesh.size("rays")
    if S % n_scene:
        raise ValueError(
            f"{S} scenes do not tile the 'scene' axis ({n_scene} groups); "
            f"pad the batch or reshape the mesh")
    if R % n_rays:
        raise ValueError(
            f"ray count {R} not divisible by the 'rays' axis ({n_rays}); "
            f"pad with dist.pad_to_multiple")
    if stacked.child.shape[0] != S:
        raise ValueError(
            f"stacked tree holds {stacked.child.shape[0]} scenes but "
            f"{S} ray batches were given")
    s0, s1 = shard_range(S, n_scene, mesh.get_local_rank("scene"))
    r0, r1 = shard_range(R, n_rays, mesh.get_local_rank("rays"))
    dirs = np.asarray(dirs)
    outs = [render_exact.render_rays(
        _scene(stacked, s), to_device(origins[s, r0:r1], _F32, mesh.device),
        to_device(dirs[s, r0:r1], _F32, mesh.device), opt)
        for s in range(s0, s1)]
    out = torch.stack(outs)                                  # (Sl, Rl, 4)
    rows = all_gather(out, mesh.get_group("rays"))       # (nr, Sl, Rl, 4)
    out = rows.permute(1, 0, 2, 3).reshape(s1 - s0, R, 4)
    return all_gather(out, mesh.get_group("scene")).reshape(S, R, 4)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def loss_and_grad_sharded(tree: TreeArrays, data, origins, dirs, target,
                          opt: RenderOptions, mesh: Mesh,
                          axis_name: str = "rays"):
    """Sharded training step core: the mean-squared RGB pixel loss and its
    per-leaf gradients. data: the (K, data_dim) f32 master copy, the same
    on every rank; origins/dirs/target: this rank's block of the padded
    batch (``shard_rays``). Each rank takes the fused backward
    (``ops/grad.py``) of its block's sum, normalized by the global ray
    count, and one all-reduce sums (loss, grad). Returns (loss 0-d tensor,
    grad (K, data_dim) f32), the same on every rank."""
    n_total = int(origins.shape[0]) * mesh.size(axis_name)
    dat = data.detach().requires_grad_(True)
    with torch.enable_grad():
        out = grad_mod.render_rays_train(tree, origins, dirs, opt, data=dat)
        tgt = to_device(target, _F32, out.device)
        diff = out[:, :3] - tgt[:, :3]
        loss = torch.sum(diff * diff) / (3.0 * n_total)
        (g,) = torch.autograd.grad(loss, dat)
    buf = torch.cat([loss.detach().reshape(1), g.to(_F32).reshape(-1)])
    all_reduce(buf, mesh.get_group(axis_name))
    return buf[0], buf[1:].reshape(g.shape)
