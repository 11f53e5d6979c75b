"""The exact octree renderer in plain PyTorch (the counterpart of
``volrend_tpu/ops/render_jax.py``).

One semantics — the reference's per-ray octree march (``rt_core.cuh:66-196``)
— executed as a flat ray batch: every step processes all rays, the octree
query is a batched level-synchronous descent or one gather into the dense
leaf-pointer LUT (``models/n3tree.py:build_lut``), and the march is a Python
loop that exits once no ray is active. The dense bake (``dense_grid``) uses
its query; the display path's quality gate compares against its frames.

Training (T2): ``render_rays(..., differentiable=True)`` runs a fixed-length
loop of ``n_steps`` that autograd differentiates through (the reference's
``lax.scan`` ground truth); ``ops/grad.py``'s fused VJP marches with the
training semantics of ``_finalize``. Whether any ray is still active is a
host sync; the loop asks every ``ACTIVE_CHECK_EVERY`` iterations (rays that
finished are masked, so the extra iterations change nothing), and
``march_counts`` counts the iterations and the syncs.

All math float32; leaf data stays fp16 on the device and is widened per
sample, as the CUDA reference does (rt_core.cuh:118-119).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.models.n3tree import TreeArrays
from volrend_torch.ops import basis as basis_mod
from volrend_torch.utils.options import RenderOptions

__all__ = ["TreeMeta", "tree_meta", "query_batched", "render_rays",
           "render_image", "prepare_rays", "world2ndc", "march_counts",
           "reset_march_counts", "ACTIVE_CHECK_EVERY"]

_F32 = torch.float32

#: the march asks the device whether any ray is active (a host sync) once
#: every this many iterations
ACTIVE_CHECK_EVERY = 8

#: iterations of the forward march (``fwd``, the while-march and the
#: fixed-length differentiable loop), of the fused backward's re-march
#: (``bwd``, ops/grad.py), and the host syncs both made
march_counts = {"fwd": 0, "bwd": 0, "syncs": 0}


def reset_march_counts() -> None:
    for k in march_counts:
        march_counts[k] = 0


def any_active(active: torch.Tensor, i: int, sync_group=None) -> bool:
    """False once no ray is active, asked on iteration ``i`` of a march
    when ``i`` is a multiple of ACTIVE_CHECK_EVERY (else True).
    ``sync_group``: a process group whose ranks march together (the leaf-
    sharded render, whose every iteration is a collective): the answer is
    theirs together (one all-reduce), so all run the same iterations."""
    if i % ACTIVE_CHECK_EVERY:
        return True
    march_counts["syncs"] += 1
    if sync_group is not None:
        from volrend_torch.parallel import mesh
        return mesh.any_true(active, sync_group)
    return bool(active.any())


_CONSTS = {}


def _const(values, device) -> torch.Tensor:
    """A small f32 constant on ``device``, copied there once: a copy from
    host memory at every use would wait for the device each time."""
    key = (tuple(float(v) for v in values), str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(key[0], dtype=_F32, device=device)
    return _CONSTS[key]


class TreeMeta(NamedTuple):
    """Hashable static description of a TreeArrays."""
    N: int
    data_dim: int
    basis_dim: int
    fmt: int
    max_depth: int
    lut_depth: int
    ndc: Optional[Tuple[float, float, float]]


def tree_meta(tree: TreeArrays) -> TreeMeta:
    return TreeMeta(tree.N, tree.data_dim, tree.basis_dim, int(tree.fmt),
                    tree.max_depth, tree.lut_depth, tree.ndc)


# ---------------------------------------------------------------------------
# Octree query
# ---------------------------------------------------------------------------

def _descend(child_flat, xyz, ptr, cube_sz, leaf_idx, done, N: int,
             n_levels: int):
    """Level-synchronous root->leaf descent for a ray batch: each level is
    ONE batched gather from ``child``; finished lanes are masked (the
    reference's serial pointer chase, n3tree_query.hpp:22-47,
    vectorized)."""
    fN = float(N)
    N3 = N ** 3
    n_child = child_flat.shape[0]
    for _ in range(n_levels):
        xyz_s = xyz * fN
        idx = torch.floor(xyz_s)
        ii = idx.to(torch.int32)
        index = (ii[..., 0] * N + ii[..., 1]) * N + ii[..., 2]
        xyz_new = xyz_s - idx
        sub_ptr = ptr + index
        skip = child_flat[torch.clamp(sub_ptr, 0, n_child - 1).long()]
        is_leaf = (skip == 0) & ~done
        leaf_idx = torch.where(is_leaf, sub_ptr, leaf_idx)
        cont = ~done & (skip != 0)
        xyz = torch.where(done[..., None], xyz, xyz_new)
        ptr = torch.where(cont, ptr + skip * N3, ptr)
        cube_sz = torch.where(cont, cube_sz * fN, cube_sz)
        done = done | (skip == 0)
    return leaf_idx, cube_sz, xyz


def _query(child, lut, pos, meta: TreeMeta):
    """Batched point query. pos (..., 3) in tree coords.

    Returns (leaf_idx (...,) int32 — flat cell index into data,
             cube_sz (...,) f32 — N**depth of the leaf,
             rel (..., 3) f32 — leaf-local coords in [0,1))."""
    N = meta.N
    xyz = torch.clamp(pos.to(_F32), 0.0, 1.0 - 1e-6)
    shape = xyz.shape[:-1]
    zeros_i = torch.zeros(shape, dtype=torch.int32, device=xyz.device)

    if meta.lut_depth > 0:
        # one gather resolves (leaf, depth) exactly
        Rl = N ** meta.lut_depth
        cell = torch.clamp(torch.floor(xyz * Rl).to(torch.int32), 0, Rl - 1)
        flat = (cell[..., 0] * Rl + cell[..., 1]) * Rl + cell[..., 2]
        e = lut.reshape(-1)[flat.long()]
        is_leaf = e >= 0
        leaf_idx = torch.where(is_leaf, e >> 4, zeros_i)
        depth = torch.where(is_leaf, e & 15,
                            torch.full_like(e, meta.lut_depth))
        cube_table = _const(np.float32(N) ** np.arange(16, dtype=np.float32),
                            xyz.device)
        cube_sz = cube_table[depth.long()]
        scaled = xyz * cube_sz[..., None]
        rel = scaled - torch.floor(scaled)
        n_resid = meta.max_depth + 1 - meta.lut_depth
        if n_resid <= 0:
            return leaf_idx, cube_sz, rel
        # resume descent from the stored interior node at depth lut_depth
        node = torch.where(is_leaf, zeros_i, -(e + 1))
        ptr = node * (N ** 3)
        cube_next = float(N ** (meta.lut_depth + 1))
        cube_sz = torch.where(is_leaf, cube_sz,
                              torch.full_like(cube_sz, cube_next))
        return _descend(child, rel, ptr, cube_sz, leaf_idx, is_leaf,
                        N, n_resid)

    cube_sz = torch.full(shape, float(N), dtype=_F32, device=xyz.device)
    done = torch.zeros(shape, dtype=torch.bool, device=xyz.device)
    return _descend(child, xyz, zeros_i, cube_sz, zeros_i, done,
                    N, meta.max_depth + 1)


def query_batched(tree: TreeArrays, pos):
    return _query(tree.child, tree.lut, pos, tree_meta(tree))


def _fetch_rows(data, leaf_idx):
    """Leaf payload gather: a dense (K, D) tensor, or a quantized tree's
    QuantLeaves (models/quantized.py), dequantized as it is fetched."""
    if hasattr(data, "fetch_rows"):
        return data.fetch_rows(leaf_idx)
    return data[leaf_idx.long()]


# ---------------------------------------------------------------------------
# Ray setup
# ---------------------------------------------------------------------------

def world2ndc(ndc: Tuple[float, float, float], dirs, origins):
    """Batched LLFF NDC warp (volrend.cu:34-54): world rays -> (unit NDC
    directions, NDC origins on the near plane z' = -1). ``dirs`` and
    ``origins`` broadcast against each other (..., 3)."""
    width, height, focal = (np.float32(v) for v in ndc)
    t = -(1.0 + origins[..., 2]) / dirs[..., 2]
    cen = origins + t[..., None] * dirs
    sx = float(-(np.float32(2.0) * focal) / width)
    sy = float(-(np.float32(2.0) * focal) / height)
    ndir = torch.stack([
        sx * (dirs[..., 0] / dirs[..., 2] - cen[..., 0] / cen[..., 2]),
        sy * (dirs[..., 1] / dirs[..., 2] - cen[..., 1] / cen[..., 2]),
        -2.0 / cen[..., 2],
    ], -1)
    ncen = torch.stack([
        sx * (cen[..., 0] / cen[..., 2]),
        sy * (cen[..., 1] / cen[..., 2]),
        1.0 + 2.0 / cen[..., 2],
    ], -1)
    ndir = ndir / _norm(ndir)[..., None]
    return ndir, ncen


def _rodrigues_matrix(rot_dirs) -> Optional[np.ndarray]:
    """Static axis-angle -> rotation matrix (volrend.cu:57-71); None if ~0."""
    aa = np.asarray(rot_dirs, np.float64)
    angle = np.linalg.norm(aa)
    if angle < 1e-6:
        return None
    k = aa / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) * np.cos(angle) + np.sin(angle) * K
         + (1 - np.cos(angle)) * np.outer(k, k))
    return R.astype(np.float32)


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def prepare_rays(tree: TreeArrays, origins, dirs, opt: RenderOptions):
    """World rays -> (cen_tree, dir_unit, vdir, invdir, delta_scale).

    Applies the NDC warp, the world->tree transform, viewdir rotation, and
    the direction rescale of ``_get_delta_scale`` (rt_core.cuh:51-63)."""
    dirs = dirs.to(_F32)
    origins = origins.to(_F32)
    vdir = dirs
    if tree.ndc is not None:
        dirs, origins = world2ndc(tree.ndc, dirs, origins)
    cen = tree.offset + tree.scale * origins
    R = _rodrigues_matrix(opt.rot_dirs)
    if R is not None:
        vdir = vdir @ _const(R.ravel(), vdir.device).reshape(3, 3).T
    d = dirs * tree.scale
    delta_scale = 1.0 / _norm(d)
    d = d * delta_scale[..., None]
    invdir = 1.0 / (d + 1e-9)
    return cen, d, vdir, invdir, delta_scale


def _dda_world(cen, invdir, render_bbox):
    """Batched ray/bbox clip (rt_core.cuh:17-34)."""
    bb = np.asarray(render_bbox, np.float32)
    lo = _const(bb[:3] + np.float32(1e-6), cen.device)
    hi = _const(bb[3:] - np.float32(1e-6), cen.device)
    t1 = (lo - cen) * invdir
    t2 = (hi - cen) * invdir
    tmin = torch.clamp(torch.amax(torch.minimum(t1, t2), -1), min=0.0)
    tmax = torch.clamp(torch.amin(torch.maximum(t1, t2), -1), max=1e4)
    return tmin, tmax


def _dda_unit(rel, invdir):
    """Distance to unit-cube exit (rt_core.cuh:36-49)."""
    t1 = -rel * invdir
    t2 = t1 + invdir
    return torch.clamp(torch.amin(torch.maximum(t1, t2), -1), max=1e4)


def _precalc_basis(tree: TreeArrays, vdir, opt: RenderOptions):
    if tree.basis_dim < 0:
        return torch.zeros(vdir.shape[:-1] + (0,), dtype=_F32,
                           device=vdir.device)
    vals = basis_mod.eval_basis(BasisType(tree.fmt), tree.basis_dim, vdir,
                                tree.extra)
    return basis_mod.apply_basis_window(vals.to(_F32), opt.basis_minmax)


# ---------------------------------------------------------------------------
# The march
# ---------------------------------------------------------------------------

def _sample_step(data, child, lut, meta: TreeMeta, opt: RenderOptions,
                 cen, d, invdir, basis_vals, t):
    """One march step's sample quantities for all rays."""
    Rn = cen.shape[0]
    pos = cen + t[:, None] * d
    leaf_idx, cube_sz, rel = _query(child, lut, pos, meta)
    vals = _fetch_rows(data, leaf_idx).to(_F32)        # (R, >=D) gather
    sigma = vals[:, meta.data_dim - 1]
    t_sub = _dda_unit(rel, invdir) / cube_sz
    delta_t = t_sub + float(opt.step_size)
    if opt.render_depth or meta.basis_dim < 0:
        rgb = vals[:, :3]
        raw = rgb
    else:
        bd = meta.basis_dim
        coeffs = vals[:, :3 * bd].reshape(Rn, 3, bd)
        raw = torch.sum(coeffs * basis_vals[:, None, :], dim=-1)
        rgb = torch.sigmoid(raw)
    return leaf_idx, sigma, delta_t, rgb, raw


def _march(data, child, lut, meta: TreeMeta, opt: RenderOptions,
           cen, d, invdir, delta_scale, basis_vals, tmin, tmax,
           differentiable: bool = False, n_steps: Optional[int] = None,
           train: Optional[bool] = None, dt_clamp=None, sync_group=None):
    """Core march loop over a ray batch: every active ray steps until it
    leaves its [tmin, tmax) range or saturates (the reference's unbounded
    ``while t < tmax``).

    differentiable=False: at most ``opt.max_steps`` iterations, ending once
    no ray is active. differentiable=True: a fixed-length loop of
    ``n_steps`` (default ``opt.max_steps``) that autograd differentiates
    through; it too ends once no ray is active, since inactive rays are
    masked either way. train: the training termination semantics of
    ``_finalize``; defaults to ``differentiable``.

    dt_clamp: (R,) per-ray t past which a step integrates nothing (the
    context-parallel render's segment end: the next rank owns [hi, ...));
    the ray still advances by the whole step, so termination matches.
    sync_group: the ranks that march together (``any_active``)."""
    if train is None:
        train = differentiable
    n_iter = (n_steps or opt.max_steps) if differentiable else opt.max_steps
    Rn = cen.shape[0]
    dev = cen.device
    hit = (tmax >= 0) & (tmin <= tmax)
    t = torch.where(hit, tmin, tmax)
    light = torch.ones(Rn, dtype=_F32, device=dev)
    acc = torch.zeros((Rn, 3), dtype=_F32, device=dev)
    active = hit & (tmin < tmax)
    stopped = torch.zeros(Rn, dtype=torch.bool, device=dev)
    for i in range(n_iter):
        if not any_active(active, i, sync_group):
            break
        march_counts["fwd"] += 1
        _, sigma, delta_t, rgb, _ = _sample_step(
            data, child, lut, meta, opt, cen, d, invdir, basis_vals, t)
        valid = active & (sigma > opt.sigma_thresh)
        dt_eff = delta_t
        if dt_clamp is not None:
            dt_eff = torch.minimum(torch.clamp(dt_clamp - t, min=0.0),
                                   delta_t)
        att = torch.exp(-dt_eff * delta_scale * sigma)
        weight = light * (1.0 - att)
        if opt.render_depth:
            contrib = torch.stack([weight * t, torch.zeros_like(weight),
                                   torch.zeros_like(weight)], -1)
        else:
            contrib = weight[:, None] * rgb
        acc = acc + torch.where(valid[:, None], contrib, 0.0)
        light = torch.where(valid, light * att, light)
        stopped_now = valid & (light < opt.stop_thresh)
        active = active & ~stopped_now
        t = torch.where(active, t + delta_t, t)
        active = active & (t < tmax)
        stopped = stopped | stopped_now
    return _finalize(light, acc, stopped, hit, opt, train)


def _finalize(light, acc, stopped, hit, opt: RenderOptions,
              train: bool = False):
    """Per-ray termination semantics (rt_core.cuh:176-194). Training mode
    skips the early-stop renormalization and keeps the smooth alpha
    ``1 - light`` (a stopped ray is not forced to alpha 1), so gradients
    stay well defined; its branches are not computed at all, so autograd
    never meets the renormalization's 0/0 on rays that saw nothing."""
    Rn = light.shape[0]
    renorm = stopped & opt.renormalize
    if opt.render_depth:
        dep = torch.clamp(acc[:, 0] * 0.3, max=1.0)
        if not train:
            dep = torch.where(renorm, dep / (1.0 - light), dep)
        rgb = torch.stack([dep, dep, dep], -1)
        alpha = torch.ones(Rn, dtype=_F32, device=light.device)
    elif train:
        rgb = acc
        alpha = torch.where(hit, 1.0 - light, 0.0)
    else:
        rgb = torch.where(renorm[:, None], acc / (1.0 - light[:, None]), acc)
        # early-stopped rays report alpha=1 (rt_core.cuh:183)
        alpha = torch.where(stopped, 1.0, 1.0 - light)
        alpha = torch.where(hit, alpha, 0.0)
    return rgb, alpha


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def render_rays(tree: TreeArrays, origins, dirs, opt: RenderOptions,
                tmax_bg=None, bg_rgb=None, differentiable: bool = False,
                n_steps: Optional[int] = None, sync_group=None):
    """Render world-space rays; returns (R, 4) RGBA with background
    composited (render_kernel offscreen semantics, volrend.cu:135-163).

    differentiable=True: the fixed-length loop of ``n_steps`` (default
    ``opt.max_steps``) with the training semantics, which autograd
    differentiates through to ``tree.data`` (pass a tree whose data is an
    f32 tensor that requires grad): the ground truth of ops/grad.py's fused
    VJP.

    origins/dirs: (R, 3) tensors (or arrays) — moved to the tree's device.
    tmax_bg: optional (R,) world-space distance cap (a mesh pass's
    euclidean distance, inf where no mesh: ops/rasterize.py). bg_rgb:
    optional (R, 3) per-ray background (the mesh colour); rays whose cap is
    finite composite their remaining transmittance over it instead of the
    flat background and report alpha 1 (volrend.cu:143-163, the mesh
    branch). sync_group: the ranks that march together, each iteration a
    collective (the leaf-sharded render: parallel/leaf_shard.py)."""
    dev = tree.data.device
    origins = torch.as_tensor(origins, device=dev)
    dirs = torch.as_tensor(dirs, device=dev)
    cen, d, vdir, invdir, delta_scale = prepare_rays(tree, origins, dirs, opt)
    basis_vals = _precalc_basis(tree, vdir, opt)
    tmin, tmax = _dda_world(cen, invdir, opt.render_bbox)
    if tmax_bg is not None:
        tmax_bg = torch.as_tensor(tmax_bg, dtype=_F32, device=dev)
        tmax = torch.minimum(tmax, tmax_bg / delta_scale)
    rgb, alpha = _march(tree.data, tree.child, tree.lut, tree_meta(tree),
                        opt, cen, d, invdir, delta_scale, basis_vals,
                        tmin, tmax, differentiable, n_steps,
                        sync_group=sync_group)
    remaining = (1.0 - alpha)[:, None]
    bg = float(opt.background_brightness)
    if bg_rgb is not None and tmax_bg is not None:
        bg_rgb = torch.as_tensor(bg_rgb, dtype=_F32, device=dev)
        hit = torch.isfinite(tmax_bg)[:, None]
        rgb = rgb + remaining * torch.where(hit, bg_rgb, bg)
        alpha = torch.where(hit[:, 0], 1.0, alpha)
    else:
        rgb = rgb + bg * remaining
    return torch.cat([rgb, alpha[:, None]], -1)


def render_image(tree: TreeArrays, cam, opt: RenderOptions,
                 tmax_bg=None, bg_rgb=None) -> torch.Tensor:
    """Render a full frame; returns (H, W, 4) float32 on the tree's device.
    tmax_bg (H, W) / bg_rgb (H, W, 3): a mesh pass's distance and colour
    buffers (see render_rays)."""
    origins, dirs = cam.pixel_rays(xp=np)
    if tmax_bg is not None:
        tmax_bg = np.asarray(tmax_bg, np.float32).reshape(-1)
    if bg_rgb is not None:
        bg_rgb = np.asarray(bg_rgb, np.float32).reshape(-1, 3)
    out = render_rays(tree, np.ascontiguousarray(origins), dirs, opt,
                      tmax_bg=tmax_bg, bg_rgb=bg_rgb)
    return out.reshape(cam.height, cam.width, 4)
