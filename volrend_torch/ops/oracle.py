"""T1: scalar NumPy oracle renderer — the executable specification (the
counterpart of ``volrend_tpu/ops/oracle.py``).

A deliberately slow, obviously-correct transcription of the reference render
semantics, per ray on the host, on the port's ``N3Tree``, ``Camera`` and
``RenderOptions``:

- pixel -> world ray (``src/cuda/volrend.cu:22-32``)
- NDC warp (``volrend.cu:34-54``), rodrigues viewdir rotation (``:57-71``)
- ray/bbox clip ``_dda_world`` (``rt_core.cuh:17-34``)
- stackless octree descent (``n3tree_query.hpp:13-48``)
- march loop with voxel skipping, sigma thresholding, SH(sigmoid)/RGBA
  accumulation, early stop + renormalization, depth mode
  (``rt_core.cuh:66-196``)
- background compositing (``volrend.cu:152-158``)

All math in float32, matching the CUDA kernels. The basis values come from
the port's ``ops/basis.py`` evaluated on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from volrend_torch.models.n3tree import N3Tree
from volrend_torch.ops.basis import apply_basis_window, eval_basis
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

f32 = np.float32


def _basis_values(fmt, basis_dim: int, vdir, extra, basis_minmax):
    """The basis at one direction (numpy f32 (basis_dim,)), through the
    port's basis module on the CPU."""
    ex = None if extra is None else torch.from_numpy(
        np.asarray(extra, f32))
    vals = eval_basis(fmt, basis_dim, torch.from_numpy(vdir.astype(f32)),
                      ex)
    return apply_basis_window(vals.to(torch.float32),
                              basis_minmax).numpy().astype(f32)


def query_single_from_root(child_flat, data_flat, N, data_dim, xyz):
    """Descend root->leaf; returns (leaf_values, cube_sz, rel_xyz)."""
    fN = f32(N)
    N3 = N ** 3
    xyz = np.minimum(np.maximum(xyz, f32(0.0)), f32(1.0 - 1e-6)).astype(f32)
    ptr = 0
    cube_sz = fN
    while True:
        index = 0
        for i in range(3):
            xyz[i] = xyz[i] * fN
            idx_dimi = np.floor(xyz[i])
            index = index * N + int(idx_dimi)
            xyz[i] = xyz[i] - idx_dimi
        sub_ptr = ptr + index
        skip = int(child_flat[sub_ptr])
        if skip == 0:
            return data_flat[sub_ptr], cube_sz, xyz
        cube_sz = cube_sz * fN
        ptr += skip * N3


def _dda_world(cen, invdir, render_bbox):
    tmin, tmax = f32(0.0), f32(1e4)
    for i in range(3):
        t1 = (f32(render_bbox[i]) + f32(1e-6) - cen[i]) * invdir[i]
        t2 = (f32(render_bbox[i + 3]) - f32(1e-6) - cen[i]) * invdir[i]
        tmin = max(tmin, min(t1, t2))
        tmax = min(tmax, max(t1, t2))
    return tmin, tmax


def _dda_unit(cen, invdir):
    tmax = f32(1e4)
    for i in range(3):
        t1 = -cen[i] * invdir[i]
        t2 = t1 + invdir[i]
        tmax = min(tmax, max(t1, t2))
    return tmax


def rodrigues(aa, d):
    aa = np.asarray(aa, f32)
    angle = f32(np.linalg.norm(aa))
    if angle < 1e-6:
        return d
    k = aa / angle
    cos_a, sin_a = f32(np.cos(angle)), f32(np.sin(angle))
    cross = np.cross(k, d).astype(f32)
    dot = f32(np.dot(k, d))
    return (d * cos_a + cross * sin_a + k * dot * (f32(1.0) - cos_a)).astype(f32)


def world2ndc(ndc, dir, cen):
    """LLFF forward-facing warp (volrend.cu:34-54). ndc=(width,height,focal)."""
    width, height, focal = (f32(v) for v in ndc)
    dir = dir.astype(f32).copy()
    cen = cen.astype(f32).copy()
    t = -(f32(1.0) + cen[2]) / dir[2]
    cen = cen + t * dir
    ndir = np.empty(3, f32)
    ndir[0] = -((2 * focal) / width) * (dir[0] / dir[2] - cen[0] / cen[2])
    ndir[1] = -((2 * focal) / height) * (dir[1] / dir[2] - cen[1] / cen[2])
    ndir[2] = -2 / cen[2]
    ncen = np.empty(3, f32)
    ncen[0] = -((2 * focal) / width) * (cen[0] / cen[2])
    ncen[1] = -((2 * focal) / height) * (cen[1] / cen[2])
    ncen[2] = 1 + 2 / cen[2]
    ndir = ndir / f32(np.linalg.norm(ndir))
    return ndir, ncen


def trace_ray(tree: N3Tree, dir, vdir, cen, opt: RenderOptions,
              tmax_bg=f32(1e9)):
    """Reference trace_ray (rt_core.cuh:66-196). dir/cen in tree coords
    (cen already offset+scaled); dir is the *world* unit direction."""
    child_flat = tree.child.reshape(-1)
    data_flat = tree.data.reshape(-1, tree.data_dim)
    fmt = tree.data_format.format
    basis_dim = tree.data_format.basis_dim
    D = tree.data_dim
    out = np.zeros(4, f32)

    # _get_delta_scale (rt_core.cuh:51-63)
    dir = (dir * tree.scale).astype(f32)
    delta_scale = f32(1.0) / f32(np.linalg.norm(dir))
    dir = dir * delta_scale
    tmax_bg = f32(tmax_bg) / delta_scale

    invdir = (f32(1.0) / (dir + f32(1e-9))).astype(f32)
    tmin, tmax = _dda_world(cen, invdir, opt.render_bbox)
    tmax = min(tmax, tmax_bg)

    if tmax < 0 or tmin > tmax:
        if opt.render_depth:
            out[3] = 1.0
        return out

    if basis_dim >= 0:
        basis_fn = _basis_values(fmt, basis_dim, vdir, tree.extra,
                                 opt.basis_minmax)
    else:
        basis_fn = None

    light_intensity = f32(1.0)
    t = tmin
    n_steps = 0
    while t < tmax and n_steps < opt.max_steps:
        n_steps += 1
        pos = (cen + t * dir).astype(f32)
        vals, cube_sz, rel = query_single_from_root(
            child_flat, data_flat, tree.N, D, pos)
        t_subcube = _dda_unit(rel, invdir) / cube_sz
        delta_t = t_subcube + f32(opt.step_size)
        sigma = f32(vals[D - 1])
        if sigma > opt.sigma_thresh:
            att = f32(np.exp(f32(-delta_t * delta_scale * sigma)))
            weight = light_intensity * (f32(1.0) - att)
            if opt.render_depth:
                out[0] += weight * t
            else:
                if basis_dim >= 0:
                    for c in range(3):
                        tmp = f32(0.0)
                        for k in range(basis_dim):
                            tmp += basis_fn[k] * f32(vals[c * basis_dim + k])
                        out[c] += weight / (f32(1.0) + f32(np.exp(-tmp)))
                else:
                    for c in range(3):
                        out[c] += f32(vals[c]) * weight
            light_intensity *= att
            if light_intensity < opt.stop_thresh:
                if opt.render_depth:
                    out[0] = out[1] = out[2] = min(out[0] * f32(0.3), f32(1.0))
                if opt.renormalize:
                    s = f32(1.0) / (f32(1.0) - light_intensity)
                    out[0] *= s
                    out[1] *= s
                    out[2] *= s
                out[3] = 1.0
                return out
        t = t + delta_t
    if opt.render_depth:
        out[0] = out[1] = out[2] = min(out[0] * f32(0.3), f32(1.0))
        out[3] = 1.0
    else:
        out[3] = f32(1.0) - light_intensity
    return out


def render_ray(tree: N3Tree, origin, dir_world, opt: RenderOptions,
               tmax_bg=f32(1e9)):
    """One world-space ray end-to-end: NDC warp, tree transform, trace,
    background composite (render_kernel semantics, volrend.cu:135-163)."""
    dir = np.asarray(dir_world, f32).copy()
    cen = np.asarray(origin, f32).copy()
    vdir = dir.copy()
    if tree.use_ndc and tree.ndc is not None:
        dir, cen = world2ndc(
            (tree.ndc.width, tree.ndc.height, tree.ndc.focal), dir, cen)
    cen = (tree.offset + tree.scale * cen).astype(f32)
    vdir = rodrigues(opt.rot_dirs, vdir)
    out = trace_ray(tree, dir, vdir, cen, opt, tmax_bg)
    remain = f32(opt.background_brightness) * (f32(1.0) - out[3])
    out[0] += remain
    out[1] += remain
    out[2] += remain
    return out


def render_image(tree: N3Tree, cam: Camera, opt: RenderOptions) -> np.ndarray:
    """Render all pixels (slow!); returns (H, W, 4) float32."""
    origins, dirs = cam.pixel_rays(xp=np)
    out = np.zeros((cam.height * cam.width, 4), f32)
    for i in range(out.shape[0]):
        out[i] = render_ray(tree, origins[i], dirs[i], opt)
    return out.reshape(cam.height, cam.width, 4)
