"""The port's octree query, dense bake and exact renderer against the
reference: leaf indices, int8 codes, qscale, the sigma hi/lo planes, the
bf16 sigma plane and occ_max bit for bit; exact-renderer frames within
1e-4. Also pins convert.grid_from_numpy / tree_from_numpy: a JAX bake
carried across marches bit-identically to the port's own bake."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.ops import render_jax
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch import convert
from volrend_torch.ops import dense_grid, render_exact, slab_march, \
    slab_render
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import (CPU, make_cam, ndc_cam, ndc_scene, np32, scene,
                           trees)

torch.set_num_threads(1)


@pytest.mark.parametrize("lut_depth", [None, 0, 2])
def test_query_leaf_indices_bit_equal(lut_depth):
    """Batched point queries (full LUT, pure descent, truncated LUT +
    residual descent) return the reference's leaf, depth and local
    coordinates."""
    t, j = trees("dense", 4)
    td = t.to_device(lut_depth=lut_depth, device=CPU)
    jd = j.to_device(lut_depth=lut_depth)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.05, 1.05, (512, 3)).astype(np.float32)
    got = render_exact.query_batched(td, torch.as_tensor(pts))
    want = render_jax.query_batched(jd, jnp.asarray(pts))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_bake_full_res_exact():
    """Voxel centres hold exactly the leaf payloads (mirrors the
    reference's test_bake_full_res_exact)."""
    tdev, _, _, _ = scene("dense", 4, "int8")
    grid = dense_grid.bake_dense(tdev)
    assert grid.G == dense_grid.full_resolution(tdev) == 16
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    leaf_idx, _, _ = render_exact.query_batched(tdev, torch.as_tensor(pts))
    ref = tdev.data.numpy()[leaf_idx.numpy()][:, :tdev.data_dim]
    vox = np.clip((pts * grid.G).astype(np.int64), 0, grid.G - 1)
    got = grid.data.numpy()[vox[:, 0], vox[:, 1], vox[:, 2]]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind,bd,dtype", [
    ("dense", 4, "int8"), ("dense", 16, "int8"), ("solid", 4, "int8"),
    ("solid", 16, "int8"), ("dense", 16, "f16"),
])
def test_bake_bit_equal(kind, bd, dtype):
    """int8 codes (colour codes, sigma hi and lo planes), qscale, the bf16
    sigma plane and occ_max equal the reference's bake."""
    _, g, _, jg = scene(kind, bd, dtype)
    assert (g.G, g.data_dim, g.basis_dim, int(g.fmt), g.quantized) == (
        jg.G, jg.data_dim, jg.basis_dim, int(jg.fmt), jg.quantized)
    a, b = g.data.numpy(), np.asarray(jg.data)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.qscale.numpy(), np.asarray(jg.qscale))
    np.testing.assert_array_equal(np32(g.sigma_grid), np32(jg.sigma_grid))
    assert g.occ_max == jg.occ_max
    if dtype == "int8":
        D = g.data_dim
        # 14-bit sigma: hi in [0, 127], lo in [0, 127]
        assert a[..., D - 1].min() >= 0 and a[..., D].min() >= 0
        # per-basis scales are shared across r, g, b
        qs = g.qscale.numpy()[:3 * bd].reshape(3, bd)
        np.testing.assert_array_equal(qs[0], qs[1])
        np.testing.assert_array_equal(qs[0], qs[2])


def test_edge_supersample_not_ported():
    """edge_supersample, refused before its slice, now bakes: at the tree's
    full resolution it is the no-op the reference documents (every
    sub-sample lands in the voxel's own leaf), int8 codes bit-equal to the
    plain bake's (tests/test_torch_formats.py holds a coarser bake against
    the reference's)."""
    tdev, g, _, _ = scene("dense", 4, "int8")
    ss = dense_grid.bake_dense(tdev, dtype="int8", edge_supersample=2)
    assert torch.equal(ss.data, g.data)
    assert torch.equal(ss.qscale, g.qscale)


def test_grid_from_numpy_roundtrip():
    """JAX bake -> numpy -> port grid: identical fields, and the port's
    march on it equals the march on the port's own bake bit for bit."""
    _, g, _, jg = scene("solid", 16, "int8")
    cg = convert.grid_from_numpy(
        np.asarray(jg.data), np.asarray(jg.offset), np.asarray(jg.scale),
        np.asarray(jg.extra), np.asarray(jg.qscale),
        np.asarray(jg.sigma_grid), G=jg.G, data_dim=jg.data_dim,
        basis_dim=jg.basis_dim, fmt=jg.fmt, quantized=jg.quantized,
        occ_max=jg.occ_max, ndc=jg.ndc, device=CPU)
    for name in ("data", "offset", "scale", "qscale"):
        assert torch.equal(getattr(cg, name), getattr(g, name)), name
    assert torch.equal(cg.sigma_grid, g.sigma_grid)
    assert cg.occ_max == g.occ_max
    W = H = 32
    cam = make_cam((1.0, 0.3, 0.35), width=W, height=H, fx=40.0)
    opt = RenderOptions(max_steps=256)
    perm, flip, _ = slab_render.choose_axis(g, cam.transform, cam.fx,
                                            cam.fy, W, H)
    outs = []
    for grid in (g, cg):
        geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy,
                                     perm, flip, W, H, opt, 32)
        params, zb = slab_render._march_frame_fields(grid, geom, perm, flip,
                                                     opt)
        outs.append(slab_march.march_slabs(
            slab_render.prepare_payload(grid, perm, opt), params,
            grid.qscale, zb, grid.G, 32, grid.data_dim, grid.basis_dim,
            perm, slab_ids=grid.slab_ids(perm[0], flip, opt.sigma_thresh),
            sig2=True, flip=flip, bbox_full=True, dir_win=True,
            crop=slab_render.inplane_crop(grid, perm, opt.sigma_thresh)))
    assert torch.equal(outs[0], outs[1])
    assert float(outs[0][:, 3].min()) < 0.9   # the march saw the scene


def test_tree_from_numpy_roundtrip():
    tdev, _, jdev, _ = scene("dense", 4, "int8")
    ct = convert.tree_from_numpy(
        np.asarray(jdev.child), np.asarray(jdev.data),
        np.asarray(jdev.offset), np.asarray(jdev.scale),
        np.asarray(jdev.extra), np.asarray(jdev.lut), N=jdev.N,
        data_dim=jdev.data_dim, basis_dim=jdev.basis_dim, fmt=jdev.fmt,
        max_depth=jdev.max_depth, lut_depth=jdev.lut_depth, ndc=jdev.ndc,
        device=CPU)
    for name in ("child", "data", "offset", "scale", "lut"):
        assert torch.equal(getattr(ct, name), getattr(tdev, name)), name
    assert (ct.N, ct.max_depth, ct.lut_depth) == (tdev.N, tdev.max_depth,
                                                  tdev.lut_depth)


@pytest.mark.parametrize("kind,back", [
    ("dense", (1.0, 0.25, 0.35)), ("dense", (-0.2, -0.1, -1.0)),
    ("solid", (0.3, 1.0, 0.5)),
])
def test_render_rays_matches_reference(kind, back):
    """The exact renderer (the quality gate's reference) equals
    render_jax.render_rays within 1e-4 (float32 summation order)."""
    tdev, _, jdev, _ = scene(kind, 16, "int8")
    cam = make_cam(back, width=24, height=20, fx=30.0)
    origins, dirs = cam.pixel_rays(xp=np)
    origins = np.ascontiguousarray(origins)
    got = render_exact.render_rays(tdev, origins, dirs,
                                   RenderOptions(max_steps=512))
    want = render_jax.render_rays(jdev, jnp.asarray(origins),
                                  jnp.asarray(dirs), JOpt(max_steps=512))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    img = render_exact.render_image(tdev, cam, RenderOptions(max_steps=512))
    np.testing.assert_allclose(img.numpy().reshape(-1, 4), got.numpy(),
                               atol=1e-6)


def test_render_exact_refuses_ndc():
    """NDC trees, which the exact renderer refused before their slice, now
    render through world2ndc: the rays of an NDC pose equal
    render_jax.render_rays on the same NDC tree within 1e-5
    (tests/test_torch_ndc.py holds world2ndc and more poses)."""
    tdev, _, jdev, _ = ndc_scene()
    cam = ndc_cam(width=12, height=10, fx=14.0)
    origins, dirs = cam.pixel_rays(xp=np)
    origins = np.ascontiguousarray(origins)
    got = render_exact.render_rays(tdev, origins, dirs, RenderOptions())
    want = render_jax.render_rays(jdev, jnp.asarray(origins),
                                  jnp.asarray(dirs), JOpt())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
