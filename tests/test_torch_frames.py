"""Whole display frames: the port's ``render_frames`` / ``render_frame`` /
``render_image`` (the plain kernel versions on the CPU) against the
reference's ``slab_render.render_frames`` with its Pallas kernels in
interpret mode and the same knobs, and against the port's exact renderer.

Tolerances: rgb PSNR >= 45 dB and alpha within 2e-2 (the reference's bf16
warp matmuls and bf16 display emit against the port's f32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import render_exact, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import (interpret, make_cam, ndc_cam, ndc_scene, np32,
                           psnr, scene)

torch.set_num_threads(1)

GATE_DB = 45.0
ALPHA_ATOL = 2e-2
W = H = 64
GI = 32


def _frames_both(kind, bd, backs, out_u8, monkeypatch, crop_mult=None):
    _, g, _, jg = scene(kind, bd, "int8")
    cams = [make_cam(b, width=W, height=H) for b in backs]
    perm, flip, _ = j_slab.choose_axis(jg, cams[0].transform, cams[0].fx,
                                       cams[0].fy, W, H)
    for c in cams:
        assert j_slab.choose_axis(jg, c.transform, c.fx, c.fy, W, H)[:2] \
            == (perm, flip)
    trs = np.stack([c.transform for c in cams])
    with interpret(monkeypatch, crop_mult=crop_mult):
        want = np32(j_slab.render_frames(
            jg, jnp.asarray(trs), cams[0].fx, cams[0].fy, perm, flip, W, H,
            JOpt(max_steps=512), gi=GI,
            out_dtype=jnp.uint8 if out_u8 else None))
        crop = slab_render.inplane_crop(g, perm, 1e-2)
        slab_render._warp_to_screen_ref.poses = 0
        got = slab_render.render_frames(
            g, trs, cams[0].fx, cams[0].fy, perm, flip, W, H,
            RenderOptions(max_steps=512), gi=GI,
            out_dtype=torch.uint8 if out_u8 else None)
    assert slab_render._warp_to_screen_ref.poses == 0   # superquad warp
    assert got.dtype == (torch.uint8 if out_u8 else torch.float32)
    got = np32(got)
    if out_u8:
        got, want = got / 255.0, want / 255.0
    return got, want, crop


def _assert_frames(got, want):
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    for i in range(got.shape[0]):
        p = psnr(got[i, ..., :3], want[i, ..., :3])
        assert p >= GATE_DB, f"pose {i}: rgb PSNR {p:.2f} dB"
        np.testing.assert_allclose(got[i, ..., 3], want[i, ..., 3],
                                   atol=ALPHA_ATOL)
    assert float(want[..., 3].max()) > 0.5          # the scene is in view


def test_render_frames_dense_uint8_matches_interpret(monkeypatch):
    """Two poses of one (perm, flip) group, SH16, RGBA8 output."""
    got, want, crop = _frames_both(
        "dense", 16, [(1.0, 0.25, 0.35), (1.0, 0.1, 0.45)], True,
        monkeypatch)
    assert crop is None
    _assert_frames(got, want)


def test_render_frames_sparse_cropped_f32_matches_interpret(monkeypatch):
    """The solid scene through the in-plane crop (granularity shrunk in
    both packages), float32 output."""
    got, want, crop = _frames_both("solid", 4, [(0.3, 1.0, 0.5)], False,
                                   monkeypatch, crop_mult=4)
    assert crop is not None
    _assert_frames(got, want)


@pytest.mark.parametrize("kind,back", [("dense", (1.0, 0.25, 0.35)),
                                       ("dense", (-0.2, -0.1, -1.0)),
                                       ("solid", (0.3, 1.0, 0.5))])
def test_render_image_matches_exact_renderer(kind, back):
    """The slab path against the exact octree renderer at the scene's full
    resolution, with the reference's gates (test_slab_matches_exact_renderer:
    > 30 dB, alpha masks agree except at silhouettes); render_frame and a
    payload cache give the same frame."""
    tdev, g, _, _ = scene(kind, 16, "int8")
    n, gi = 96, 96
    cam = make_cam(back, width=n, height=n, fx=120.0)
    opt = RenderOptions(max_steps=512)
    out = slab_render.render_image(g, cam, opt, gi=gi)
    assert isinstance(out, np.ndarray) and out.shape == (n, n, 4)
    exact = render_exact.render_image(tdev, cam, opt).numpy()
    p = psnr(out[..., :3], exact[..., :3])
    assert p > 30.0, f"PSNR {p:.1f} dB"
    assert np.mean(np.abs(out[..., 3] - exact[..., 3]) > 0.5) < 0.02
    cache = {}
    out2 = slab_render.render_image(g, cam, opt, gi=gi, payload_cache=cache)
    perm, flip, _ = slab_render.choose_axis(g, cam.transform, cam.fx,
                                            cam.fy, n, n)
    assert list(cache) == [(perm, slab_render.inplane_crop(g, perm, 1e-2))]
    np.testing.assert_array_equal(out, out2)
    one = slab_render.render_frame(g, cam.transform, cam.fx, cam.fy, perm,
                                   flip, n, n, opt, gi=gi,
                                   out_dtype=torch.uint8).numpy()
    want8 = np.round(np.clip(out, 0.0, 1.0) * 255.0)
    assert np.abs(one.astype(np.float64) - want8).max() <= 1.0


def test_render_image_refuses_later_slices(monkeypatch):
    """What this test refused before its slices now renders: a steep pose
    through the split-frame passes, an NDC tree's pose on the slab path
    (tests/test_torch_split.py and tests/test_torch_ndc.py hold them
    against the reference), mesh overlays (item 13: alpha 1 on the mesh's
    pixels; tests/test_torch_mesh.py holds them against the reference; a
    mesh distance without its colour raises ValueError), and the f16 bake,
    here against the reference's render_image in interpret mode (rgb >= 45
    dB, alpha within 2e-2)."""
    _, g, _, _ = scene("dense", 4, "int8")
    opt = RenderOptions(max_steps=64)
    steep = make_cam((1.0, 0.25, 0.35), width=W, height=H, fx=8.0)
    out = slab_render.render_image(g, steep, opt, gi=GI)
    assert out.shape == (H, W, 4) and np.all(np.isfinite(out))
    cam = make_cam((1.0, 0.25, 0.35), width=W, height=H)
    from volrend_torch.models.mesh import Mesh
    from volrend_torch.ops.rasterize import rasterize_meshes
    cube = Mesh.Cube((1.0, 0.1, 0.1))
    cube.scale = 0.4
    cube.translation = np.asarray(cam.center * 0.35, np.float32)
    out = slab_render.render_image(g, cam, opt, gi=GI, meshes=[cube])
    hit = np.isfinite(rasterize_meshes([cube], cam).dist)
    assert hit.any() and np.all(out[..., 3][hit] == 1.0)
    with pytest.raises(ValueError, match="come together"):
        slab_render.render_frame(g, cam.transform, cam.fx, cam.fy,
                                 (0, 1, 2), False, W, H, opt, gi=GI,
                                 mesh_dist=np.zeros((H, W)))
    _, ndc, _, _ = ndc_scene()
    ncam = ndc_cam(width=W, height=H, fx=70.0)
    out = slab_render.render_image(ndc, ncam, opt, gi=GI)
    assert out.shape == (H, W, 4) and float(out[..., 3].max()) > 0.5
    _, f16, _, jf16 = scene("dense", 16, "f16")
    small = make_cam((1.0, 0.25, 0.35), width=40, height=40, fx=50.0)
    got = slab_render.render_image(f16, small, opt, gi=48)
    with interpret(monkeypatch):
        want = np.asarray(j_slab.render_image(jf16, small,
                                              JOpt(max_steps=64), gi=48))
    assert psnr(got[..., :3], want[..., :3]) >= GATE_DB
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=ALPHA_ATOL)


def test_small_frames_take_the_reference_warp():
    """Frames too small for the superquad warp (gi > min(W, H)) use the
    reference quad-gather warp for every pose."""
    _, g, _, _ = scene("dense", 4, "int8")
    cam = Camera.from_vectors(center=(2.3, 0.5, 0.8),
                              v_back=(0.92, 0.2, 0.32), width=24,
                              height=24, fx=22.0)
    opt = RenderOptions(max_steps=256)
    slab_render._warp_to_screen_ref.poses = 0
    out = slab_render.render_image(g, cam, opt, gi=GI)
    assert slab_render._warp_to_screen_ref.poses == 1
    assert out.shape == (24, 24, 4) and np.all(np.isfinite(out))
