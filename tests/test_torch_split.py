"""Split-frame steep poses (``slab_render.render_frame_split`` and
``render_image``'s route to it): one full-frame slab pass per (axis, sign)
class of the rays' dominant tree axis over the unit slope box (kernel M's
display mode and the display warp, their plain versions on the CPU),
stitched per pixel in f32, against ``volrend_tpu``'s
``render_frame_split`` with its Pallas kernels in interpret mode and
against the port's exact renderer.

Tolerances: against the reference rgb PSNR >= 45 dB and alpha within 2e-2
(its bf16 warp matmuls); against the exact renderer the reference tests'
floors (tests/test_slab_render.py:1119-1175): 33 dB for the steep pose,
26 dB for the interior camera and the elevation sweep."""

import numpy as np
import pytest
import torch

from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import display_warp, render_exact, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import interpret, psnr, scene

torch.set_num_threads(1)

OPT = RenderOptions(max_steps=512)
JOPT = JOpt(max_steps=512)
N = 48
GI = 128


def _steep():
    """test_split_frame_steep_pose_matches_exact's wide-FOV pose close to
    the volume (boundary rays straddle every axis)."""
    back = np.asarray((1.0, 0.3, 0.4))
    back /= np.linalg.norm(back)
    return Camera.from_vectors(center=tuple(1.2 * back), v_back=tuple(back),
                               v_world_up=(0.0, 0.0, 1.0), width=N,
                               height=N, fx=16.0)


def _interior():
    """test_split_frame_interior_camera: inside the volume's bbox."""
    return Camera.from_vectors(center=(0.05, 0.02, 0.0),
                               v_back=(0.6, 0.5, 0.62),
                               v_world_up=(0.0, 0.0, 1.0), width=N,
                               height=N, fx=14.0)


def _sweep(elev):
    """test_split_frame_elevation_sweep's orbit at elevation ``elev``."""
    back = np.asarray([np.cos(elev), 0.15, np.sin(elev)])
    back /= np.linalg.norm(back)
    return Camera.from_vectors(center=tuple(1.5 * back), v_back=tuple(back),
                               v_world_up=(0.0, 1.0, 0.0), width=N,
                               height=N, fx=24.0)


def _steep_slope(g, cam) -> bool:
    _, _, s = slab_render.choose_axis(g, cam.transform, cam.fx, cam.fy,
                                      cam.width, cam.height)
    return not (np.isfinite(s) and s < slab_render.MAX_SLAB_SLOPE)


def _sweep_poses(g):
    """The elevation sweep's cameras, each with whether it is steep."""
    return [(cam, _steep_slope(g, cam))
            for cam in (_sweep(e) for e in (0.1, 0.6, 1.0, 1.35, 1.57))]


@pytest.mark.parametrize("case,floor,alpha_share",
                         [("steep", 33.0, 0.02), ("interior", 26.0, 0.03)])
def test_split_frame_matches_exact(case, floor, alpha_share):
    """The reference's test_split_frame_steep_pose_matches_exact and
    test_split_frame_interior_camera on the port: a steep pose (slope inf)
    renders as a split frame of several class passes and matches the exact
    renderer at the reference's floors."""
    tdev, g, _, _ = scene("dense", 4, "int8")
    cam = _steep() if case == "steep" else _interior()
    assert _steep_slope(g, cam)
    classes = slab_render.split_classes(g, cam.transform, cam.fx, cam.fy,
                                        N, N)
    assert len(classes) > 1, classes
    got = slab_render.render_frame_split(g, cam.transform, cam.fx, cam.fy,
                                         N, N, OPT, gi=GI)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, N, 4)
    got = got.numpy()
    ref = render_exact.render_image(tdev, cam, OPT).numpy()
    p = psnr(got[..., :3], ref[..., :3])
    assert p > floor, f"split-frame {case} PSNR {p:.1f} dB"
    assert np.mean(np.abs(got[..., 3] - ref[..., 3]) > 0.5) < alpha_share


def test_split_frame_elevation_sweep():
    """The reference's test_split_frame_elevation_sweep on the port: every
    pose renders on a slab path (one axis or split) and matches the exact
    renderer (> 26 dB); the sweep reaches the steep regime."""
    tdev, g, _, _ = scene("dense", 4, "int8")
    poses = _sweep_poses(g)
    for cam, steep in poses:
        out = slab_render.render_image(g, cam, OPT, gi=GI)
        ref = render_exact.render_image(tdev, cam, OPT).numpy()
        p = psnr(out[..., :3], ref[..., :3])
        assert p > 26.0, f"steep={steep} PSNR {p:.1f}"
    assert any(s for _, s in poses), "the sweep never hit the steep regime"


def test_split_frames_match_reference(monkeypatch):
    """The split frames of the steep pose, the interior camera and the
    sweep's steep poses against the reference's render_frame_split with
    its kernels in interpret mode (one interpret context: poses with the
    same classes share the reference's compile)."""
    _, g, _, jg = scene("dense", 4, "int8")
    cams = [_steep(), _interior()] + [c for c, s in _sweep_poses(g) if s]
    assert len(cams) >= 3
    got = [slab_render.render_frame_split(
        g, c.transform, c.fx, c.fy, N, N, OPT, gi=GI).numpy() for c in cams]
    with interpret(monkeypatch):
        want = [np.asarray(j_slab.render_frame_split(
            jg, c.transform, c.fx, c.fy, N, N, JOPT, gi=GI)) for c in cams]
    for i, (a, b) in enumerate(zip(got, want)):
        p = psnr(a[..., :3], b[..., :3])
        assert p >= 45.0, f"pose {i}: rgb PSNR {p:.2f} dB"
        np.testing.assert_allclose(a[..., 3], b[..., 3], atol=2e-2)
        assert float(b[..., 3].max()) > 0.5


def test_render_image_routes_steep_poses_to_split_frames():
    """render_image takes steep world-tree poses to render_frame_split: the
    same frame, RGBA8 converted once from the f32 stitch, the class passes'
    payloads cached by (perm, crop) and reused."""
    _, g, _, _ = scene("dense", 4, "int8")
    cam = _steep()
    split = slab_render.render_frame_split(g, cam.transform, cam.fx, cam.fy,
                                           N, N, OPT, gi=GI)
    out = slab_render.render_image(g, cam, OPT, gi=GI)
    np.testing.assert_array_equal(out, split.numpy())
    u8 = slab_render.render_image(g, cam, OPT, gi=GI, out_dtype=torch.uint8)
    np.testing.assert_array_equal(
        u8, display_warp.to_display_dtype(split, torch.uint8).numpy())
    cache = {}
    cached = slab_render.render_image(g, cam, OPT, gi=GI,
                                      payload_cache=cache)
    np.testing.assert_array_equal(cached, out)
    classes = slab_render.split_classes(g, cam.transform, cam.fx, cam.fy,
                                        N, N)
    perms = {(a, (a + 1) % 3, (a + 2) % 3) for a, _ in classes}
    assert set(cache) == {(p, slab_render.inplane_crop(g, p, 1e-2))
                          for p in perms}
    before = {k: id(v) for k, v in cache.items()}
    slab_render.render_image(g, cam, OPT, gi=GI, payload_cache=cache)
    assert {k: id(v) for k, v in cache.items()} == before


def test_split_passes_take_the_superquad_warp():
    """At 64^2, gi=32 the superquad warp applies: every class pass of the
    steep pose goes through it (kernel W's plain version on the CPU), none
    through the reference warp, and the frame matches the exact renderer
    at the reference's steep floor."""
    tdev, g, _, _ = scene("dense", 4, "int8")
    back = np.asarray((1.0, 0.3, 0.4))
    back /= np.linalg.norm(back)
    cam = Camera.from_vectors(center=tuple(1.2 * back), v_back=tuple(back),
                              v_world_up=(0.0, 0.0, 1.0), width=64,
                              height=64, fx=22.0)
    assert _steep_slope(g, cam)
    slab_render._warp_to_screen_ref.poses = 0
    out = slab_render.render_image(g, cam, OPT, gi=32)
    assert slab_render._warp_to_screen_ref.poses == 0
    ref = render_exact.render_image(tdev, cam, OPT).numpy()
    p = psnr(out[..., :3], ref[..., :3])
    assert p > 33.0, f"PSNR {p:.1f} dB"


def test_evict_perm_keeps_one_crop_per_perm():
    cache = {((0, 1, 2), None): 1, ((0, 1, 2), (0, 32, 0, 128)): 2,
             ((1, 2, 0), None): 3, "other": 4}
    slab_render._evict_perm(cache, (0, 1, 2))
    assert cache == {((1, 2, 0), None): 3, "other": 4}


def test_split_refusals():
    """Split frames refuse a mesh distance without its colour (ValueError);
    meshes themselves ride along since item 13 (every class pass clips and
    composites; tests/test_torch_mesh.py holds them against the
    reference)."""
    _, g, _, _ = scene("dense", 4, "int8")
    cam = _steep()
    with pytest.raises(ValueError, match="come together"):
        slab_render.render_frame_split(
            g, cam.transform, cam.fx, cam.fy, cam.width, cam.height, OPT,
            gi=GI, mesh_dist=np.ones((cam.height, cam.width), np.float32))
