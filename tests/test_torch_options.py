"""The viewer's render options on the port's display path (kernel M's
option variants, their plain versions on the CPU): depth mode,
``render_bbox``, the basis window (``basis_minmax``) and ``rot_dirs``, on
world trees, NDC trees and split frames, against the reference with its
Pallas kernels in interpret mode and against the port's exact renderer.

Tolerances: rgb PSNR >= 45 dB and T or alpha within 2e-2 (the reference's
bf16 warp matmuls, as tests/test_torch_march.py); depth >= 40 dB, the
reference's own interpret-vs-slab depth gate (test_slab_render.py:225-230,
:670); against the exact renderer the reference tests' 30 dB
(test_slab_render.py:634-689)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import render_exact, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import (format_scene, interpret, make_cam, march_pair,
                           ndc_cam, ndc_scene, np32, psnr)

torch.set_num_threads(1)

GATE_DB = 45.0
DEPTH_DB = 40.0
EXACT_DB = 30.0
T_ATOL = 2e-2

#: each option alone, and the NDC viz test's three together
#: (test_ndc_slab_with_viz_options)
OPTIONS = {
    "depth": dict(render_depth=True),
    "bbox": dict(render_bbox=(0.25,) * 3 + (0.75,) * 3),
    "window": dict(basis_minmax=(1, 2)),
    "rot": dict(rot_dirs=(0.3, -0.2, 0.5)),
    "viz": dict(rot_dirs=(0.25, -0.15, 0.3),
                render_bbox=(0.1, 0.1, 0.0, 0.9, 0.9, 1.0),
                basis_minmax=(0, 2)),
}


def _assert_acc(got, want, depth):
    assert np.all(np.isfinite(got))
    p = psnr(got[:3], want[:3])
    assert p >= (DEPTH_DB if depth else GATE_DB), f"PSNR {p:.2f} dB"
    np.testing.assert_allclose(got[3], want[3], atol=T_ATOL)
    assert float(want[3].min()) < 0.5


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_march_options_match_interpret(monkeypatch, option):
    """Kernel M's plain version with each option against the reference's
    kernel in interpret mode, on the world tree's int8 bake (and, for the
    three together, its f16 bake)."""
    cam = make_cam((1.0, 0.25, 0.35), width=48, height=48)
    dtypes = ("int8", "f16") if option == "viz" else ("int8",)
    for dtype in dtypes:
        _, g, _, jg = format_scene("SH", 4, dtype)
        with interpret(monkeypatch):
            got, want = march_pair(g, jg, cam,
                                   JOpt(max_steps=512, **OPTIONS[option]))
        _assert_acc(got, want, option == "depth")


def test_ndc_march_depth_matches_interpret(monkeypatch):
    """test_pallas_interpret_ndc_depth on the port: the depth march on the
    NDC tree (t measured from the near plane, params[29])."""
    _, g, _, jg = ndc_scene()
    cam = ndc_cam(width=32, height=32, fx=36.0)
    with interpret(monkeypatch):
        got, want = march_pair(g, jg, cam, JOpt(max_steps=512,
                                                render_depth=True))
    _assert_acc(got, want, True)


@pytest.mark.parametrize("option", ["depth", "viz"])
def test_ndc_render_image_options(monkeypatch, option):
    """test_ndc_slab_depth_mode and test_ndc_slab_with_viz_options on the
    port: render_image on the NDC tree against the exact renderer (30 dB,
    the reference tests' floor) and against the reference's render_image
    in interpret mode."""
    tdev, g, _, jg = ndc_scene()
    # gi > min(W, H): both packages warp with the quad-gather warp
    cam = ndc_cam(width=40, height=40, fx=43.0)
    opt = RenderOptions(max_steps=512, **OPTIONS[option])
    got = slab_render.render_image(g, cam, opt, gi=48)
    exact = render_exact.render_image(tdev, cam, opt).numpy()
    p = psnr(got[..., :3], exact[..., :3])
    assert p > EXACT_DB, f"NDC {option} PSNR {p:.1f} dB vs exact"
    with interpret(monkeypatch):
        want = np.asarray(j_slab.render_image(
            jg, cam, JOpt(max_steps=512, **OPTIONS[option]), gi=48))
    p = psnr(got[..., :3], want[..., :3])
    assert p >= (DEPTH_DB if option == "depth" else GATE_DB), p
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=T_ATOL)


@pytest.mark.parametrize("option", ["depth", "viz"])
def test_frames_with_options_match_reference(monkeypatch, option):
    """Whole frames (render_frames, two poses of one group) with the
    options against the reference's render_frames in interpret mode; depth
    frames are [dep, dep, dep, 1]. gi > min(W, H): both packages warp with
    the quad-gather warp (the superquad warps take the finalized image
    whatever the options; tests/test_torch_warp*.py hold them)."""
    _, g, _, jg = format_scene("SH", 4, "int8")
    W = H = 40
    cams = [make_cam(b, width=W, height=H, fx=50.0) for b in
            ((1.0, 0.25, 0.35), (1.0, 0.15, 0.3))]
    perm, flip, _ = j_slab.choose_axis(jg, cams[0].transform, cams[0].fx,
                                       cams[0].fy, W, H)
    trs = np.stack([c.transform for c in cams])
    with interpret(monkeypatch):
        want = np32(j_slab.render_frames(
            jg, jnp.asarray(trs), cams[0].fx, cams[0].fy, perm, flip, W, H,
            JOpt(max_steps=512, **OPTIONS[option]), gi=48))
    got = slab_render.render_frames(
        g, trs, cams[0].fx, cams[0].fy, perm, flip, W, H,
        RenderOptions(max_steps=512, **OPTIONS[option]), gi=48).numpy()
    p = psnr(got[..., :3], want[..., :3])
    assert p >= (DEPTH_DB if option == "depth" else GATE_DB), p
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=T_ATOL)
    if option == "depth":
        np.testing.assert_array_equal(got[..., 0], got[..., 1])
        assert float(got[..., 0].max()) > 0.1


@pytest.mark.parametrize("option", ["depth", "viz"])
def test_split_frame_options_match_reference(monkeypatch, option):
    """A steep pose's split frame (each class pass's frame with the
    options, stitched in f32) in depth mode and with rot + bbox + basis
    window, against the reference's render_frame_split in interpret mode
    and the exact renderer."""
    tdev, g, _, jg = format_scene("SH", 4, "int8")
    back = np.asarray((1.0, 0.3, 0.4))
    back /= np.linalg.norm(back)
    cam = Camera.from_vectors(center=tuple(1.2 * back), v_back=tuple(back),
                              v_world_up=(0.0, 0.0, 1.0), width=40,
                              height=40, fx=16.0)
    opt = RenderOptions(max_steps=512, **OPTIONS[option])
    assert len(slab_render.split_classes(g, cam.transform, cam.fx, cam.fy,
                                         40, 40)) > 1
    got = slab_render.render_frame_split(g, cam.transform, cam.fx, cam.fy,
                                         40, 40, opt, gi=64).numpy()
    with interpret(monkeypatch):
        want = np.asarray(j_slab.render_frame_split(
            jg, cam.transform, cam.fx, cam.fy, 40, 40,
            JOpt(max_steps=512, **OPTIONS[option]), gi=64))
    p = psnr(got[..., :3], want[..., :3])
    assert p >= (DEPTH_DB if option == "depth" else GATE_DB), \
        f"split {option} PSNR {p:.2f} dB"
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=T_ATOL)
    exact = render_exact.render_image(tdev, cam, opt).numpy()
    assert psnr(got[..., :3], exact[..., :3]) > EXACT_DB


def test_bbox_edge_loss_matches_the_reference(monkeypatch):
    """A render_bbox costs the slab path against the exact renderer in the
    reference itself: its kernel masks voxels by their extent and the
    box-filter warp blurs the cut, where the exact renderer clips each
    ray (measured 41.6 -> 29.2 dB at this size). The port's loss is the
    reference's, within 0.5 dB, with the bbox and without."""
    tdev, g, jdev, jg = format_scene("SH", 4, "int8")
    from volrend_tpu.ops import render_jax
    cam = make_cam((1.0, 0.25, 0.35), width=40, height=40, fx=50.0)
    drops = []
    for bb in ((0.0,) * 3 + (1.0,) * 3, (0.25,) * 3 + (0.75,) * 3):
        jopt = JOpt(max_steps=512, render_bbox=bb)
        opt = RenderOptions(max_steps=512, render_bbox=bb)
        with interpret(monkeypatch):
            ref = np.asarray(j_slab.render_image(jg, cam, jopt, gi=48))
        ref_exact = np.asarray(render_jax.render_image(jdev, cam, jopt))
        got = slab_render.render_image(g, cam, opt, gi=48)
        exact = render_exact.render_image(tdev, cam, opt).numpy()
        p_ref = psnr(ref[..., :3], ref_exact[..., :3])
        p_got = psnr(got[..., :3], exact[..., :3])
        assert abs(p_got - p_ref) < 0.5, (bb, p_got, p_ref)
        drops.append(p_ref)
    assert drops[0] - drops[1] > 5.0, drops
