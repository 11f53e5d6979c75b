"""Kernel M's plain version (``slab_march.march_slabs_ref``, what the port
runs on CPU tensors) against the reference's fused march kernel in Pallas
interpret mode, on identical inputs: the reference's params, z interval
and payload.

Tolerance: rgb PSNR >= 45 dB and T within 2e-2. The reference rounds the
warp weights and the stacked channels to bf16 for its matmuls
(pallas_slab.py:239, 503-505); the port keeps them in f32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.ops import pallas_slab
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import slab_march, slab_render

from _torch_scenes import interpret, make_cam, np32, psnr, scene

torch.set_num_threads(1)

GATE_DB = 45.0
T_ATOL = 2e-2


def _march_both(kind, bd, back, gi=32, fx=60.0, W=64, H=48, ids=None,
                crop_on=True):
    """March one pose through both packages on the reference's inputs."""
    _, g, _, jg = scene(kind, bd, "int8")
    cam = make_cam(back, width=W, height=H, fx=fx)
    jopt = JOpt(max_steps=512)
    perm, flip, slope = j_slab.choose_axis(jg, cam.transform, cam.fx,
                                           cam.fy, W, H)
    assert slope < j_slab.MAX_SLAB_SLOPE
    crop = (j_slab.inplane_crop(jg, perm, float(jopt.sigma_thresh))
            if crop_on else None)
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, W, H, jopt, gi)
    params, zb = j_slab._pallas_frame_fields(jg, geom, perm, flip, jopt)
    planar = j_slab._permuted_grid(jg, perm, True, crop=crop)[0]
    if ids is None:
        ids = jg.slab_ids(perm[0], flip, jopt.sigma_thresh)
    want = pallas_slab.march_slabs(
        planar, params, jg.qscale, zb, jg.G, gi, jg.data_dim, jg.basis_dim,
        perm, slab_ids=tuple(ids), sig2=True, flip=flip, bbox_full=True,
        dir_win=True, k_per_step=4, crop=crop)
    got = slab_march.march_slabs(
        torch.tensor(np.asarray(planar)),
        torch.tensor(np.asarray(params))[None], g.qscale,
        torch.tensor(np.asarray(zb))[None], g.G, gi, g.data_dim,
        g.basis_dim, perm, slab_ids=tuple(ids), sig2=True, flip=flip,
        bbox_full=True, dir_win=True, k_per_step=4, crop=crop)
    return got[0].numpy(), np32(want), crop


def _assert_close(got, want):
    assert np.all(np.isfinite(got))
    p = psnr(got[:3], want[:3])
    assert p >= GATE_DB, f"rgb PSNR {p:.2f} dB"
    np.testing.assert_allclose(got[3], want[3], atol=T_ATOL)
    # the scene was actually seen
    assert float(want[3].min()) < 0.5


@pytest.mark.parametrize("bd,back", [
    (4, (1.0, 0.25, 0.35)), (4, (-0.2, -0.1, -1.0)),
    (16, (0.3, 1.0, 0.5)),
])
def test_march_dense_matches_interpret(monkeypatch, bd, back):
    with interpret(monkeypatch):
        got, want, _ = _march_both("dense", bd, back)
    _assert_close(got, want)


@pytest.mark.parametrize("back", [(1.0, 0.3, 0.35), (0.2, -1.0, 0.4)])
def test_march_sparse_cropped_matches_interpret(monkeypatch, back):
    """The solid scene with the in-plane crop (granularity shrunk in both
    packages): the payload holds only the occupied sub-box, cell indices
    stay global."""
    with interpret(monkeypatch, crop_mult=4):
        got, want, crop = _march_both("solid", 16, back)
    assert crop is not None
    y0, Gy, x0, Gx = crop
    assert Gy < 16 or Gx < 16
    _assert_close(got, want)


def test_march_culled_dynamic_matches_interpret(monkeypatch):
    """A culled, non-contiguous slab list through the reference's dynamic
    (scalar-prefetch window list) path."""
    _, g, _, _ = scene("dense", 4, "int8")
    with interpret(monkeypatch, force_dynamic=True):
        perm_ids = list(range(g.G))
        ids = [i for i in perm_ids if i % 8 not in (2, 3, 4, 5, 6)]
        got, want, _ = _march_both("dense", 4, (1.0, 0.25, 0.35), ids=ids)
    _assert_close(got, want)


def test_march_steep_pose_gi_not_G(monkeypatch):
    """A steep but slab-compatible pose (boundary slope above 2.5) with
    gi != G: long per-slab spans over several cells."""
    _, g, _, jg = scene("dense", 4, "int8")
    with interpret(monkeypatch):
        got, want, _ = _march_both("dense", 4, (1.0, 0.25, 0.35), gi=24,
                                   fx=27.0)
    cam = make_cam((1.0, 0.25, 0.35), width=64, height=48, fx=27.0)
    _, _, slope = j_slab.choose_axis(jg, cam.transform, 27.0, 27.0, 64, 48)
    assert 2.5 < slope < 4.0
    _assert_close(got, want)


def test_march_empty_slab_list_is_identity():
    """No occupied slab: the accumulator stays [0, 0, 0, 1]."""
    _, g, _, _ = scene("dense", 4, "int8")
    pay = torch.zeros((g.G, g.data_dim + 1, g.G, g.G), dtype=torch.int8)
    acc = slab_march.march_slabs(
        pay, torch.zeros((2, 30)), g.qscale, torch.zeros((2, 2, 8, 8)),
        g.G, 8, g.data_dim, g.basis_dim, (0, 1, 2), slab_ids=(), sig2=True,
        bbox_full=True, dir_win=True)
    assert torch.equal(acc[:, :3], torch.zeros((2, 3, 8, 8)))
    assert torch.equal(acc[:, 3], torch.ones((2, 8, 8)))


def test_march_pose_batch_equals_single_poses():
    """One launch over a pose batch equals the poses marched one by one
    (the batch is an explicit dimension, not a mix)."""
    _, g, _, _ = scene("dense", 4, "int8")
    from volrend_torch.utils.options import RenderOptions
    opt = RenderOptions(max_steps=512)
    cams = [make_cam(b, width=64, height=48) for b in
            ((1.0, 0.25, 0.35), (1.0, -0.2, 0.3))]
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform, 60.0,
                                            60.0, 64, 48)
    pay = slab_render.prepare_payload(g, perm, opt)

    def march(trs):
        geom = slab_render.FrameGeom(g, trs, 60.0, 60.0, perm, flip, 64, 48,
                                     opt, 32)
        params, zb = slab_render._march_frame_fields(g, geom, perm, flip,
                                                     opt)
        return slab_march.march_slabs(
            pay, params, g.qscale, zb, g.G, 32, g.data_dim, g.basis_dim,
            perm, slab_ids=g.slab_ids(perm[0], flip, opt.sigma_thresh),
            sig2=True, flip=flip, bbox_full=True, dir_win=True)

    both = march(np.stack([c.transform for c in cams]))
    for i, c in enumerate(cams):
        np.testing.assert_allclose(both[i].numpy(),
                                   march(c.transform)[0].numpy(), atol=1e-6)
