"""NDC (LLFF) trees through the port: ``render_exact.world2ndc`` and the
exact renderer, ``slab_render.choose_axis``, ``FrameGeom``,
``display_warp._sub_geometry``, the display march and warp (kernels M and
W as their plain versions on the CPU), whole frames and frame training,
each against ``volrend_tpu`` on the same seeded inputs (its Pallas kernels
in interpret mode) and against the port's exact renderer.

Tolerances: the exact renderer 1e-5 (float32, one order of operations);
choose_axis bit-equal perm and flip, slope rtol 1e-6 (float64 host math);
FrameGeom rtol 1e-6; subpixel positions atol 1e-4 and window corners on
fewer than 1e-3 of blocks (float32 rounding of the warped rays); frames
rgb PSNR >= 45 dB and alpha within 2e-2 (the reference's bf16 warp
matmuls and emit); the slab path against the exact renderer at the
reference tests' floors (33 dB); the training march and its backward as
tests/test_torch_slab_grad.py holds them (5e-6; relative L2 1e-5)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import display_warp as j_dw
from volrend_tpu.ops import pallas_slab, render_jax
from volrend_tpu.ops import slab_grad as j_sg
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch import train
from volrend_torch.ops import (display_warp, render_exact, slab_grad,
                               slab_march, slab_render)
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import interpret, ndc_cam, ndc_scene, np32, psnr

torch.set_num_threads(1)

OPT = RenderOptions(max_steps=512)
JOPT = JOpt(max_steps=512)

#: the five poses of the reference's test_ndc_slab_matches_exact: behind
#: the z = 0 plane, off-axis, between the scene and z = 0, and two near the
#: z = 0 plane (near-parallel warped rays)
POSES = [((0.0, 0.0, 0.2), (0.05, 0.02, 1.0)),
         ((0.1, -0.05, 0.35), (-0.08, 0.05, 1.0)),
         ((0.0, 0.0, -0.4), (0.0, 0.0, 1.0)),
         ((0.0, 0.0, 1e-3), (0.02, 0.01, 1.0)),
         ((0.0, 0.0, -1e-4), (0.02, 0.01, 1.0))]
#: test_ndc_interior_camera_falls_back: inside the scene, on z = 0
INTERIOR = [(0.0, 0.0, -2.0), (0.0, 0.0, 0.0)]


def test_world2ndc_matches_reference():
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-0.2, 0.2, (64, 2)),
                        rng.uniform(-0.5, 0.5, (64, 1))], 1)
    d = np.concatenate([rng.uniform(-0.3, 0.3, (64, 2)),
                        -rng.uniform(0.5, 1.0, (64, 1))], 1)
    o, d = o.astype(np.float32), d.astype(np.float32)
    ndc = (800.0, 800.0, 1111.0)
    got = render_exact.world2ndc(ndc, torch.tensor(d), torch.tensor(o))
    want = render_jax.world2ndc(ndc, jnp.asarray(d), jnp.asarray(o))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("center,back", POSES[:3])
def test_exact_renderer_ndc_matches_reference(center, back):
    tdev, _, jdev, _ = ndc_scene()
    cam = ndc_cam(center, back, width=24, height=20, fx=26.0)
    origins, dirs = cam.pixel_rays(xp=np)
    origins = np.ascontiguousarray(origins)
    got = render_exact.render_rays(tdev, origins, dirs, OPT).numpy()
    want = np.asarray(render_jax.render_rays(
        jdev, jnp.asarray(origins), jnp.asarray(dirs), JOPT))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert float(got[:, 3].max()) > 0.5             # the scene is in view


@pytest.mark.parametrize("center,back",
                         POSES + [(c, (0.05, 0.02, 1.0)) for c in INTERIOR])
def test_choose_axis_ndc_matches_reference(center, back):
    _, g, _, jg = ndc_scene()
    cam = ndc_cam(center, back)
    got = slab_render.choose_axis(g, cam.transform, cam.fx, cam.fy, 48, 48)
    want = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy, 48, 48)
    assert got[:2] == want[:2]
    if center in INTERIOR:
        assert not np.isfinite(got[2]) and not np.isfinite(want[2])
    else:
        assert got[0][0] == 2 and np.isfinite(got[2])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


_FIELDS = ("cz", "cy", "cx", "u0", "du", "v0", "dv", "uy", "ux", "dirM",
           "z0_depth", "z_lo_pix", "z_hi_pix")


def _geoms(grids, cam, gi, unit_slope_box=False, perm_flip=None):
    _, g, _, jg = grids
    perm, flip, _ = perm_flip or j_slab.choose_axis(
        jg, cam.transform, cam.fx, cam.fy, cam.width, cam.height)
    jgm = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                           perm, flip, cam.width, cam.height, JOPT, gi,
                           unit_slope_box=unit_slope_box)
    tgm = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm, flip,
                                cam.width, cam.height, OPT, gi,
                                unit_slope_box=unit_slope_box)
    return jgm, tgm, perm, flip


@pytest.mark.parametrize("case", ["ndc", "ndc_near_plane", "unit_box"])
def test_frame_geom_matches_reference(case):
    """FrameGeom's per-pose fields on NDC poses (the warped centre, slope
    grid, the NDC dirM, z0 on the near plane, no t > 0 clamp) and with a
    split pass's unit slope box (on a world tree), rtol 1e-6."""
    from _torch_scenes import make_cam, scene
    if case == "unit_box":
        grids = scene("dense", 4, "int8")
        cam = make_cam((1.0, 0.3, 0.4), width=48, height=48, fx=16.0)
        args = dict(unit_slope_box=True, perm_flip=((1, 2, 0), True, None))
    else:
        grids = ndc_scene()
        cam = ndc_cam(*POSES[3 if case == "ndc_near_plane" else 0])
        args = {}
    jgm, tgm, _, _ = _geoms(grids, cam, 32, **args)
    for name in _FIELDS:
        got = np32(getattr(tgm, name))[0]
        want = np32(getattr(jgm, name))
        if name == "z0_depth" and case == "unit_box":
            want = np32(jgm.cz)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


def test_slope_grid_unit_box():
    """The split pass's box is +-(1 + 2/gi), whatever the pose."""
    R = torch.eye(3)[None].repeat(2, 1, 1)
    u0, du, v0, dv = slab_render._slope_grid(
        R, torch.tensor(10.0), torch.tensor(10.0), torch.ones(3), (0, 1, 2),
        48, 48, 32, unit_slope_box=True)
    box = np.float32(1.0 + 2.0 / 32)
    assert u0.tolist() == v0.tolist() == [-box] * 2
    np.testing.assert_allclose(u0 + 31 * du, [box] * 2, rtol=1e-6)


@pytest.mark.parametrize("B,win", [((2, 2), (4, 4)), ((4, 4), (5, 5))])
def test_sub_geometry_ndc_matches_reference(B, win):
    """The superquad geometry of an NDC pose (the reference's
    test_superquad_warp_ndc scene, 200^2, gi=96): positions atol 1e-4,
    window corners on < 1e-3 of blocks, the fit predicate equal."""
    grids = ndc_scene("int8", seed=11, sigma_scale=40.0,
                      ndc=(200.0, 200.0, 120.0))
    cam = ndc_cam(width=200, height=200, fx=120.0)
    jgm, tgm, perm, _ = _geoms(grids, cam, 96)
    ndc = grids[1].ndc
    got = display_warp._sub_geometry(
        tgm.R, tgm.fx, tgm.fy, 200, 200, 96, perm, tgm.u0, tgm.du, tgm.v0,
        tgm.dv, tgm.scale, ndc=ndc, origin=tgm.origin_w, B=B, win=win)
    want = j_dw._sub_geometry(
        jgm.R, jgm.fx, jgm.fy, 200, 200, 96, perm, jgm.u0, jgm.du, jgm.v0,
        jgm.dv, jgm.scale, ndc=ndc, origin=jgm.origin_w, B=B, win=win)
    for name, a, b in zip(("gys", "gxs", "okm"), got[:3], want[:3]):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=name)
    for a, b in zip(got[3:5], want[3:5]):
        assert float(np.mean(a[0].numpy() != np.asarray(b))) < 1e-3
    assert bool(got[5][0]) == bool(want[5])
    assert float(np.asarray(want[2]).mean()) > 0.5    # mostly in the grid


def test_march_plain_ndc_matches_interpret(monkeypatch):
    """Kernel M's plain version on an NDC pose (the NDC dirM's constant
    column and off-slot terms, window directions) against the reference's
    kernel in interpret mode on the reference's inputs (the int8 grid of
    test_pallas_interpret_ndc_int8): rgb PSNR >= 45 dB, T within 2e-2."""
    _, g, _, jg = ndc_scene()
    cam = ndc_cam(width=32, height=32, fx=36.0)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       32, 32)
    gi = 32
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, 32, 32, JOPT, gi)
    params, zb = j_slab._pallas_frame_fields(jg, geom, perm, flip, JOPT)
    crop = j_slab.inplane_crop(jg, perm, float(JOPT.sigma_thresh))
    planar = j_slab._permuted_grid(jg, perm, True, crop=crop)[0]
    ids = tuple(jg.slab_ids(perm[0], flip, JOPT.sigma_thresh))
    kw = dict(slab_ids=ids, sig2=True, flip=flip, bbox_full=True,
              dir_win=True, k_per_step=4, crop=crop)
    with interpret(monkeypatch):
        want = np32(pallas_slab.march_slabs(
            planar, params, jg.qscale, zb, jg.G, gi, jg.data_dim,
            jg.basis_dim, perm, **kw))
    got = slab_march.march_slabs(
        torch.tensor(np.asarray(planar)),
        torch.tensor(np.asarray(params))[None], g.qscale,
        torch.tensor(np.asarray(zb))[None], g.G, gi, g.data_dim,
        g.basis_dim, perm, **kw)[0].numpy()
    assert np.all(np.isfinite(got))
    p = psnr(got[:3], want[:3])
    assert p >= 45.0, f"rgb PSNR {p:.2f} dB"
    np.testing.assert_allclose(got[3], want[3], atol=2e-2)
    assert float(want[3].min()) < 0.5                 # the scene was seen
    # the port's own params for this pose are the reference's
    tgm = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm,
                                flip, 32, 32, OPT, gi)
    tprm, _ = slab_render._march_frame_fields(g, tgm, perm, flip, OPT)
    np.testing.assert_allclose(tprm[0].numpy(), np.asarray(params),
                               rtol=1e-6, atol=1e-7)


def test_render_frame_ndc_matches_interpret(monkeypatch):
    """A whole NDC frame at 64^2, gi=32, RGBA8 (the superquad warp applies:
    the port's NDC poses take kernel W on their NDC rows) against the
    reference's render_frame with its kernels in interpret mode, both at
    the cascade's (2, 2) x (4, 4) level (one level: the reference's
    interpret-mode compile of each level dominates this test)."""
    out_u8 = True
    _, g, _, jg = ndc_scene()
    cam = ndc_cam(width=64, height=64, fx=70.0)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       64, 64)
    level = (((2, 2), (4, 4)),)
    monkeypatch.setattr(j_dw, "_CASCADE", level)
    monkeypatch.setattr(display_warp, "_CASCADE", level)
    with interpret(monkeypatch):
        want = np32(j_slab.render_frame(
            jg, jnp.asarray(cam.transform), cam.fx, cam.fy, perm, flip, 64,
            64, JOPT, gi=32, out_dtype=jnp.uint8 if out_u8 else None))
    slab_render._warp_to_screen_ref.poses = 0
    got = slab_render.render_frame(
        g, cam.transform, cam.fx, cam.fy, perm, flip, 64, 64, OPT, gi=32,
        out_dtype=torch.uint8 if out_u8 else None)
    assert slab_render._warp_to_screen_ref.poses == 0    # W, no ref
    got = np32(got)
    if out_u8:
        got, want = got / 255.0, want / 255.0
    p = psnr(got[..., :3], want[..., :3])
    assert p >= 45.0, f"rgb PSNR {p:.2f} dB"
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=2e-2)
    assert float(want[..., 3].max()) > 0.5


@pytest.mark.parametrize("center,back", POSES)
def test_render_image_ndc_matches_exact(center, back):
    """The reference's test_ndc_slab_matches_exact on the port: every pose
    renders on the slab path and matches the port's exact renderer
    (> 33 dB; alpha masks agree except at silhouettes)."""
    tdev, g, _, _ = ndc_scene()
    cam = ndc_cam(center, back)
    ref = render_exact.render_image(tdev, cam, OPT).numpy()
    assert (ref[..., 3] > 0.5).mean() > 0.1
    out = slab_render.render_image(g, cam, OPT, gi=128)
    p = psnr(out[..., :3], ref[..., :3])
    assert p > 33.0, f"NDC slab PSNR {p:.1f} dB (center={center})"
    assert np.mean(np.abs(out[..., 3] - ref[..., 3]) > 0.5) < 0.02


def test_ndc_refusals_match_reference():
    """An interior NDC camera and an NDC split frame raise ValueError (the
    exact renderer takes them), as NDC meshes do, as in the reference."""
    _, g, _, _ = ndc_scene()
    cam = ndc_cam(center=INTERIOR[0])
    with pytest.raises(ValueError, match="not renderable"):
        slab_render.render_image(g, cam, OPT, gi=32)
    with pytest.raises(ValueError, match="world trees only"):
        slab_render.render_frame_split(g, cam.transform, cam.fx, cam.fy,
                                       48, 48, OPT, gi=32)
    ok = ndc_cam()
    with pytest.raises(ValueError, match="world trees only"):
        slab_render.render_image(g, ok, OPT, gi=32, meshes=[object()])
    with pytest.raises(ValueError, match="world trees only"):
        slab_render.render_frame(g, ok.transform, ok.fx, ok.fy, (2, 1, 0),
                                 False, 48, 48, OPT, gi=32,
                                 mesh_dist=np.zeros((48, 48)))


# ---------------------------------------------------------------------------
# frame training on an NDC tree (the reference's test_slab_grad.py:517-612)
# ---------------------------------------------------------------------------

TW = 24
TGI = 32


@pytest.fixture(scope="module")
def ndc_train():
    """The reference's ndc_train_scene (f16 bake, 24^2, fx 26) in both
    packages, with bf16-representable leaf rows."""
    tdev, g, jdev, jg = ndc_scene("f16")
    cam = ndc_cam(width=TW, height=TW, fx=26.0)
    perm, flip, slope = j_slab.choose_axis(jg, cam.transform, cam.fx,
                                           cam.fy, TW, TW)
    assert np.isfinite(slope) and perm[0] == 2
    rows = np.asarray(jnp.asarray(jdev.data, jnp.float32)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    return (tdev, g, slab_grad.build_bake_map(tdev), jdev, jg,
            j_sg.build_bake_map(jdev), cam, perm, flip, rows)


def test_ndc_training_march_matches_jax_grad_of_scan(ndc_train):
    """The training march (plain kernel M, training mode) and its backward
    on the NDC pose against the reference's scan march and jax.vjp of it,
    on the bf16-rounded payload: forward within 5e-6, cotangent relative
    L2 below 1e-5."""
    _, _, _, _, jg, _, cam, perm, flip, _ = ndc_train
    jopt = JOPT.replace(renormalize=False)
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, TW, TW, jopt, TGI)
    ids = tuple(range(jg.G - 1, -1, -1) if flip else range(jg.G))
    cfg = j_sg.SlabCfg(G=jg.G, gi=TGI, D=jg.data_dim, bd=jg.basis_dim,
                       fmt=int(jg.fmt), perm=perm, flip=flip, ids=ids,
                       opt=jopt)
    planar = jnp.transpose(jnp.asarray(jg.data, jnp.float32),
                           (perm[0], 3, perm[1], perm[2]))
    p16 = np.asarray(planar.astype(jnp.bfloat16).astype(jnp.float32))
    params = j_sg._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = jnp.stack([geom.z_lo_pix, geom.z_hi_pix])
    gm = dict(cz=geom.cz, cy=geom.cy, cx=geom.cx, uy=geom.uy, ux=geom.ux,
              z_lo=geom.z_lo_pix, z_hi=geom.z_hi_pix, scale=geom.scale,
              lo=geom.lo, hi=geom.hi, dirM=geom.dirM)
    rng = np.random.default_rng(0)
    g_acc = rng.normal(size=(TGI, TGI, 3)).astype(np.float32)
    g_T = rng.normal(size=(TGI, TGI)).astype(np.float32)

    @jax.jit
    def fwd_and_vjp(pp, ga, gt):
        out, vjp = jax.vjp(
            lambda q: j_sg._march_fwd_impl(cfg, q, jg.extra, gm), pp)
        return out, vjp((ga, gt))[0]

    (a, T), gs = fwd_and_vjp(jnp.asarray(np.transpose(p16, (0, 2, 3, 1))),
                             jnp.asarray(g_acc), jnp.asarray(g_T))
    gs = np.asarray(gs)

    tp = torch.tensor(p16).to(torch.bfloat16)
    tprm = torch.tensor(np.asarray(params))
    tzb = torch.tensor(np.asarray(zb))
    qs = torch.ones(jg.data_dim)
    acc4 = slab_march.march_slabs(
        tp, tprm[None], qs, tzb[None], cfg.G, TGI, cfg.D, cfg.bd, perm,
        slab_ids=ids, flip=flip, bbox_full=True, dir_win=False,
        train=True)[0]
    np.testing.assert_allclose(acc4[:3].numpy(),
                               np.moveaxis(np.asarray(a), -1, 0), atol=5e-6)
    np.testing.assert_allclose(acc4[3].numpy(), np.asarray(T), atol=5e-6)
    assert float(acc4[3].min()) < 0.5
    gacc4 = torch.tensor(np.concatenate([np.moveaxis(g_acc, -1, 0),
                                         g_T[None]]))
    gk = slab_march.march_slabs_bwd(
        tp, tprm, qs, tzb, gacc4, acc4, cfg.G, TGI, cfg.D, cfg.bd, perm,
        flip=flip, bbox_full=True)
    gk = np.transpose(gk.numpy(), (0, 2, 3, 1)).astype(np.float64).ravel()
    gs = gs.astype(np.float64).ravel()
    rel = float(np.linalg.norm(gk - gs) / np.linalg.norm(gs))
    assert rel < 1e-5, rel


def test_ndc_train_frame_and_gradient_match_reference(ndc_train):
    """render_frame_train on the NDC tree against the eval render (> 40 dB,
    the reference's test_ndc_train_render_matches_eval_slab) and against
    the reference's training frame (1e-5); loss_and_grad_frame's loss
    (rtol 1e-5) and pyramid gradient (relative L2 < 1e-4 per level, as
    tests/test_torch_slab_grad.py holds the world-tree frame) against
    jax.vjp of the reference's."""
    _, g, tb, _, jg, jb, cam, perm, flip, rows = ndc_train
    opt = OPT.replace(renormalize=False)
    args = (cam.transform, cam.fx, cam.fy, perm, flip, TW, TW)
    tp = slab_grad.data_to_pyramid(torch.tensor(rows), tb)
    with torch.no_grad():
        out = slab_grad.render_frame_train(tp, tb, g, *args, opt,
                                           gi=TGI).numpy()
    # the eval render of the f16 bake, by the reference
    ev = np32(j_slab.render_frame(
        jg, jnp.asarray(cam.transform), cam.fx, cam.fy, perm, flip, TW, TW,
        JOPT.replace(renormalize=False), gi=TGI))
    assert psnr(out[..., :3], ev[..., :3]) > 40.0

    tgt = np.random.default_rng(3).uniform(0, 1, (TW, TW, 4)).astype(
        np.float32)
    jp = j_sg.data_to_pyramid(jnp.asarray(rows), jb)
    tr = jnp.asarray(cam.transform)

    @jax.jit
    def frame_loss_grad(p):
        o, vjp = jax.vjp(lambda q: j_sg.render_frame_train(
            q, jb, jg, tr, cam.fx, cam.fy, perm, flip, TW, TW, JOPT,
            gi=TGI), p)
        diff = o[..., :3] - tgt[..., :3]
        ct = jnp.concatenate([2.0 * diff / diff.size,
                              jnp.zeros((TW, TW, 1), jnp.float32)], -1)
        return o, jnp.mean(diff * diff), vjp(ct)[0]

    ref, jl, jgr = frame_loss_grad(jp)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    loss, grads = slab_grad.loss_and_grad_frame(tp, tb, g, *args, tgt, OPT,
                                                gi=TGI)
    assert np.isclose(float(loss), float(jl), rtol=1e-5)
    for a, b in zip(grads, jgr):
        b = np.asarray(b, np.float64)
        if float(np.abs(b).max()) == 0.0:
            assert not bool(a.any())
            continue
        rel = float(np.linalg.norm(a.numpy() - b) / np.linalg.norm(b))
        assert rel < 1e-4, rel


def test_ndc_precise_warp_matches_reference_warp(ndc_train, monkeypatch):
    """With the precise switch on, the NDC training frame takes the
    precise superquad warp (kernels B, C and their adjoints 5, 6 as plain
    versions) from the NDC geometry, and its frame and gradient equal the
    switch-off route (autograd through the f32 reference warp) to f32
    rounding (atol 5e-5, as chip_smoke.py holds the world-tree warp)."""
    _, g, tb, _, _, _, _, _, _, rows = ndc_train
    cam = ndc_cam(width=64, height=64, fx=70.0)
    perm, flip, _ = slab_render.choose_axis(g, cam.transform, cam.fx,
                                            cam.fy, 64, 64)
    tgt = np.random.default_rng(4).uniform(0, 1, (64, 64, 4)).astype(
        np.float32)
    tp = slab_grad.data_to_pyramid(torch.tensor(rows), tb)
    args = (tp, tb, g, cam.transform, cam.fx, cam.fy, perm, flip, 64, 64,
            tgt, OPT)
    slab_render._warp_to_screen_ref.precise_poses = 0
    off = slab_grad.loss_and_grad_frame(*args, gi=32)
    assert slab_render._warp_to_screen_ref.precise_poses == 1
    monkeypatch.setattr(display_warp, "_PRECISE_SQ", True)
    slab_grad._fits_from_camera.cache_clear()
    fits = slab_grad._precise_fits_host(g, cam.transform, cam.fx, cam.fy,
                                        perm, 64, 64, 32)
    assert fits.tolist() == [True]
    on = slab_grad.loss_and_grad_frame(*args, gi=32)
    assert slab_render._warp_to_screen_ref.precise_poses == 1   # no ref
    assert np.isclose(float(on[0]), float(off[0]), rtol=1e-5)
    for a, b in zip(on[1], off[1]):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=5e-5 * max(scale, 1e-30))
    # the fit predicate's cache key holds the tree's NDC sidecar
    world = dataclasses.replace(g, ndc=None)
    key_ndc = slab_grad._fits_from_camera.cache_info().currsize
    slab_grad._precise_fits_host(world, cam.transform, cam.fx, cam.fy,
                                 perm, 64, 64, 32)
    assert slab_grad._fits_from_camera.cache_info().currsize == key_ndc + 1


def test_ndc_frame_trainer_descends(ndc_train):
    """FrameTrainer on a noisy NDC scene (the reference's
    test_ndc_frame_trainer_descends): the loss halves in 20 steps."""
    tdev, g, _, _, _, _, cam, _, _, _ = ndc_train
    opt = OPT.replace(renormalize=False)
    target = render_exact.render_image(tdev, cam, opt).numpy()
    rng = np.random.default_rng(1)
    noisy = dataclasses.replace(tdev, data=(
        tdev.data.float() + torch.tensor(rng.normal(
            0, 0.3, tuple(tdev.data.shape)).astype(np.float32))
    ).to(torch.float16))
    tr = train.FrameTrainer(noisy, opt, lr=5e-2, gi=TGI)
    assert tr.grid.ndc == g.ndc
    losses = [tr.step_frame(cam, target) for _ in range(20)]
    assert losses[-1] < 0.5 * losses[0], losses
