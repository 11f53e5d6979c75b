"""Per-pose-group geometry of the port's slab path against the reference:
(perm, flip), the in-plane crop, slab lists and payloads bit for bit;
FrameGeom fields, the march params and the z planes within rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volrend_tpu.ops import pallas_slab
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import slab_march, slab_render
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import interpret, make_cam, scene

torch.set_num_threads(1)

BACKS = [(1.0, 0.25, 0.35), (-0.2, -0.1, -1.0), (0.3, 1.0, 0.5),
         (-1.0, 0.6, 0.1), (0.05, -0.9, 0.6)]
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("back", BACKS)
@pytest.mark.parametrize("fx", [60.0, 18.0])
def test_choose_axis_matches(back, fx):
    _, g, _, jg = scene("dense", 4, "int8")
    cam = make_cam(back, width=64, height=48, fx=fx)
    got = slab_render.choose_axis(g, cam.transform, cam.fx, cam.fy, 64, 48)
    want = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy, 64, 48)
    assert got[:2] == want[:2]
    assert got[2] == want[2] or (np.isinf(got[2]) and np.isinf(want[2]))
    assert slab_render.compatible(g, cam.transform, cam.fx, cam.fy, 64,
                                  48) == j_slab.compatible(
        jg, cam.transform, cam.fx, cam.fy, 64, 48)


@pytest.mark.parametrize("mult", [None, 4, 8])
def test_inplane_crop_and_slab_ids_match(monkeypatch, mult):
    """The in-plane crop (at the production granularity and shrunk, as the
    reference's crop tests shrink it) and the march-ordered slab lists of
    every axis and direction are the reference's."""
    _, g, _, jg = scene("solid", 4, "int8")
    if mult is not None:
        for mod in (j_slab, slab_render):
            monkeypatch.setattr(mod, "_CROP_MULT_Y", mult)
            monkeypatch.setattr(mod, "_CROP_MULT_X", mult)
    crops = set()
    for perm in ((0, 1, 2), (0, 2, 1), (1, 2, 0), (1, 0, 2), (2, 0, 1),
                 (2, 1, 0)):
        for th in (1e-2, 5.0):
            c = slab_render.inplane_crop(g, perm, th)
            assert c == j_slab.inplane_crop(jg, perm, th)
            crops.add(c)
        for flip in (False, True):
            assert g.slab_ids(perm[0], flip, 1e-2) == jg.slab_ids(
                perm[0], flip, 1e-2)
    if mult == 4:
        assert any(c is not None for c in crops)   # the scene is croppable
    monkeypatch.setattr(slab_render, "_INPLANE_CROP", False)
    assert slab_render.inplane_crop(g, (0, 1, 2), 1e-2) is None


@pytest.mark.parametrize("kind,perm", [("dense", (0, 2, 1)),
                                       ("solid", (1, 2, 0))])
def test_prepare_payload_bit_equal(monkeypatch, kind, perm):
    _, g, _, jg = scene(kind, 16, "int8")
    opt = RenderOptions()
    with interpret(monkeypatch, crop_mult=4):
        want = np.asarray(j_slab.prepare_payload(jg, perm, JOpt()))
        got = slab_render.prepare_payload(g, perm, opt)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def _geoms(back, fx=60.0, W=64, H=48, gi=32, kind="dense"):
    _, g, _, jg = scene(kind, 4, "int8")
    cam = make_cam(back, width=W, height=H, fx=fx)
    perm, flip, _ = slab_render.choose_axis(g, cam.transform, cam.fx,
                                            cam.fy, W, H)
    opt, jopt = RenderOptions(), JOpt()
    tg = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm,
                               flip, W, H, opt, gi)
    jgm = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                           perm, flip, W, H, jopt, gi)
    return g, jg, tg, jgm, perm, flip, opt, jopt


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=name)


@pytest.mark.parametrize("back", BACKS[:4])
def test_frame_geom_fields_match(back):
    g, jg, tg, jgm, perm, flip, _, _ = _geoms(back)
    for name in ("cz", "cy", "cx", "u0", "du", "v0", "dv", "z0_depth"):
        _close(getattr(tg, name)[0].numpy(), getattr(jgm, name), name)
    for name in ("uy", "ux", "z_lo_pix", "z_hi_pix"):
        _close(getattr(tg, name)[0].numpy(), getattr(jgm, name), name)
    _close(tg.dirM[0].numpy(), jgm.dirM, "dirM")
    _close(tg.lo, jgm.lo, "lo")
    _close(tg.hi, jgm.hi, "hi")
    assert float(tg.sgn) == float(jgm.sgn)


@pytest.mark.parametrize("back", BACKS[:3])
def test_march_params_and_z_planes_match(back):
    """The 30-slot params and the four z planes (z interval, dt_pix,
    tview) the kernel reads."""
    g, jg, tg, jgm, perm, flip, opt, jopt = _geoms(back, kind="solid")
    params, zb = slab_render._march_frame_fields(g, tg, perm, flip, opt)
    jparams, jzb = j_slab._pallas_frame_fields(jg, jgm, perm, flip, jopt)
    assert tuple(params.shape) == (1, 30)
    _close(params[0].numpy(), jparams, "params")
    _close(zb[0].numpy(), jzb, "zbounds")
    m = slab_march.march_inputs(torch.zeros((g.G, 1, g.G, g.G)), params, zb,
                                g.G, 32)
    j31 = jnp.concatenate([jparams, jnp.zeros((1,), jnp.float32)])
    jplanes = pallas_slab._zb_planes(j31, jzb, g.G, 32)
    _close(m["zb"][0].numpy(), jplanes, "zb planes")
    assert tuple(m["params"].shape) == (1, 31)


def test_frame_geom_batches_poses():
    """A pose batch's FrameGeom equals the per-pose ones, pose by pose."""
    _, g, _, _ = scene("dense", 4, "int8")
    cams = [make_cam(b, width=64, height=48) for b in
            ((1.0, 0.25, 0.35), (1.0, -0.2, 0.3), (0.9, 0.1, -0.4))]
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform,
                                            cams[0].fx, cams[0].fy, 64, 48)
    opt = RenderOptions()
    tr = np.stack([c.transform for c in cams])
    batch = slab_render.FrameGeom(g, tr, 60.0, 60.0, perm, flip, 64, 48,
                                  opt, 32)
    for i, c in enumerate(cams):
        one = slab_render.FrameGeom(g, c.transform, 60.0, 60.0, perm, flip,
                                    64, 48, opt, 32)
        for name in ("u0", "du", "z_lo_pix", "z_hi_pix", "cz"):
            assert torch.equal(getattr(batch, name)[i],
                               getattr(one, name)[0]), name


@pytest.mark.parametrize("flip", [False, True])
def test_window_masks(flip):
    """March-ordered slab ids group into K-aligned windows in first-visit
    order, bit dz set for slab w*K + dz (pallas_slab.march_slabs:809-818)."""
    _, g, _, _ = scene("solid", 4, "int8")
    for axis in range(3):
        ids = g.slab_ids(axis, flip, 1e-2)
        assert ids and len(ids) < g.G        # culled: gaps in the list
        K = slab_march._march_k(g.G, 4)
        wins, masks = slab_march._window_masks(ids, K)
        assert wins == sorted(set(i // K for i in ids), reverse=flip)
        for w, m in zip(wins, masks):
            assert m == sum(1 << (i % K) for i in ids if i // K == w)
        back = [w * K + dz for w, m in zip(wins, masks)
                for dz in (range(K - 1, -1, -1) if flip else range(K))
                if (m >> dz) & 1]
        assert back == list(ids)


def test_default_gi_matches():
    _, g, _, jg = scene("dense", 4, "int8")
    assert slab_render.default_gi(g) == j_slab.default_gi(jg) == 128


@pytest.mark.parametrize("G, world, ndc", [(8, 128, 128), (64, 128, 128),
                                           (128, 128, 256), (200, 256, 512),
                                           (256, 256, 512), (1024, 512, 512)])
def test_default_gi_doubles_on_ndc_grids(G, world, ndc):
    """A world grid takes the reference's grid-matched gi; an NDC grid,
    whose x and y span the whole frame, takes the reference's rule at 2G
    (bench.py's NDC scene, G=128, renders at 256)."""
    for cfg, want in ((None, world), ((800.0, 800.0, 1111.0), ndc)):
        fake = type("g", (), {"G": G, "ndc": cfg})
        ref = type("g", (), {"G": G * (2 if cfg else 1)})
        assert slab_render.default_gi(fake) == j_slab.default_gi(ref) == want
