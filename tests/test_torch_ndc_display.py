"""NDC (LLFF) display poses on kernel W and its fit mode: the parameter rows
of ``display_warp.display_params_ndc`` (world2ndc's slope map folded into
the three linear forms kernel W evaluates), their fit decisions, the warp
and a pose group's frames, each against ``volrend_tpu`` on the same seeded
inputs (its Pallas kernels in interpret mode) and the positions against a
float64 evaluation of world2ndc.

Tolerances: subpixel positions within 5e-5 grid units of the float64
world2ndc chain (the rows are rounded once to float32, then evaluated in
float32) and within 2.5e-4 of the reference's float32 chain (its own error
against float64 is up to ~1.2e-4); window corners on fewer than 1e-3 of
the blocks; the fit decisions equal; the warp within the reference test's
1.2e-2 (tests/test_slab_render.py::test_superquad_warp_ndc); frames rgb
PSNR >= 45 dB and alpha within 2e-2 (the reference's bf16 warp matmuls and
emit), as tests/test_torch_ndc.py holds whole NDC frames."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import display_warp as j_dw
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import display_warp, slab_render
from volrend_torch.probes._common import ndc_exact_positions
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import interpret, ndc_cam, ndc_scene, np32, psnr

torch.set_num_threads(1)

OPT = RenderOptions(max_steps=512)
JOPT = JOpt(max_steps=512)
F64 = torch.float64

#: the reference's test_superquad_warp_ndc scene and screen
W = H = 200
GI = 96
SIDE = (200.0, 200.0, 120.0)
#: its pose, and two around it (all on the NDC z axis, one pose group)
POSES = [((0.0, 0.0, 0.2), (0.05, 0.02, 1.0)),
         ((0.04, -0.03, 0.28), (-0.06, 0.04, 1.0)),
         ((-0.05, 0.03, 0.12), (0.09, -0.03, 1.0))]
LEVELS = (((2, 2), (4, 4)), ((4, 4), (5, 5)))


@pytest.fixture(scope="module")
def grids():
    return ndc_scene("int8", seed=11, sigma_scale=40.0, ndc=SIDE)


def _geom(grids, center, back, width=W, height=H, fx=120.0, gi=GI):
    """Both packages' FrameGeom of one pose, its perm and flip."""
    _, g, _, jg = grids
    cam = ndc_cam(center, back, width=width, height=height, fx=fx)
    perm, flip, slope = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                           width, height)
    assert perm[0] == 2 and np.isfinite(slope)
    jgm = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                           perm, flip, width, height, JOPT, gi)
    tgm = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm, flip,
                                width, height, OPT, gi)
    return jgm, tgm, perm, flip, cam


def _rows(tgm, perm, ndc):
    return display_warp.display_params_ndc(
        tgm.R, tgm.fx, tgm.fy, tgm.u0, tgm.du, tgm.v0, tgm.dv, tgm.scale,
        perm, ndc, tgm.origin_w)


@pytest.mark.parametrize("center,back", POSES)
def test_ndc_rows_positions(grids, center, back):
    """The rows' subpixel positions (the plain version of kernel W's
    position()) at both production levels: within 5e-5 grid units of the
    float64 world2ndc chain, within 2.5e-4 of the reference's
    _sub_slopes(ndc=), window corners on < 1e-3 of the blocks."""
    jgm, tgm, perm, _, _ = _geom(grids, center, back)
    ndc = grids[1].ndc
    prm = _rows(tgm, perm, ndc)
    assert prm.dtype == torch.float32 and tuple(prm.shape) == (1, 16)
    for B, win in LEVELS:
        gy, gx = display_warp._display_positions(prm, B, H, W)
        ey, ex = ndc_exact_positions(tgm, perm, ndc, B, H, W)
        inside = ((ey >= 0) & (ey <= GI - 1) & (ex >= 0) & (ex <= GI - 1))
        assert float(inside.to(F64).mean()) > 0.5       # mostly in the grid
        for a, b in ((gy, ey), (gx, ex)):
            assert float((a.to(F64) - b).abs().max()) <= 5e-5
        jy, jx = j_dw._sub_slopes(
            jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0, jgm.du, jgm.v0,
            jgm.dv, jgm.scale, ndc=ndc, origin=jgm.origin_w, B=B)
        for a, b in ((gy, jy), (gx, jx)):
            np.testing.assert_allclose(a[0].numpy(), np32(b), atol=2.5e-4)
        got = display_warp._window_corners(gy, gx, GI, win)
        want = j_dw._level_geometry(
            (jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0, jgm.du, jgm.v0,
             jgm.dv, jgm.scale, ndc, jgm.origin_w), GI, B, win)
        for a, b in zip(got[3:5], want[3:5]):
            assert float(np.mean(a[0].numpy() != np.asarray(b))) < 1e-3


@pytest.mark.parametrize("gi,fx", [(GI, 120.0), (184, 120.0), (200, 60.0)])
def test_ndc_fit_decisions(grids, gi, fx):
    """level_fit_counts_ref on the rows decides each level as the
    reference's _level_fits on its full-resolution world2ndc slopes, for
    each pose: at the reference test's grid every level fits; on finer
    grids and a wider field of view the (4, 4) x (5, 5) level misfits,
    some poses by a few blocks past the 1e-3 threshold."""
    ndc = grids[1].ndc
    decided = []
    for center, back in POSES:
        jgm, tgm, perm, _, _ = _geom(grids, center, back, fx=fx, gi=gi)
        prm = _rows(tgm, perm, ndc)
        counts = display_warp.level_fit_counts_ref(prm, LEVELS, gi, H, W)
        got = display_warp._fits_from_counts(counts, LEVELS, H, W)[:, 0]
        jslopes = j_dw._pixel_slopes(
            jgm.R, jgm.fx, jgm.fy, W, H, gi, perm, jgm.u0, jgm.du, jgm.v0,
            jgm.dv, jgm.scale, ndc=ndc, origin=jgm.origin_w)
        want = [bool(j_dw._level_fits(*jslopes, gi, B, win))
                for B, win in LEVELS]
        assert got.tolist() == want, (center, counts[:, 0].tolist())
        decided += want
    assert all(decided) == (gi == GI)


def _no_table_route(monkeypatch):
    """Make the PyTorch geometry, kernels B and C and the table warp raise
    (the NDC display path must not reach them) and count the poses of each
    call of kernel W's plain version."""
    def refuse(*a, **kw):
        raise AssertionError("the NDC display path left kernel W")

    for name in ("_table_warp", "_level_geometry", "_pixel_slopes",
                 "_sub_slopes", "build_table", "combine_emit"):
        monkeypatch.setattr(display_warp, name, refuse)
    real = display_warp.warp_display_ref
    calls = []

    def warp_ref(inter, prm, sel, *a, **kw):
        calls.append(int(sel.shape[0]))
        return real(inter, prm, sel, *a, **kw)

    monkeypatch.setattr(display_warp, "warp_display_ref", warp_ref)
    return calls


def test_ndc_warp_matches_reference(grids, monkeypatch):
    """warp_to_screen_sq(ndc=) on the rows (kernel W's plain version, one
    call a level) against the reference's warp_to_screen_sq(ndc=) in
    interpret mode on the reference test's inputs: atol 1.2e-2."""
    jgm, tgm, perm, _, _ = _geom(grids, *POSES[0])
    ndc = grids[1].ndc
    rng = np.random.default_rng(13)
    inter = rng.uniform(0.0, 1.0, (GI, GI, 4)).astype(np.float32)
    with interpret(monkeypatch):
        want = np32(jax.jit(lambda it: j_dw.warp_to_screen_sq(
            it, JOPT, jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0,
            jgm.du, jgm.v0, jgm.dv, jgm.scale, ndc=ndc,
            origin=jgm.origin_w))(jnp.asarray(inter)))
    calls = _no_table_route(monkeypatch)
    slab_render._warp_to_screen_ref.poses = 0
    got = display_warp.warp_to_screen_sq(
        torch.as_tensor(inter)[None], OPT, tgm.R, tgm.fx, tgm.fy, W, H, GI,
        perm, tgm.u0, tgm.du, tgm.v0, tgm.dv, tgm.scale, ndc=ndc,
        origin=tgm.origin_w)
    assert calls == [1] and slab_render._warp_to_screen_ref.poses == 0
    np.testing.assert_allclose(got[0].numpy(), want, atol=1.2e-2)
    assert float(want[..., 3].max()) > 0.5


def test_ndc_group_render_frames_matches_interpret(monkeypatch):
    """One pose group of three NDC poses through render_frames at 64^2,
    gi=32, RGBA8 (the fit plan's rows, one fit-mode call, kernel W's plain
    version), against the reference's render_frames with its kernels in
    interpret mode, both at the cascade's (2, 2) x (4, 4) level (the
    reference's interpret-mode compile of each level dominates): rgb PSNR
    >= 45 dB and alpha within 2e-2 for each pose."""
    grids = ndc_scene()
    _, g, _, jg = grids
    cams = [ndc_cam(c, b, width=64, height=64, fx=70.0)
            for c, b in ((POSES[0][0], POSES[0][1]),
                         ((0.02, -0.01, 0.24), (-0.03, 0.03, 1.0)),
                         ((-0.02, 0.02, 0.16), (0.07, -0.01, 1.0)))]
    groups = {j_slab.choose_axis(jg, c.transform, c.fx, c.fy, 64, 64)[:2]
              for c in cams}
    assert len(groups) == 1
    (perm, flip), = groups
    trs = np.stack([c.transform for c in cams]).astype(np.float32)
    level = (((2, 2), (4, 4)),)
    monkeypatch.setattr(j_dw, "_CASCADE", level)
    monkeypatch.setattr(display_warp, "_CASCADE", level)
    with interpret(monkeypatch):
        want = np32(j_slab.render_frames(
            jg, jnp.asarray(trs), 70.0, 70.0, perm, flip, 64, 64, JOPT,
            gi=32, out_dtype=jnp.uint8))
    calls = _no_table_route(monkeypatch)
    slab_render._warp_to_screen_ref.poses = 0
    got = np32(slab_render.render_frames(
        g, trs, 70.0, 70.0, perm, flip, 64, 64, OPT, gi=32,
        out_dtype=torch.uint8))
    assert calls == [3] and slab_render._warp_to_screen_ref.poses == 0
    got, want = got / 255.0, want / 255.0
    for p in range(len(cams)):
        db = psnr(got[p, ..., :3], want[p, ..., :3])
        assert db >= 45.0, f"pose {p}: rgb PSNR {db:.2f} dB"
        np.testing.assert_allclose(got[p, ..., 3], want[p, ..., 3],
                                   atol=2e-2)
        assert float(want[p, ..., 3].max()) > 0.5
