"""Kernel W's plain versions (the display path's fused warp,
``display_warp.warp_display_ref``, and its fit mode,
``level_fit_counts_ref``) against the reference package on the CPU (its
Pallas kernels in interpret mode), and the fit plan that ``render_frames``
queues ahead of the march.

Tolerances: positions, window corners, misfit counts and fit decisions
bit-equal; frames against the reference's warp within one display quantum
(uint8) and 1.2e-2 (float32), the reference's bf16 emit (ROADMAP.md §3),
and bit-equal against the parent's composition of the geometry with
kernels B and C."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import display_warp as j_dw
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import display_warp, slab_march, slab_render
from volrend_torch.probes._common import mean_fits, table_warp_level
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import GI, H, W, interpret, make_cam, scene, \
    warp_geom as _geom, warp_jargs as _jargs, warp_targs as _targs

torch.set_num_threads(1)

ATOL_F32 = 1.2e-2
LEVELS = display_warp._CASCADE
OPT = RenderOptions(max_steps=512)


def _prm(targs, f=1.0):
    """The parameter rows of the warp geometry ``targs``, its slope grid
    made 1/f times finer."""
    R, fx, fy, _, _, _, perm, u0, du, v0, dv, scale = targs
    f = np.float32(f)
    return display_warp.display_params(R, fx, fy, u0, du * f, v0, dv * f,
                                       scale, perm)


def _ref_fits(jgm, perm, f=1.0):
    """The reference's fit predicate of every cascade level."""
    ja = list(_jargs(jgm, perm))
    ja[8] = ja[8] * np.float32(f)
    ja[10] = ja[10] * np.float32(f)
    gyf, gxf = j_dw._pixel_slopes(*ja)
    return np.array([bool(j_dw._level_fits(gyf, gxf, GI, B, win))
                     for B, win in LEVELS])


def _threshold_scale(targs):
    """A slope-grid scale at which the (2, 2) x (4, 4) level's misfit count
    lies within 2 of its threshold, 1e-3 of the blocks (10 at 200^2): a
    scan for a crossing, then bisection toward the threshold itself."""
    n = (H // 2) * (W // 2) * 1e-3

    def count(f):
        return int(display_warp.level_fit_counts_ref(
            _prm(targs, f), LEVELS[:1], GI, H, W)[0, 0])

    fs = np.linspace(0.05, 0.3, 26)
    cs = [count(f) for f in fs]
    lo, hi = next((fs[i], fs[i + 1]) for i in range(len(fs) - 1)
                  if (cs[i] - n) * (cs[i + 1] - n) < 0)
    above = count(lo) > n
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        c = count(mid)
        if c == n:
            break
        if (c > n) == above:
            lo = mid
        else:
            hi = mid
    assert abs(c - n) <= 2, (mid, c)
    return mid


@pytest.mark.parametrize("pose", ["orbit", "wide_fov", "finer_grid",
                                  "threshold"])
def test_fit_counts_decide_as_reference(pose):
    """(a) The fit decisions from level_fit_counts_ref equal the
    reference's _level_fits at every cascade level: an orbit pose, the
    wide-FOV pose that misfits every level, a 7x finer slope grid, and a
    pose whose (2, 2) misfit count lies at the 1e-3 threshold (where the
    mean's rounding decides: count x float32(1 / blocks), as the card's
    torch.mean and the reference's jnp.mean take it)."""
    jgm, tg, perm, _ = _geom(fx=45.0 if pose == "wide_fov" else 280.0)
    targs = _targs(tg, perm)
    f = {"finer_grid": 1.0 / 7.0,
         "threshold": None}.get(pose, 1.0)
    if f is None:
        f = _threshold_scale(targs)
    counts = display_warp.level_fit_counts_ref(_prm(targs, f), LEVELS, GI,
                                               H, W)
    assert counts.dtype == torch.int32 and counts.shape == (len(LEVELS), 1)
    got = display_warp._fits_from_counts(counts, LEVELS, H, W)[:, 0]
    want = _ref_fits(jgm, perm, f)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's full-resolution predicate decides by the same rule
    R, fx, fy, w, h, gi, perm_, u0, du, v0, dv, scale = targs
    f32 = np.float32(f)
    gyf, gxf = display_warp._pixel_slopes(R, fx, fy, w, h, gi, perm_, u0,
                                          du * f32, v0, dv * f32, scale)
    np.testing.assert_array_equal(
        [bool(display_warp._level_fits(gyf, gxf, GI, B, win)[0])
         for B, win in LEVELS], want)
    if pose != "threshold":     # the CPU's torch.mean divides (see above)
        np.testing.assert_array_equal(mean_fits(
            (R, fx, fy, w, h, gi, perm_, u0, du * f32, v0, dv * f32, scale),
            LEVELS)[:, 0].numpy(), want)
    expect = {"orbit": [True, True], "wide_fov": [False, False],
              "finer_grid": [False, False]}.get(pose)
    if expect is not None:
        np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("B,win", [((2, 2), (4, 4)), ((4, 4), (5, 5)),
                                   ((2, 4), (4, 5)), ((4, 4), (5, 4))])
def test_display_positions_bit_equal_sub_slopes(B, win):
    """(d) The plain version's positions from the packed parameter rows
    equal _sub_slopes bit for bit, and its misfit counts equal the port's
    own full-resolution predicate (_pixel_slopes, _level_misfits)."""
    _, tg, perm, _ = _geom()
    targs = _targs(tg, perm)
    prm = _prm(targs)
    assert prm.shape == (1, 16) and prm.dtype == torch.float32
    gy, gx = display_warp._display_positions(prm, B, H, W)
    want = display_warp._sub_slopes(*targs, B=B)
    assert torch.equal(gy, want[0]) and torch.equal(gx, want[1])
    counts = display_warp.level_fit_counts_ref(prm, [(B, win)], GI, H, W)
    mis = display_warp._level_misfits(*display_warp._pixel_slopes(*targs),
                                      GI, B, win)
    assert int(counts[0, 0]) == int(mis.sum())


@pytest.fixture(scope="module")
def batch():
    """Three poses of one geometry (intermediate images of three seeds):
    the port's planes, parameter rows and geometry, the reference's
    geometry and the images."""
    jgm, tg, perm, _ = _geom()
    targs = _targs(tg, perm)
    R, fx, fy, _, _, _, _, u0, du, v0, dv, scale = targs
    rep = (R.repeat(3, 1, 1), fx, fy, W, H, GI, perm, u0.repeat(3),
           du.repeat(3), v0.repeat(3), dv.repeat(3), scale)
    inters = np.stack([_geom(seed=s)[3] for s in (7, 8, 9)])
    planes = torch.as_tensor(np.ascontiguousarray(np.moveaxis(inters, -1,
                                                              1)))
    return jgm, perm, rep, _prm(rep), planes, inters


@pytest.mark.parametrize("level,out_u8", [(0, True), (0, False),
                                          (1, True)])
def test_warp_display_ref_matches_reference(monkeypatch, batch, level,
                                            out_u8):
    """(b) warp_display_ref on a pose list, in place: the listed poses
    equal the reference's warp_to_screen_sq at that level (its interpret
    mode; uint8 within one quantum, f32 within 1.2e-2: the reference's
    bf16 emit) and the parent's composition (_level_geometry, kernel B's
    and C's plain versions) bit for bit; the unlisted slot is untouched."""
    jgm, perm, rep, prm, planes, inters = batch
    B, win = LEVELS[level]
    dt = torch.uint8 if out_u8 else torch.float32
    out = torch.full((3, H, W, 4), 7, dtype=dt)
    sel = torch.tensor([2, 0], dtype=torch.int32)
    got = display_warp.warp_display(planes, prm, sel, out.clone(), B, win,
                                    GI, 1.0)
    assert torch.equal(got[1], out[1])
    # the parent's composition of the same level
    parent = table_warp_level(rep, planes, [2, 0], B, win, 1.0,
                              dt if out_u8 else None)
    assert torch.equal(got[[2, 0]], parent)
    jopt = JOpt(max_steps=512)
    ja = _jargs(jgm, perm)
    with interpret(monkeypatch):
        warp = jax.jit(lambda it: j_dw.warp_to_screen_sq(
            it, jopt, *ja[:3], W, H, GI, perm, *ja[7:], block=(B, win),
            out_dtype=jnp.uint8 if out_u8 else None))
        for p in (2, 0):
            want = np.asarray(warp(jnp.asarray(inters[p]))).astype(
                np.float64)
            diff = np.abs(got[p].numpy().astype(np.float64) - want)
            assert diff.max() <= (1.0 if out_u8 else ATOL_F32), p


def _mixed_batch():
    """Two poses that take a superquad level and a third on a 7x finer
    slope grid, which takes the reference warp."""
    _, tg, perm, inter = _geom()
    R, fx, fy, _, _, _, _, u0, du, v0, dv, scale = _targs(tg, perm)
    k = torch.tensor([1.0, 1.0, 1.0 / 7.0])
    args = (R.repeat(3, 1, 1), fx, fy, W, H, GI, perm, u0.repeat(3),
            du.repeat(3) * k, v0.repeat(3), dv.repeat(3) * k, scale)
    its = torch.as_tensor(np.stack([inter, inter[::-1].copy(),
                                    inter[:, ::-1].copy()]))
    return args, its


@pytest.mark.parametrize("out_dtype", [torch.uint8, None])
def test_warp_with_plan_equals_without(out_dtype):
    """(c) warp_to_screen_sq given the batch's plan (queued earlier by
    plan_fits) equals it without one, and the plan's choice routes each
    pose: two superquad poses, one reference-warp pose."""
    args, its = _mixed_batch()
    R, fx, fy, w, h, gi, perm, u0, du, v0, dv, scale = args
    plan = display_warp.plan_fits(*args)
    assert plan.levels == sorted(LEVELS, key=lambda lv: -lv[0][0] * lv[0][1])
    choice = plan.choice()
    assert choice[2] == -1 and (choice[:2] >= 0).all()
    np.testing.assert_array_equal(
        plan.counts(), display_warp.level_fit_counts_ref(
            plan.prm, plan.levels, GI, H, W).numpy())
    slab_render._warp_to_screen_ref.poses = 0
    with_plan = display_warp.warp_to_screen_sq(
        its, OPT, R, fx, fy, w, h, gi, perm, u0, du, v0, dv, scale,
        out_dtype=out_dtype, plan=plan)
    without = display_warp.warp_to_screen_sq(
        its, OPT, R, fx, fy, w, h, gi, perm, u0, du, v0, dv, scale,
        out_dtype=out_dtype)
    assert slab_render._warp_to_screen_ref.poses == 2
    assert torch.equal(with_plan, without)


def test_render_frames_queues_fits_before_the_march(monkeypatch):
    """render_frames queues the fit counts right after FrameGeom, before
    kernel M, and the warp reads that plan instead of computing its own."""
    _, g, _, _ = scene("dense", 4, "int8")
    cams = [make_cam(b, width=48, height=48)
            for b in ((1.0, 0.25, 0.35), (1.0, 0.1, 0.45))]
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform,
                                            cams[0].fx, cams[0].fy, 48, 48)
    order = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            order.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(display_warp, "level_fit_counts",
                        spy("fits", display_warp.level_fit_counts))
    monkeypatch.setattr(slab_march, "march_slabs",
                        spy("march", slab_march.march_slabs))
    monkeypatch.setattr(display_warp, "warp_display",
                        spy("warp", display_warp.warp_display))
    out = slab_render.render_frames(
        g, np.stack([c.transform for c in cams]), cams[0].fx, cams[0].fy,
        perm, flip, 48, 48, OPT, gi=24, out_dtype=torch.uint8)
    assert out.shape == (2, 48, 48, 4) and out.dtype == torch.uint8
    assert order[:2] == ["fits", "march"] and order.count("fits") == 1
    assert "warp" in order
