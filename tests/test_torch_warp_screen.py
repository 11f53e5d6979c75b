"""The port's whole superquad display warp (``warp_to_screen_sq``) against
the reference: the production cascade against the reference's in Pallas
interpret mode, the (4,4)-block levels against the reference quad-gather
warp, and the per-pose fallback to the reference warp.

Tolerances: uint8 frames within one display quantum; float32 frames within
the int8 table quantum plus the reference's bf16 emit (1.6e-2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import display_warp as j_dw
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import display_warp, slab_render
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import GI, H, W, interpret, warp_geom as _geom, \
    warp_jargs as _jargs, warp_targs as _targs

torch.set_num_threads(1)


def test_warp_to_screen_sq_matches_interpret(monkeypatch):
    """The whole superquad warp with the production cascade and the RGBA8
    emit (mirrors the reference's test_superquad_warp_uint8_out; the float
    emit is held by test_combine_emit_matches_interpret and
    test_superquad_block44_levels)."""
    out_u8 = True
    jgm, tg, perm, inter = _geom()
    opt, jopt = RenderOptions(max_steps=512), JOpt(max_steps=512)
    with interpret(monkeypatch):
        assert j_dw.usable(W, H, GI)
        want = np.asarray(jax.jit(lambda it: j_dw.warp_to_screen_sq(
            it, jopt, *_jargs(jgm, perm)[:3], W, H, GI, perm,
            *_jargs(jgm, perm)[7:], out_dtype=jnp.uint8 if out_u8 else None
        ))(jnp.asarray(inter)))
    slab_render._warp_to_screen_ref.poses = 0
    got = display_warp.warp_to_screen_sq(
        torch.as_tensor(inter)[None], opt, tg.R, tg.fx, tg.fy, W, H, GI,
        perm, tg.u0, tg.du, tg.v0, tg.dv, tg.scale,
        out_dtype=torch.uint8 if out_u8 else None)[0].numpy()
    assert slab_render._warp_to_screen_ref.poses == 0    # the fast path ran
    if out_u8:
        assert got.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL_F32)
        np.testing.assert_array_equal(got[..., 3] == 0.0, want[..., 3] == 0.0)


@pytest.mark.parametrize("win", [(5, 4), (5, 5)])
def test_superquad_block44_levels(monkeypatch, win):
    """A (4,4) block with a 5x4 / 5x5 window fits a production-like pose
    and matches the reference warp within the int8 table quantum
    (mirrors test_superquad_warp_block44_win54)."""
    jgm, tg, perm, inter = _geom(seed=17)
    opt, jopt = RenderOptions(max_steps=512), JOpt(max_steps=512)
    ref = np.asarray(j_slab._warp_to_screen_ref(
        jnp.asarray(inter), jopt, *_jargs(jgm, perm)[:3], W, H, GI, perm,
        *_jargs(jgm, perm)[7:]))
    targs = _targs(tg, perm)
    gyf, gxf = display_warp._pixel_slopes(*targs)
    assert bool(display_warp._level_fits(gyf, gxf, GI, (4, 4), win)[0])
    block = (((2, 2), (4, 4)), ((4, 4), win))
    got = display_warp.warp_to_screen_sq(
        torch.as_tensor(inter)[None], opt, tg.R, tg.fx, tg.fy, W, H, GI,
        perm, tg.u0, tg.du, tg.v0, tg.dv, tg.scale, block=block)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1.6e-2)
    assert np.any(got != ref)
    np.testing.assert_array_equal(got[..., 3] == 0.0, ref[..., 3] == 0.0)


def test_wide_fov_falls_back_in_both():
    """A wide-FOV pose misfits every cascade level in both packages (the
    reference's fit predicates say so; its own
    test_superquad_warp_wide_fov_falls_back pins that its warp then equals
    its reference warp), so the port takes its reference warp, matching it
    exactly, and the two reference warps agree (float16 table and combine
    in both)."""
    jgm, tg, perm, inter = _geom(fx=45.0)
    opt, jopt = RenderOptions(max_steps=512), JOpt(max_steps=512)
    jgyf, jgxf = j_dw._pixel_slopes(*_jargs(jgm, perm))
    gyf, gxf = display_warp._pixel_slopes(*_targs(tg, perm))
    for B, win in display_warp._CASCADE:
        assert not bool(j_dw._level_fits(jgyf, jgxf, GI, B, win))
        assert not bool(display_warp._level_fits(gyf, gxf, GI, B, win)[0])
    jref = np.asarray(jax.jit(lambda it: j_slab._warp_to_screen_ref(
        it, jopt, *_jargs(jgm, perm)[:3], W, H, GI, perm,
        *_jargs(jgm, perm)[7:]))(jnp.asarray(inter)))
    it = torch.as_tensor(inter)[None]
    slab_render._warp_to_screen_ref.poses = 0
    tsq = display_warp.warp_to_screen_sq(
        it, opt, tg.R, tg.fx, tg.fy, W, H, GI, perm, tg.u0, tg.du, tg.v0,
        tg.dv, tg.scale)[0].numpy()
    assert slab_render._warp_to_screen_ref.poses == 1
    tref = slab_render._warp_to_screen_ref(
        it, opt, tg.R, tg.fx, tg.fy, W, H, GI, perm, tg.u0, tg.du, tg.v0,
        tg.dv, tg.scale)[0].numpy()
    np.testing.assert_array_equal(tsq, tref)
    # float16 rounding of the same combine: a few f16 ulps on [0, 2]
    np.testing.assert_allclose(tref, jref, atol=4e-3)
    np.testing.assert_array_equal(tref[..., 3] == 0.0, jref[..., 3] == 0.0)


def test_cascade_mixes_levels_in_one_batch():
    """A pose batch whose poses take different branches (a superquad level
    and the reference-warp fallback) equals each pose warped alone."""
    _, tg, perm, inter = _geom()
    opt = RenderOptions(max_steps=512)
    # the second pose: the same camera on a 7x finer slope grid, so every
    # block's footprint overflows its window and the pose falls back
    du = torch.cat([tg.du, tg.du / 7.0])
    dv = torch.cat([tg.dv, tg.dv / 7.0])
    u0, v0 = tg.u0.repeat(2), tg.v0.repeat(2)
    R = tg.R.repeat(2, 1, 1)
    its = torch.as_tensor(np.stack([inter, inter[::-1].copy()]))
    slab_render._warp_to_screen_ref.poses = 0
    both = display_warp.warp_to_screen_sq(
        its, opt, R, tg.fx, tg.fy, W, H, GI, perm, u0, du, v0, dv, tg.scale,
        out_dtype=torch.uint8)
    assert slab_render._warp_to_screen_ref.poses == 1
    for i in range(2):
        one = display_warp.warp_to_screen_sq(
            its[i:i + 1], opt, R[i:i + 1], tg.fx, tg.fy, W, H, GI, perm,
            u0[i:i + 1], du[i:i + 1], v0[i:i + 1], dv[i:i + 1], tg.scale,
            out_dtype=torch.uint8)
        assert torch.equal(both[i], one[0])
