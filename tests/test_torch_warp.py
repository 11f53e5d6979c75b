"""The superquad display warp's stages in the port against the reference
(Pallas in interpret mode): kernel B's table bit for bit, kernel C's
tent-combine and emit, and the cascade geometry (the whole warp:
test_torch_warp_screen.py).

Tolerances: float32 frames within 1.2e-2 (two bf16 ulps on display-range
values: the reference emits through bf16 one-hot matmuls, the port in
f32), uint8 frames within one display quantum."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import display_warp as j_dw
from volrend_torch.ops import display_warp

from _torch_scenes import GI, H, W, interpret, warp_geom as _geom, \
    warp_jargs as _jargs, warp_targs as _targs

torch.set_num_threads(1)

ATOL_F32 = 1.2e-2


@pytest.mark.parametrize("win", [(4, 4), (5, 5)])
def test_build_table_bit_equal(monkeypatch, win):
    """Kernel B's plain version equals the reference's planar int8 table
    build (quantize + shifted planes + transpose), bit for bit."""
    _, _, _, inter = _geom()
    planar = np.ascontiguousarray(np.moveaxis(inter, -1, 0))
    # values exactly on rounding ties and outside [0, 1] too
    planar[0, :4, :4] = np.array([0.5, 1.5, 2.5, -0.3]) / 255.0
    planar[1, :2, :2] = [[1.7, -2.0], [1.0, 0.0]]
    with interpret(monkeypatch):
        want = np.asarray(j_dw._build_table(jnp.asarray(planar), GI,
                                            dtype=jnp.int8, planar=True,
                                            win=win))
    got = display_warp.build_table(torch.as_tensor(planar)[None], win)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("B,win", [((2, 2), (4, 4)), ((4, 4), (5, 5))])
def test_level_geometry_matches(B, win):
    jgm, tg, perm, _ = _geom()
    want = j_dw._level_geometry(_jargs(jgm, perm), GI, B, win)
    got = display_warp._level_geometry(_targs(tg, perm), GI, B, win)
    for name, a, b in zip(("gys", "gxs", "okm"), got[:3], want[:3]):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=name)
    for a, b in zip(got[3:], want[3:]):
        assert float(np.mean(a[0].numpy() != np.asarray(b))) < 1e-3
    gyf, gxf = display_warp._pixel_slopes(*_targs(tg, perm))
    jgyf, jgxf = j_dw._pixel_slopes(*_jargs(jgm, perm))
    np.testing.assert_allclose(gyf[0].numpy(), np.asarray(jgyf), atol=1e-4)
    fits = display_warp._level_fits(gyf, gxf, GI, B, win)
    assert bool(fits[0]) == bool(j_dw._level_fits(jgyf, jgxf, GI, B, win))


@pytest.mark.parametrize("B,win,out_u8", [((2, 2), (4, 4), False),
                                          ((4, 4), (5, 5), True)])
def test_combine_emit_matches_interpret(monkeypatch, B, win, out_u8):
    """Kernel C's plain version against the reference's tent-combine
    kernel on the reference's table and geometry."""
    jgm, _, perm, inter = _geom()
    By, Bx = B
    Hh, Wh = H // By, W // Bx
    W3 = GI - win[1] + 1
    planar = jnp.asarray(np.moveaxis(inter, -1, 0))
    with interpret(monkeypatch):
        gys, gxs, okm, Y0, X0 = j_dw._level_geometry(_jargs(jgm, perm), GI,
                                                     B, win)
        tbl = j_dw._build_table(planar, GI, dtype=jnp.int8, planar=True,
                                win=win)
        qgp = jnp.transpose(tbl[Y0 * W3 + X0], (2, 0, 1))
        ry = gys - Y0.astype(jnp.float32)[None]
        rx = gxs - X0.astype(jnp.float32)[None]
        od = jnp.uint8 if out_u8 else jnp.float32
        want = np.asarray(j_dw._combine_emit(
            qgp, ry, rx, okm, Hh, Wh, 1.0, B=B, qscale=1.0 / 255.0,
            qshift=128.0 / 255.0, out_dtype=od, win=win)).reshape(H, W, 4)
    t = lambda a: torch.tensor(np.asarray(a))[None]
    got = display_warp.combine_emit(
        t(tbl), t(Y0), t(X0), t(ry), t(rx), t(okm), GI, H, W, B, win, 1.0,
        out_dtype=torch.uint8 if out_u8 else None)[0]
    if out_u8:
        assert got.dtype == torch.uint8
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)
        np.testing.assert_array_equal(got.numpy()[..., 3] == 0.0,
                                      want[..., 3] == 0.0)


def test_norm_cascade_and_usable_match():
    for block in (None, 2, 4, (2, 4), ((4, 4), (5, 5)),
                  (((2, 2), (4, 4)), ((4, 4), (5, 5)))):
        assert display_warp._norm_cascade(block) == j_dw._norm_cascade(block)
    for args in ((200, 200, 96), (800, 800, 256), (64, 48, 32), (30, 30, 8),
                 (800, 800, 900)):
        for B, win in display_warp._CASCADE:
            assert display_warp.usable(*args, block=B, win=win) == (
                args[0] % B[1] == 0 and args[1] % B[0] == 0
                and args[2] >= 8 and args[2] >= 2 * max(win)
                and args[2] <= min(args[:2]))


def test_to_display_dtype_matches():
    x = np.linspace(-0.2, 1.2, 101, dtype=np.float32)
    x[50] = 127.5 / 255.0
    got = display_warp.to_display_dtype(torch.as_tensor(x), torch.uint8)
    want = j_dw.to_display_dtype(jnp.asarray(x), jnp.uint8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert display_warp.to_display_dtype(torch.as_tensor(x), None).dtype \
        == torch.float32
