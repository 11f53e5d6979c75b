"""The precise superquad training warp of the port (``display_warp.
_PreciseWarp`` behind ``_PRECISE_SQ``: kernels B and C in their f32 table
mode forward; kernel 5, which adds into the table cotangent, and kernel 6
backward) against the
reference's ``make_warp_precise`` and its hand-written VJP, run in Pallas
interpret mode, on the CPU (the port's kernels' plain versions).

Size: 64^2 screens, gi=32 (``usable_precise`` needs gi <= min(W, H)).
Tolerances: the f32 table bit for bit; the f32 combine within 1e-5 (the
reference's hi/lo bf16 emit reconstructs f32 to ~2^-17 relative); the two
adjoints within 1e-5 of their largest entry (f32, other summation order);
the whole warp at the reference's own test's tolerances
(tests/test_slab_grad.py::test_precise_sq_warp_vjp_matches_autodiff)."""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import display_warp as j_dw
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import display_warp, slab_grad, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import interpret, ndc_cam, ndc_scene, scene

torch.set_num_threads(1)

W = H = 64
GI = 32
FX = 89.6            # the superquad tests' 200^2 pose (fx 280), scaled
FX_WIDE = 25.0       # a wide field of view: the precise level misfits
BG = 0.7             # a background other than 1 keeps bg's terms visible
OPT = RenderOptions(max_steps=512, background_brightness=BG)
JOPT = JOpt(max_steps=512, background_brightness=BG)
WIN = (4, 4)
W3 = GI - 3
HH, WH = H // 2, W // 2


def _cam(fx=FX, back=(1.0, 0.25, 0.35)):
    back = np.asarray(back, np.float64)
    back /= np.linalg.norm(back)
    return Camera.from_vectors(center=tuple(2.5 * back), v_back=tuple(back),
                               v_world_up=(0.0, 0.0, 1.0), width=W,
                               height=H, fx=fx)


@functools.lru_cache(maxsize=None)
def _jgeom(perm, flip):
    """The reference FrameGeom's warp geometry, jitted (its eager
    construction costs seconds a pose)."""
    jg = scene("dense", 4, "int8")[3]

    def geom(tr, fx):
        g = j_slab.FrameGeom(jg, tr, fx, fx, perm, flip, W, H, JOPT, GI)
        return g.R, g.fx, g.fy, g.u0, g.du, g.v0, g.dv

    return jax.jit(geom)


@functools.lru_cache(maxsize=None)
def _geom(fx=FX, seed=7):
    """Both packages' FrameGeom of one pose, perm, and a seeded (gi, gi, 4)
    intermediate image and (H, W, 4) cotangent (numpy; shared, read
    only)."""
    _, g, _, jg = scene("dense", 4, "int8")
    cam = _cam(fx)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       W, H)
    jgm = types.SimpleNamespace(scale=jg.scale, **dict(zip(
        ("R", "fx", "fy", "u0", "du", "v0", "dv"),
        _jgeom(perm, flip)(jnp.asarray(cam.transform), cam.fx))))
    tg = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm, flip,
                               W, H, OPT, GI)
    rng = np.random.default_rng(seed)
    inter = rng.uniform(0.0, 1.0, (GI, GI, 4)).astype(np.float32)
    ct = rng.normal(size=(H, W, 4)).astype(np.float32)
    return jgm, tg, perm, inter, ct


def _jargs(jgm, perm):
    return (jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0, jgm.du, jgm.v0,
            jgm.dv, jgm.scale)


def _targs(tg, perm):
    return (tg.R, tg.fx, tg.fy, W, H, GI, perm, tg.u0, tg.du, tg.v0, tg.dv,
            tg.scale)


def _t(a):
    """A reference array as a one-pose port tensor."""
    return torch.tensor(np.asarray(a))[None]


def _close_to_max(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def test_chan_and_gates_match_reference():
    for cy in range(4):
        for cx in range(4):
            for c in range(4):
                assert display_warp._chan(cy, cx, c) == j_dw._chan(cy, cx, c)
    for args in ((64, 64, 32), (800, 800, 256), (200, 200, 96),
                 (64, 64, 96), (62, 64, 32)):
        assert display_warp.usable_precise(*args) == (
            args[0] % 2 == 0 and args[1] % 2 == 0 and args[2] >= 8
            and args[2] <= min(args[:2]))
    assert display_warp._PRECISE_SQ is False and j_dw._PRECISE_SQ is False


@pytest.mark.parametrize("fx", [FX, FX_WIDE])
def test_sub_geometry_matches_reference(ref, fx):
    _, tg, perm, _, _ = _geom(fx)
    want = ref["subgeom", fx]
    got = display_warp._sub_geometry(*_targs(tg, perm))
    for name, a, b in zip(("gys", "gxs", "okm"), got[:3], want[:3]):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=name)
    for a, b in zip(got[3:5], want[3:5]):
        assert float(np.mean(a[0].numpy() != np.asarray(b))) < 1e-3
    assert bool(got[5][0]) == bool(want[5]) == (fx == FX)
    # NDC geometry, which raised before its slice: an NDC pose's geometry
    # at the precise level equals the reference's (tests/test_torch_ndc.py
    # holds the display levels)
    _, ng, _, njg = ndc_scene()
    ncam = ndc_cam(width=W, height=H, fx=fx)
    nperm, nflip, _ = j_slab.choose_axis(njg, ncam.transform, fx, fx, W, H)
    jn = j_slab.FrameGeom(njg, jnp.asarray(ncam.transform), fx, fx, nperm,
                          nflip, W, H, JOpt(max_steps=512), GI)
    tn = slab_render.FrameGeom(ng, ncam.transform, fx, fx, nperm, nflip, W,
                               H, RenderOptions(max_steps=512), GI)
    got = display_warp._sub_geometry(*_targs(tn, nperm), ndc=ng.ndc,
                                     origin=tn.origin_w)
    want = j_dw._sub_geometry(jn.R, jn.fx, jn.fy, W, H, GI, nperm, jn.u0,
                              jn.du, jn.v0, jn.dv, jn.scale, ndc=njg.ndc,
                              origin=jn.origin_w)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=1e-4)
    for a, b in zip(got[3:5], want[3:5]):
        assert float(np.mean(a[0].numpy() != np.asarray(b))) < 1e-3
    assert bool(got[5][0]) == bool(want[5])


def _adjoint_inputs(seed=3):
    """Window positions past the window's edges (the clamps) and some
    ok = 0 subpixels (the mask), so both adjoint terms are exercised; a
    table cotangent."""
    rng = np.random.default_rng(seed)
    ry = rng.uniform(-0.5, 3.5, (4, HH, WH)).astype(np.float32)
    rx = rng.uniform(-0.5, 3.5, (4, HH, WH)).astype(np.float32)
    okm = (rng.uniform(size=(4, HH, WH)) < 0.8).astype(np.float32)
    g = rng.normal(size=(H, W, 4)).astype(np.float32)
    dtblp = rng.normal(size=(64, W3, W3)).astype(np.float32)
    return ry, rx, okm, g, dtblp


@pytest.fixture(scope="module")
def ref():
    """Every reference output the tests compare with, from one pass of the
    reference in Pallas interpret mode (each computation jitted: its
    interpret-mode kernels compile once, which dominates this file's
    time). The precise warp's output and VJP come from the two rules of
    make_warp_precise's custom VJP, _precise_fwd and _precise_bwd
    (volrend_tpu/ops/display_warp.py:890-911; jax.vjp of the warp runs
    exactly these): what the reference's _warp_to_screen(precise=True)
    with its _PRECISE_SQ switch on runs for this pose, whose fit predicate
    holds (asserted by the tests; its lax.cond would compile the other
    branch too). The forward's residual geometry and output are also the
    inputs and reference of kernel C's f32 mode: the forward is
    _combine_emit(exact=True) of the reference's f32 table."""
    jgm, _, perm, inter, ct = _geom()
    ry, rx, okm, g, dtblp = _adjoint_inputs()
    gplanes = np.stack([g[p::2, q::2, c] for p in range(2)
                        for q in range(2) for c in range(4)], 0)

    def precise(x, c):
        a = _jargs(jgm, perm)
        geom = a[:3] + a[7:] + (jnp.zeros((3,), jnp.float32),)
        statics = (BG, W, H, GI, perm, None)
        out, res = j_dw._precise_fwd(x, geom, statics)
        return out, j_dw._precise_bwd(None, statics, res, c), res

    wjgm, _, wperm, winter, wct = _geom(FX_WIDE)

    def misfit(x, c):
        out, vjp = jax.vjp(lambda it: j_slab._warp_to_screen_ref(
            it, JOPT, *_jargs(wjgm, wperm)[:3], W, H, GI, wperm,
            *_jargs(wjgm, wperm)[7:], precise=True), x)
        return out, vjp(c)[0]

    out = {"misfit": jax.jit(misfit)(jnp.asarray(winter), jnp.asarray(wct))}
    for fx, jg, pm in ((FX, jgm, perm), (FX_WIDE, wjgm, wperm)):
        out["subgeom", fx] = jax.jit(
            lambda *a: j_dw._sub_geometry(*a[:3], W, H, GI, pm, *a[3:]))(
            *(_jargs(jg, pm)[:3] + _jargs(jg, pm)[7:]))
    with pytest.MonkeyPatch.context() as mp:
        with interpret(mp):
            mp.setattr(j_dw, "_PRECISE_SQ", True)
            out["table"] = np.asarray(jax.jit(lambda x: j_dw._build_table(
                x, GI, dtype=jnp.float32))(jnp.asarray(inter)))
            out["adj5"] = np.asarray(jax.jit(
                lambda *a: j_dw._combine_adjoint(*a, HH, WH, BG))(
                gplanes, ry, rx, okm))                        # (64, Hh, Wh)
            out["adj6"] = np.asarray(jax.jit(
                lambda a: j_dw._build_adjoint(a, GI))(dtblp))
            o, gr, (pry, prx, pok, flat) = jax.jit(precise)(
                jnp.asarray(inter), jnp.asarray(ct))
    out["precise"] = (o, gr)
    out["stage"] = (flat // W3, flat % W3, pry, prx, pok)
    return out


@pytest.mark.parametrize("planar", [False, True])
def test_build_table_f32_bit_equal(ref, planar):
    """Kernel B's f32 mode (plain version) equals the reference's f32
    table build (_build_table(dtype=float32)) bit for bit, from the
    interleaved layout (the precise path's) or the planar one."""
    _, _, _, inter, _ = _geom()
    src = np.ascontiguousarray(np.moveaxis(inter, -1, 0)) if planar else inter
    got = display_warp.build_table(torch.as_tensor(src)[None], WIN,
                                   dtype=torch.float32, planar=planar)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), ref["table"])
    # the channel order is _chan's
    Y, X = 5, 9
    for cy, cx, c in ((0, 0, 0), (1, 3, 2), (3, 2, 3)):
        assert got[0, Y * W3 + X, display_warp._chan(cy, cx, c)] == \
            inter[Y + cy, X + cx, c]


def test_combine_emit_f32_matches_reference(ref):
    """Kernel C's f32 table mode (plain version, qscale 1, qshift 0)
    against the reference's exact combine (_combine_emit(exact=True), as
    its precise forward calls it) on the reference's f32 table and that
    forward's geometry."""
    got = display_warp.combine_emit(
        _t(ref["table"]), *(_t(a) for a in ref["stage"]), GI, H, W, 2, WIN,
        BG, qscale=1.0, qshift=0.0)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(ref["precise"][0]), rtol=0,
                               atol=1e-5)


def _corners(case, fwd_y, fwd_x):
    """(P, Hh, Wh) window corners of a kernel 5 case: the forward's own;
    blocks collapsed eight by eight onto shared rows; or two poses, the
    second on rows of its own pattern."""
    if case == "shared":
        hh, wh = np.meshgrid(np.arange(HH), np.arange(WH), indexing="ij")
        return (hh // 8 * 3)[None], (wh // 8 * 5)[None]
    if case == "two_poses":
        return (np.stack([fwd_y, fwd_x[::-1]]),
                np.stack([fwd_x, W3 - 1 - fwd_y]))
    return fwd_y[None], fwd_x[None]


@pytest.mark.parametrize("case", ["forward", "shared", "two_poses",
                                  "masked"])
def test_combine_adjoint_matches_interpret(ref, case):
    """Kernel 5 (plain version) against the reference's _combine_adjoint
    kernel followed by its scatter into the table cotangent (np.add.at at
    the blocks' rows): the port reads the (H, W, 4) cotangent and writes
    the (P, H3*W3, 64) table; the reference takes the subpixel planes and
    writes planar channels. Cases: the precise forward's own corners
    (neighbouring blocks share rows); many blocks on each of a few rows;
    two poses, each adding into its own table (pose 1's cotangent -2x pose
    0's, so its rows are exactly -2x the reference's); every subpixel
    masked, which passes nothing."""
    ry, rx, okm, g, _ = _adjoint_inputs()
    Y0, X0 = (np.asarray(a).astype(np.int32) for a in _corners(
        case, np.asarray(ref["stage"][0]), np.asarray(ref["stage"][1])))
    P = Y0.shape[0]
    gs = np.stack([g, -2.0 * g][:P])
    if case == "masked":
        okm = np.zeros_like(okm)
    dtbl = display_warp.combine_adjoint(
        torch.tensor(gs), *(torch.tensor(np.stack([a] * P))
                            for a in (ry, rx, okm)),
        torch.tensor(Y0), torch.tensor(X0), GI, BG)
    assert tuple(dtbl.shape) == (P, W3 * W3, 64)
    if case == "masked":
        assert not bool(dtbl.any())
        return
    rows = np.asarray(ref["adj5"]).reshape(64, HH * WH).T
    want = np.zeros((P, W3 * W3, 64), np.float32)
    for p in range(P):
        np.add.at(want[p], (Y0[p] * W3 + X0[p]).reshape(-1),
                  rows * (1.0, -2.0)[p])
    _close_to_max(dtbl.numpy(), want)


def test_build_adjoint_matches_interpret(ref):
    """Kernel 6 (plain version) against the reference's _build_adjoint."""
    dtblp = _adjoint_inputs()[4]
    dtbl = torch.tensor(dtblp).reshape(64, W3 * W3).T.contiguous()[None]
    got = display_warp.build_adjoint(dtbl, GI)
    assert tuple(got.shape) == (1, GI, GI, 4)
    _close_to_max(got[0].numpy(), ref["adj6"])


def _assert_warp_close(out, grad, ref_out, ref_grad):
    np.testing.assert_allclose(out, np.asarray(ref_out), atol=5e-5)
    scale = max(float(np.abs(np.asarray(ref_grad)).max()), 1e-12)
    np.testing.assert_allclose(grad, np.asarray(ref_grad),
                               atol=5e-5 * scale, rtol=5e-4)


def _port_warp(fn, inter, ct):
    ti = torch.tensor(inter)[None].requires_grad_(True)
    out = fn(ti)
    (g,) = torch.autograd.grad(out, ti, torch.tensor(ct)[None])
    return out[0].detach().numpy(), g[0].numpy()


def test_precise_warp_and_gradient_match_reference(ref):
    """The whole _PreciseWarp (forward and torch.autograd.grad) against
    the reference's make_warp_precise and jax.vjp in interpret mode."""
    _, tg, perm, inter, ct = _geom()
    assert bool(ref["subgeom", FX][5])
    out, grad = _port_warp(lambda ti: display_warp.warp_precise(
        ti, BG, *_targs(tg, perm)), inter, ct)
    _assert_warp_close(out, grad, *ref["precise"])


def _routed(tg, perm, fits=None):
    return lambda ti: slab_render._warp_to_screen(
        ti, OPT, *_targs(tg, perm)[:3], W, H, GI, perm,
        *_targs(tg, perm)[7:], precise=True, fits=fits)


def test_routing_matches_reference_switch_on(ref, monkeypatch):
    """With _PRECISE_SQ on, _warp_to_screen(precise=True) takes the
    superquad route (no pose reaches the reference warp) and matches, for
    this fitting pose, the warp the reference's routing selects
    (make_warp_precise), forward and VJP."""
    assert bool(ref["subgeom", FX][5])
    _, tg, perm, inter, ct = _geom()
    ref_out, ref_grad = ref["precise"]
    monkeypatch.setattr(display_warp, "_PRECISE_SQ", True)
    n0 = slab_render._warp_to_screen_ref.precise_poses
    out, grad = _port_warp(_routed(tg, perm), inter, ct)
    assert slab_render._warp_to_screen_ref.precise_poses == n0
    _assert_warp_close(out, grad, ref_out, ref_grad)
    # the precise route is not the autograd reference warp's arithmetic
    monkeypatch.setattr(display_warp, "_PRECISE_SQ", False)
    off, _ = _port_warp(_routed(tg, perm), inter, ct)
    assert slab_render._warp_to_screen_ref.precise_poses == n0 + 1
    assert np.any(off != out)


def test_misfit_pose_takes_reference_warp(ref, monkeypatch):
    """A wide-FOV pose misfits the precise level in both packages; with the
    switch on the port warps it with the reference warp (as the
    reference's lax.cond does): the port's own reference warp exactly, and
    the reference's warp and VJP at the whole warp's tolerances."""
    _, tg, perm, inter, ct = _geom(FX_WIDE)
    assert not bool(ref["subgeom", FX_WIDE][5])
    plain = _port_warp(lambda ti: slab_render._warp_to_screen_ref(
        ti, OPT, *_targs(tg, perm), precise=True), inter, ct)
    monkeypatch.setattr(display_warp, "_PRECISE_SQ", True)
    n0 = slab_render._warp_to_screen_ref.precise_poses
    out, grad = _port_warp(_routed(tg, perm), inter, ct)
    assert slab_render._warp_to_screen_ref.precise_poses == n0 + 1
    np.testing.assert_array_equal(out, plain[0])
    np.testing.assert_array_equal(grad, plain[1])
    _assert_warp_close(out, grad, *ref["misfit"])


def test_mixed_batch_equals_each_pose_alone(monkeypatch):
    """A two-pose batch, one pose fitting and one not (the same camera on
    a 7x finer slope grid), equals each pose warped alone, forward and
    gradient; host-given fit predicates route as the computed ones."""
    _, tg, perm, inter, ct = _geom()
    monkeypatch.setattr(display_warp, "_PRECISE_SQ", True)
    R = tg.R.repeat(2, 1, 1)
    u0, v0 = tg.u0.repeat(2), tg.v0.repeat(2)
    du = torch.cat([tg.du, tg.du / 7.0])
    dv = torch.cat([tg.dv, tg.dv / 7.0])
    its = torch.tensor(np.stack([inter, inter[::-1].copy()])
                       ).requires_grad_(True)
    cts = torch.tensor(np.stack([ct, -ct]))

    def run(i, fits=None):
        sl = slice(None) if i is None else slice(i, i + 1)
        x = its[sl]
        out = slab_render._warp_to_screen(
            x, OPT, R[sl], tg.fx, tg.fy, W, H, GI, perm, u0[sl], du[sl],
            v0[sl], dv[sl], tg.scale, precise=True, fits=fits)
        (g,) = torch.autograd.grad(out, its, cts[sl])
        return out.detach(), g

    n0 = slab_render._warp_to_screen_ref.precise_poses
    both, g_both = run(None)
    assert slab_render._warp_to_screen_ref.precise_poses == n0 + 1
    given, g_given = run(None, fits=np.array([True, False]))
    assert torch.equal(given, both) and torch.equal(g_given, g_both)
    for i in range(2):
        one, g_one = run(i)
        assert torch.equal(both[i], one[0])
        assert torch.equal(g_both[i], g_one[i])


@pytest.mark.parametrize("fx", [FX, FX_WIDE])
def test_host_fit_predicate_matches_device_geometry(fx):
    """The training path's host-side predicate (from the camera) equals
    the one computed from FrameGeom's geometry."""
    _, g, _, _ = scene("dense", 4, "int8")
    _, tg, perm, _, _ = _geom(fx)
    cam = _cam(fx)
    host = slab_grad._precise_fits_host(g, cam.transform, cam.fx, cam.fy,
                                        perm, W, H, GI)
    # cached per camera: a revisit reuses the first visit's answer
    assert slab_grad._precise_fits_host(g, cam.transform, cam.fx, cam.fy,
                                        perm, W, H, GI) is host
    dev = display_warp._sub_geometry(*_targs(tg, perm))[5].numpy()
    np.testing.assert_array_equal(host, dev)
    assert bool(host[0]) == (fx == FX)


def test_loss_and_grad_frame_switch_on_matches_off(monkeypatch):
    """The training frame loss and pyramid gradient with the precise
    superquad warp equal those with the reference warp (port only): loss
    within 1e-5, gradient relative L2 <= 1e-4."""
    tdev, _, _, _ = scene("dense", 4, "f16")
    _, grid, _, _ = scene("dense", 4, "f16")
    bmap = slab_grad.build_bake_map(tdev)
    pyr = slab_grad.data_to_pyramid(tdev.data.float(), bmap)
    cam = _cam()
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, W, H)
    tgt = np.random.default_rng(3).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    args = (pyr, bmap, grid, cam.transform, cam.fx, cam.fy, perm, flip, W, H,
            tgt, OPT)
    res = {}
    for on in (False, True):
        monkeypatch.setattr(display_warp, "_PRECISE_SQ", on)
        n0 = slab_render._warp_to_screen_ref.precise_poses
        res[on] = slab_grad.loss_and_grad_frame(*args, gi=GI)
        assert slab_render._warp_to_screen_ref.precise_poses == n0 + (not on)
    (l_off, g_off), (l_on, g_on) = res[False], res[True]
    assert abs(float(l_on) - float(l_off)) <= 1e-5
    a = torch.cat([x.reshape(-1) for x in g_on]).double()
    b = torch.cat([x.reshape(-1) for x in g_off]).double()
    assert float(b.norm()) > 0
    assert float((a - b).norm() / b.norm()) <= 1e-4


def test_precise_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card gets no kernel."""
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        display_warp.combine_adjoint(
            meta(1, 8, 8, 4), meta(1, 4, 4, 4), meta(1, 4, 4, 4),
            meta(1, 4, 4, 4), meta(1, 4, 4), meta(1, 4, 4), 8, BG)
    with pytest.raises(RuntimeError, match="no kernel for device"):
        display_warp.build_adjoint(meta(1, 25, 64), 8)
    with pytest.raises(ValueError, match="int8 or float32"):
        display_warp.build_table(torch.zeros((1, 4, 8, 8)), WIN,
                                 dtype=torch.float16)
