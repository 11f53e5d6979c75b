"""The display march's two knobs in the PyTorch port against the JAX
reference: per-slab view directions (``slab_march._DIR_WIN = False``, the
reference's ``pallas_slab._DIR_WIN``) and bf16 SH shading
(``slab_march._BF16_SHADE``, the reference's ``_BF16_SHADE``). Kernel M's
plain version with each knob against the reference's kernel in interpret
mode, and whole frames with each switch against the reference's with the
same switch; on the CPU at small sizes."""

import numpy as np
import pytest
import torch

from _torch_scenes import interpret, make_cam, march_pair, psnr, scene
from volrend_torch.ops import slab_march, slab_render
from volrend_torch.utils.options import RenderOptions
from volrend_tpu.ops import pallas_slab
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt

torch.set_num_threads(1)

GATE_DB = 45.0      # the port's march/frame gate against the reference
T_ATOL = 2e-2       # transmittance: the reference warps in bf16
KNOB_DB = 50.0      # a knob's frame against the default frame


@pytest.mark.parametrize("knobs", ["dirslab", "bf16shade"])
@pytest.mark.parametrize("dt", ["int8", "f16"])
def test_march_knobs_match_interpret(monkeypatch, knobs, dt):
    """The plain march with per-slab directions or bf16 shading on the int8
    and the f16 bake's bf16 payload against the reference's kernel with
    the same knob in interpret mode: rgb >= 45 dB (measured 62-65 dB: the
    reference rounds its warp weights to bf16, the port does not), T
    within 2e-2; each knob moves the port's result off its default."""
    kw = {"dirslab": dict(dir_win=False),
          "bf16shade": dict(shade_bf16=True)}[knobs]
    _, g, _, jg = scene("dense", 4, dt)
    cam = make_cam((1.0, 0.25, 0.35))
    with interpret(monkeypatch):
        got, want = march_pair(g, jg, cam, JOpt(max_steps=512), **kw)
    assert psnr(got[:3], want[:3]) >= GATE_DB
    np.testing.assert_allclose(got[3], want[3], atol=T_ATOL)
    base = _port_march(g, cam)
    assert float(np.abs(got - base).max()) > 0.0


#: the run-time options bf16 shading takes in its option variant
_BF16_OPTIONS = {"rot": dict(rot_dirs=(0.3, -0.2, 0.5)),
                 "bbox": dict(render_bbox=(0.25,) * 3 + (0.75,) * 3),
                 "window": dict(basis_minmax=(1, 2))}


@pytest.mark.parametrize("option", sorted(_BF16_OPTIONS))
@pytest.mark.parametrize("dt", ["int8", "f16"])
def test_march_bf16_shade_options_match_interpret(monkeypatch, option, dt):
    """bf16 shading with rot, a bbox or a basis window (the option variant
    Var<bf16, F_SH, true, true>) on both payloads: the plain version, which
    evaluates the SH polynomials in bf16 as the kernels do, against the
    reference's kernel with _BF16_SHADE and the same option in interpret
    mode (rgb >= 45 dB, T within 2e-2, as without options), and the option
    moves the result off the bf16-shaded march without it."""
    _, g, _, jg = scene("dense", 4, dt)
    cam = make_cam((1.0, 0.25, 0.35))
    with interpret(monkeypatch):
        got, want = march_pair(g, jg, cam,
                               JOpt(max_steps=512, **_BF16_OPTIONS[option]),
                               shade_bf16=True)
    assert psnr(got[:3], want[:3]) >= GATE_DB
    np.testing.assert_allclose(got[3], want[3], atol=T_ATOL)
    base = _port_march(g, cam, shade_bf16=True)
    assert float(np.abs(got - base).max()) > 0.0


def _port_march(g, cam, gi=32, **kw):
    """The port's display march of one pose on its own inputs (plain
    version), (4, gi, gi) numpy."""
    opt = RenderOptions(max_steps=512)
    perm, flip, _ = slab_render.choose_axis(g, cam.transform, cam.fx,
                                            cam.fy, cam.width, cam.height)
    geom = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm,
                                 flip, cam.width, cam.height, opt, gi)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, opt)
    crop = slab_render.inplane_crop(g, perm, opt.sigma_thresh)
    return slab_march.march_slabs(
        slab_render.prepare_payload(g, perm, opt), params, g.qscale, zb,
        g.G, gi, g.data_dim, g.basis_dim, perm,
        slab_ids=g.slab_ids(perm[0], flip, opt.sigma_thresh),
        sig2=g.quantized, flip=flip, bbox_full=True, crop=crop,
        **{"dir_win": True, **kw})[0].numpy()


def test_dir_slab_is_one_slab_windows():
    """Per-slab directions in the display mode equal window directions
    over one-slab windows (k_per_step=1) bit for bit: the display kernel
    evaluates each voxel's basis at its window centre's distance, so the
    kernel takes dir_win=False as K = 1. The variant is named -dirslab."""
    _, g, _, _ = scene("dense", 16, "int8")
    cam = make_cam((1.0, 0.25, 0.35))
    run = [_port_march(g, cam, **k)
           for k in (dict(dir_win=False), dict(k_per_step=1),
                     dict(k_per_step=4))]
    assert np.array_equal(run[0], run[1])
    assert not np.array_equal(run[0], run[2])
    mode = slab_march.MarchMode(dir_slab=True)
    assert slab_march.display_variant(mode, 16, False) == "SH-int8-dirslab"
    mode = slab_march.MarchMode(bf16_shade=True)
    assert slab_march.display_variant(mode, 16, True) == "SH-bf16-bf16shade"


def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """float64 -> the nearest bf16 value (ties to even), by the bits:
    the f64 significand keeps 8 of its 53 bits."""
    b = x.view(np.uint64)
    drop = np.uint64(45)
    lsb = (b >> drop) & np.uint64(1)
    r = (b + (np.uint64(1) << (drop - np.uint64(1))) - np.uint64(1) + lsb) \
        & ~((np.uint64(1) << drop) - np.uint64(1))
    return r.view(np.float64)


def test_bf16_macs_round_as_fused_bf16():
    """The plain version's bf16 multiply-adds (slab_march._bf16_macs)
    against an exact emulation of the kernel's __hfma2 chain (each step
    the exact c * q + r rounded once to bf16): equal (the plain version
    rounds each f64 sum to bf16 once, _round_bf16)."""
    rng = np.random.default_rng(0)
    bd = 16
    codes = rng.integers(-128, 128, (3, bd, 40, 111)).astype(np.float32)
    bkq = rng.normal(size=(40, 111, bd)).astype(np.float32) * 0.02
    got = slab_march._bf16_macs(torch.as_tensor(codes),
                                torch.as_tensor(bkq)).numpy()
    q = _rne_bf16(bkq.astype(np.float64))
    raw = np.zeros((3, 40, 111))
    for k in range(bd):
        raw = _rne_bf16(codes[:, k].astype(np.float64) * q[..., k] + raw)
    mism = int(np.sum(got != raw))
    assert mism == 0, mism


def _sh_basis_bf16_emulated(d: np.ndarray, bd: int) -> np.ndarray:
    """kernel M's packed bf16 SH basis (csrc/slab_march_display.cu
    sh_basis2) emulated exactly: each operation in f64 on bf16 values
    (exact for a product or a fused multiply-add of bf16 values at these
    magnitudes), then rounded once to bf16 (_rne_bf16)."""
    r = _rne_bf16
    from volrend_torch.ops import basis as b

    def K(v):
        return r(np.float64(np.float32(v)))

    x, y, z = (d[..., i] for i in range(3))
    out = [np.full(x.shape, K(b._C0))]
    if bd >= 4:
        out += [r(K(-b._C1) * y), r(K(b._C1) * z), r(K(-b._C1) * x)]
    if bd >= 9:
        xx, yy, zz, xy, yz, xz = (r(u * v) for u, v in (
            (x, x), (y, y), (z, z), (x, y), (y, z), (x, z)))
        s, dd = r(xx + yy), r(xx - yy)
        C2 = b._C2
        out += [r(K(C2[0]) * xy), r(K(C2[1]) * yz),
                r(K(C2[2]) * r(2 * zz - s)), r(K(C2[3]) * xz),
                r(K(C2[4]) * dd)]
    if bd >= 16:
        C3 = b._C3
        t4, u3, v3 = r(4 * zz - s), r(3 * xx - yy), r(-3 * yy + xx)
        out += [r(r(K(C3[0]) * y) * u3), r(r(K(C3[1]) * xy) * z),
                r(r(K(C3[2]) * y) * t4),
                r(r(K(C3[3]) * z) * r(-3 * s + r(zz + zz))),
                r(r(K(C3[4]) * x) * t4), r(r(K(C3[5]) * z) * dd),
                r(r(K(C3[6]) * x) * v3)]
    if bd >= 25:
        C4 = b._C4
        z71, z73 = r(7 * zz - 1), r(7 * zz - 3)
        out += [r(r(K(C4[0]) * xy) * dd), r(r(K(C4[1]) * yz) * u3),
                r(r(K(C4[2]) * xy) * z71), r(r(K(C4[3]) * yz) * z73),
                r(K(C4[4]) * r(zz * r(35 * zz - 30) + 3)),
                r(r(K(C4[5]) * xz) * z73), r(r(K(C4[6]) * dd) * z71),
                r(r(K(C4[7]) * xz) * v3),
                r(K(C4[8]) * r(xx * v3 - r(yy * u3)))]
    return np.stack(out, -1)


@pytest.mark.parametrize("bd", [1, 4, 9, 16, 25])
def test_sh_basis_bf16_rounds_as_the_kernel(bd):
    """The plain version's bf16 SH basis (slab_march._sh_basis_bf16, what
    kernel M's bf16 shading evaluates in packed bf16x2) against an exact
    emulation of the kernel's operations, each rounded once to bf16: equal
    on 20000 random unit directions but where the plain version's fused
    multiply-add, rounded through f32, meets a tie (none here); and within
    bf16's own error of the f32 basis (the reference's _sh_planes in f32)
    and of the reference's bf16 planes (pallas_slab._sh_planes on bf16
    directions, as its _BF16_SHADE evaluates them)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    d = rng.normal(size=(20000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d16 = torch.as_tensor(d.astype(np.float32)).to(torch.bfloat16)
    got = slab_march._sh_basis_bf16(d16, bd).to(torch.float64).numpy()
    want = _sh_basis_bf16_emulated(d16.to(torch.float64).numpy(), bd)
    assert int(np.sum(got != want)) == 0
    basis_f32 = slab_march.basis_mod.eval_basis(
        slab_march.BasisType.SH, bd, torch.as_tensor(d, dtype=torch.float32))
    assert float((torch.as_tensor(got) - basis_f32).abs().max()) < 0.05
    jd = jnp.asarray(d16.to(torch.float32).numpy(), jnp.bfloat16)
    ref = np.stack([np.asarray(p, np.float64) for _, p in
                    pallas_slab._sh_planes(bd, jd[:, 0], jd[:, 1], jd[:, 2])],
                   -1)
    assert float(np.abs(got - ref).max()) < 0.05


@pytest.mark.parametrize("knob,dt", [("dir_win", "int8"),
                                     ("bf16_shade", "f16")])
def test_render_frame_knob_matches_reference(monkeypatch, knob, dt):
    """render_image with each module switch flipped (read at call time by
    slab_render._march_finalize, as the reference reads pallas_slab's)
    against the reference's render_image with the same switch in interpret
    mode (>= 45 dB, alpha within 2e-2), and against the port's default
    frame (>= 50 dB: the reference's per-slab gate,
    tests/test_slab_render.py:1076-1106; bf16 shading measured ~63 dB
    there)."""
    _, g, _, jg = scene("dense", 4, dt)
    cam = make_cam((1.0, 0.25, 0.35), width=40, height=40, fx=50.0)
    opt = RenderOptions(max_steps=512)
    base = slab_render.render_image(g, cam, opt, gi=48)
    name, val = {"dir_win": ("_DIR_WIN", False),
                 "bf16_shade": ("_BF16_SHADE", True)}[knob]
    monkeypatch.setattr(slab_march, name, val)
    got = slab_render.render_image(g, cam, opt, gi=48)
    with interpret(monkeypatch):
        monkeypatch.setattr(pallas_slab, name, val)
        want = np.asarray(j_slab.render_image(jg, cam, JOpt(max_steps=512),
                                              gi=48))
    assert psnr(got[..., :3], want[..., :3]) >= GATE_DB
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=T_ATOL)
    assert psnr(got[..., :3], base[..., :3]) >= KNOB_DB
    assert not np.array_equal(got, base)


def test_training_mode_keeps_its_shading(monkeypatch):
    """The switches are the display path's: the training march is the same
    with them flipped (slab_grad passes its own per-slab f32 shading), and
    a training march asking for bf16 shading or window directions
    raises."""
    _, g, _, _ = scene("dense", 4, "f16")
    cam = make_cam((1.0, 0.25, 0.35), width=24, height=24, fx=30.0)
    opt = RenderOptions(max_steps=256, renormalize=False)
    bake = g.data.to(torch.float32)
    perm, flip, _ = slab_render.choose_axis(g, cam.transform, cam.fx,
                                            cam.fy, 24, 24)
    geom = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm,
                                 flip, 24, 24, opt, 32)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, opt)
    view = bake.permute(perm[0], 3, perm[1], perm[2])
    kw = dict(slab_ids=g.slab_ids(perm[0], flip, opt.sigma_thresh),
              flip=flip, bbox_full=True, dir_win=False, train=True)
    args = (view, params, torch.ones(g.data_dim), zb, g.G, 32, g.data_dim,
            g.basis_dim, perm)
    a = slab_march.march_slabs(*args, **kw)
    monkeypatch.setattr(slab_march, "_BF16_SHADE", True)
    monkeypatch.setattr(slab_march, "_DIR_WIN", False)
    assert torch.equal(a, slab_march.march_slabs(*args, **kw))
    for bad in (dict(shade_bf16=True), dict(dir_win=True)):
        with pytest.raises(ValueError):
            slab_march.march_slabs(*args, **{**kw, **bad})
