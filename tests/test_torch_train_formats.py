"""The training pair's formats and options on the port (kernel M's training
mode and the backward march, their plain versions on the CPU): SG and ASG
trees of a few lobes, RGBA trees, and an SH tree with ``rot_dirs``, a basis
window and a non-full ``render_bbox``, against the reference's scan march
(``volrend_tpu/ops/slab_grad.py:_march_fwd_impl``) and its ``jax.vjp``, on
the reference's format test trees (G=16, 48^2 frames, gi=32); then the
frame loss and gradient through ``loss_and_grad_frame`` and three
``FrameTrainer`` steps against the reference's.

As in tests/test_torch_slab_grad.py, both packages march the payload
rounded to bf16 (the port's kernels read it so) and the frame checks train
bf16-representable data, so the tolerances are f32 rounding: the forward
to 5e-6, the backward to relative L2 1e-5 and cosine 1 - 1e-9."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu import train as j_train
from volrend_tpu.ops import render_jax
from volrend_tpu.ops import slab_grad as j_sg
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch import train
from volrend_torch.ops import slab_grad, slab_march
from volrend_torch.utils.options import RenderOptions

from _torch_scenes import CPU, format_scene, format_trees, make_cam

torch.set_num_threads(1)

W = H = 48
GI = 32
LR = 5e-2
BACK = (1.0, 0.25, 0.35)
JOPT = JOpt(max_steps=512)
OPT = RenderOptions(max_steps=512)

ROT = dict(rot_dirs=(0.3, -0.2, 0.5))
WINDOW = dict(basis_minmax=(0, 2))
BBOX = dict(render_bbox=(0.3,) * 3 + (0.7,) * 3)
#: the training bench's option cases (chip_smoke.TRAIN_CASES) at its
#: basis width, SH9
BENCH_WINDOW = dict(basis_minmax=(0, 3))
BENCH_BBOX = dict(render_bbox=(0.25,) * 3 + (0.75,) * 3)
#: (format, basis_dim, render options) of each case
CASES = {
    "SG4": ("SG", 4, {}), "SG3": ("SG", 3, {}), "ASG4": ("ASG", 4, {}),
    "ASG5": ("ASG", 5, {}), "RGBA": ("RGBA", -1, {}),
    "SH4-rot": ("SH", 4, ROT), "SH4-window": ("SH", 4, WINDOW),
    "SH4-bbox": ("SH", 4, BBOX), "SH4-all": ("SH", 4, {**ROT, **WINDOW,
                                                      **BBOX}),
    "SH9-rot": ("SH", 9, ROT), "SH9-window": ("SH", 9, BENCH_WINDOW),
    "SH9-bbox": ("SH", 9, BENCH_BBOX),
}


def _scene(fmt, bd):
    return format_scene(fmt, 4 if fmt == "RGBA" else bd, "f16")


def _rel_cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))


@pytest.fixture(scope="module", params=sorted(CASES))
def march_case(request):
    """One pose of a case's tree: the port's march inputs and statics, a
    seeded cotangent, and the reference's scan march and its jax.vjp on
    the bf16-rounded payload (traced once per case)."""
    fmt, bd, options = CASES[request.param]
    _, _, _, jg = _scene(fmt, bd)
    jopt = JOPT.replace(renormalize=False, render_depth=False, **options)
    cam = make_cam(BACK, width=W, height=H)
    perm, flip, slope = j_slab.choose_axis(jg, cam.transform, cam.fx,
                                           cam.fy, W, H)
    assert np.isfinite(slope)
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, W, H, jopt, GI)
    ids = tuple(range(jg.G - 1, -1, -1) if flip else range(jg.G))
    cfg = j_sg.SlabCfg(G=jg.G, gi=GI, D=jg.data_dim, bd=jg.basis_dim,
                       fmt=int(jg.fmt), perm=perm, flip=flip, ids=ids,
                       opt=jopt)
    planar = jnp.transpose(jnp.asarray(jg.data, jnp.float32),
                           (perm[0], 3, perm[1], perm[2]))
    p16 = np.asarray(planar.astype(jnp.bfloat16).astype(jnp.float32))
    pperm = jnp.asarray(np.transpose(p16, (0, 2, 3, 1)))
    params = j_sg._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = jnp.stack([geom.z_lo_pix, geom.z_hi_pix])
    gm = dict(cz=geom.cz, cy=geom.cy, cx=geom.cx, uy=geom.uy, ux=geom.ux,
              z_lo=geom.z_lo_pix, z_hi=geom.z_hi_pix, scale=geom.scale,
              lo=geom.lo, hi=geom.hi, dirM=geom.dirM)
    rng = np.random.default_rng(0)
    g_acc = rng.normal(size=(GI, GI, 3)).astype(np.float32)
    g_T = rng.normal(size=(GI, GI)).astype(np.float32)

    @jax.jit
    def fwd_and_vjp(pp, ga, gt):
        out, vjp = jax.vjp(
            lambda q: j_sg._march_fwd_impl(cfg, q, jg.extra, gm), pp)
        return out, vjp((ga, gt))[0]

    (a, T), gs = fwd_and_vjp(pperm, jnp.asarray(g_acc), jnp.asarray(g_T))
    rotm = render_jax._rodrigues_matrix(jopt.rot_dirs)
    blo, bhi = jopt.basis_minmax
    statics = dict(fmt=cfg.fmt, extra=torch.tensor(np.asarray(jg.extra)),
                   rot=(None if rotm is None
                        else tuple(float(v) for v in rotm.reshape(-1))),
                   bbox_full=j_slab._bbox_full(jopt), basis_lo=int(blo),
                   basis_hi=int(bhi))
    t = dict(planar=torch.tensor(p16).to(torch.bfloat16),
             params=torch.tensor(np.asarray(params)),
             zb=torch.tensor(np.asarray(zb)), qs=torch.ones(cfg.D))
    gacc4 = torch.cat([torch.tensor(g_acc).permute(2, 0, 1),
                       torch.tensor(g_T)[None]])
    return (request.param, cfg, t, statics, gacc4, np.asarray(a),
            np.asarray(T), np.asarray(gs))


def _march_port(cfg, t, statics):
    return slab_march.march_slabs(
        t["planar"], t["params"][None], t["qs"], t["zb"][None], cfg.G,
        cfg.gi, cfg.D, cfg.bd, cfg.perm, slab_ids=cfg.ids, flip=cfg.flip,
        dir_win=False, **statics)[0]


def _bwd_port(cfg, t, statics, gacc4, acc4, out_dtype=torch.float32):
    return slab_march.march_slabs_bwd(
        t["planar"], t["params"], t["qs"], t["zb"], gacc4, acc4, cfg.G,
        cfg.gi, cfg.D, cfg.bd, cfg.perm, flip=cfg.flip, out_dtype=out_dtype,
        **statics)


def test_training_march_formats_match_reference_scan(march_case):
    """Kernel M's training mode (its plain version) with each format and
    option against the reference's scan march on the same bf16-rounded
    payload: both f32, they agree to 5e-6 (summation order over 16
    slabs)."""
    name, cfg, t, statics, _, a, T, _ = march_case
    acc4 = _march_port(cfg, t, statics).numpy()
    np.testing.assert_allclose(acc4[:3], np.moveaxis(a, -1, 0), atol=5e-6)
    np.testing.assert_allclose(acc4[3], T, atol=5e-6)
    assert float(acc4[3].min()) < 0.5, name       # the scene was seen


def test_march_bwd_formats_match_jax_vjp(march_case):
    """march_slabs_bwd (its plain version) with each format and option
    against jax.vjp of the reference's scan march on the same bf16-rounded
    payload: relative L2 below 1e-5 and cosine above 1 - 1e-9. The basis
    window's dropped planes get exactly zero cotangent, as do voxels
    outside the bbox."""
    name, cfg, t, statics, gacc4, _, _, gs = march_case
    acc4 = _march_port(cfg, t, statics)
    gk = _bwd_port(cfg, t, statics, gacc4, acc4)
    assert gk.dtype == torch.float32
    gk = np.transpose(gk.numpy(), (0, 2, 3, 1))
    rel, cos = _rel_cos(gk, gs)
    assert rel < 1e-5 and cos > 1 - 1e-9, (name, rel, cos)
    lo, hi = statics["basis_lo"], statics["basis_hi"]
    if cfg.bd > 0 and (lo, hi) != (0, 24):
        k = np.arange(3 * cfg.bd) % cfg.bd
        assert not np.any(gk[..., :3 * cfg.bd][..., (k < lo) | (k > hi)])
    assert np.abs(gk).max() > 0


def test_march_bwd_lean_output_is_f32_rounded(march_case):
    """The lean trainer's bf16 cotangent of each case equals the f32 one
    rounded once (2^-8 relative)."""
    _, cfg, t, statics, gacc4, _, _, _ = march_case
    acc4 = _march_port(cfg, t, statics)
    g32 = _bwd_port(cfg, t, statics, gacc4, acc4)
    g16 = _bwd_port(cfg, t, statics, gacc4, acc4, torch.bfloat16)
    assert g16.dtype == torch.bfloat16
    np.testing.assert_allclose(g16.float().numpy(), g32.numpy(),
                               rtol=2 ** -8, atol=1e-30)


# ---------------------------------------------------------------------------
# Frames and the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,bd", [("SG", 4), ("RGBA", -1)])
def test_loss_and_grad_frame_formats_match_reference(fmt, bd):
    """loss_and_grad_frame with backend="kernel" (pyramid parameters; the
    plain versions on the CPU) against the reference's (its scan march,
    jitted jax.vjp) on bf16-representable leaf rows: the frame within
    1e-5, the loss to rtol 1e-5, the gradient to relative L2 1e-4 per
    pyramid level (tests/test_torch_slab_grad.py's tolerances)."""
    tdev, tg, jdev, jg = _scene(fmt, bd)
    tb, jb = slab_grad.build_bake_map(tdev), j_sg.build_bake_map(jdev)
    rows = np.asarray(jnp.asarray(np.asarray(jdev.data, np.float32))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    cam = make_cam(BACK, width=W, height=H)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       W, H)
    tgt = np.random.default_rng(3).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    jp = j_sg.data_to_pyramid(jnp.asarray(rows), jb)

    @jax.jit
    def frame_loss_grad(p):
        out, vjp = jax.vjp(lambda q: j_sg.render_frame_train(
            q, jb, jg, jnp.asarray(cam.transform), cam.fx, cam.fy, perm,
            flip, W, H, JOPT, gi=GI), p)
        diff = out[..., :3] - tgt[..., :3]
        ct = jnp.concatenate([2.0 * diff / diff.size,
                              jnp.zeros((H, W, 1), jnp.float32)], -1)
        return out, jnp.mean(diff * diff), vjp(ct)[0]

    ref, jl, jgr = frame_loss_grad(jp)
    tp = slab_grad.data_to_pyramid(torch.tensor(rows), tb)
    args = (cam.transform, cam.fx, cam.fy, perm, flip, W, H)
    with torch.no_grad():
        out = slab_grad.render_frame_train(tp, tb, tg, *args, OPT, gi=GI,
                                           backend="kernel")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    n0 = slab_march.march_slabs.launches
    loss, g = slab_grad.loss_and_grad_frame(tp, tb, tg, *args, tgt, OPT,
                                            gi=GI)
    assert slab_march.march_slabs.launches == n0     # CPU: plain versions
    assert np.isclose(float(loss), float(jl), rtol=1e-5)
    for a, b in zip(g, jgr):
        b = np.asarray(b)
        if float(np.abs(b).max()) == 0.0:
            assert not bool(a.any())
            continue
        rel, _ = _rel_cos(a.numpy(), b)
        assert rel < 1e-4, rel


def test_frame_trainer_sg_matches_reference():
    """Three step_frame losses of the port's trainer on an SG4 tree (the
    kernel path: the payload rounded to bf16 at the kernel boundary)
    against the reference's trainer (its f32 scan march on the CPU) from
    the same tree, pose and target: rtol 2e-2, as
    tests/test_torch_train.py holds the SH trainer's kernel path."""
    tt, jt = format_trees("SG", 4)
    tdev = tt.to_device(lut_depth=None, device=CPU)
    jdev = jt.to_device(lut_depth=None)
    cam = make_cam(BACK, width=W, height=H)
    tgt = np.random.default_rng(4).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    jtr = j_train.FrameTrainer(jdev, JOPT, lr=LR, gi=GI)
    ref = np.asarray([jtr.step_frame(cam, tgt) for _ in range(3)])
    tr = train.FrameTrainer(tdev, OPT, lr=LR, gi=GI)
    losses = np.asarray([tr.step_frame(cam, tgt) for _ in range(3)])
    np.testing.assert_allclose(losses, ref, rtol=2e-2)
    assert losses[-1] < losses[0]
