"""The training fast path of the port (``volrend_torch/ops/slab_grad.py``,
the training mode of ``slab_march.march_slabs`` and ``march_slabs_bwd``)
against the reference's ``volrend_tpu/ops/slab_grad.py`` on the CPU, on
identical seeded scenes (G=16).

The port's kernel path marches the payload cast to bf16, as the
reference's Pallas path does; the reference's CPU path is its scan march
in f32. So the march checks feed both the bf16-rounded payload, and the
frame checks train bf16-representable data: both then march identical
values, and the tolerances are f32 rounding (stated beside each check).
The reference's backward kernel is not run (its interpret mode is the
cost its own suite marks ``slow``): the port's backward is held against
``jax.grad`` of the reference's scan march instead."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import slab_grad as j_sg
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import slab_grad, slab_march, slab_render
from volrend_torch.utils.options import RenderOptions

from _torch_perms import group_cams
from _torch_scenes import make_cam, scene

torch.set_num_threads(1)

W = H = 24
GI = 32
OPT = RenderOptions(max_steps=512)
JOPT = JOpt(max_steps=512)
SCENES = [("dense", 4), ("solid", 16)]
BACKS = {"dense": (1.0, 0.2, 0.3), "solid": (0.3, -1.0, 0.5)}


@pytest.fixture(scope="module", params=SCENES, ids=lambda s: f"{s[0]}{s[1]}")
def maps(request):
    """(port TreeArrays, port grid, port BakeMap, reference TreeArrays,
    reference grid, reference BakeMap) of one f16-baked scene."""
    kind, bd = request.param
    tdev, tg, jdev, jg = scene(kind, bd, "f16")
    return (kind, tdev, tg, slab_grad.build_bake_map(tdev), jdev, jg,
            j_sg.build_bake_map(jdev))


def _rows32(jdev):
    return np.asarray(jdev.data, np.float32)


def test_bake_map_bit_equal(maps):
    _, _, _, tb, _, _, jb = maps
    assert (tb.G, tb.N, tb.D, tb.sizes) == (jb.G, jb.N, jb.D, jb.sizes)
    for a, b in zip(tb.rows, jb.rows):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tb.coords, jb.coords):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tb.masks, jb.masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bake_functions_and_round_trips_exact(maps):
    """bake_from_data, data_to_pyramid, bake_from_pyramid and
    pyramid_to_data equal the reference bit for bit, and the leaf <->
    pyramid round trip is exact."""
    _, tdev, _, tb, jdev, _, jb = maps
    rows = _rows32(jdev)
    t_rows = torch.tensor(rows)
    np.testing.assert_array_equal(
        slab_grad.bake_from_data(t_rows, tb).numpy(),
        np.asarray(jax.jit(j_sg.bake_from_data)(jnp.asarray(rows), jb)))
    tp = slab_grad.data_to_pyramid(t_rows, tb)
    jp = jax.jit(j_sg.data_to_pyramid)(jnp.asarray(rows), jb)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        slab_grad.bake_from_pyramid(tp, tb).numpy(),
        np.asarray(jax.jit(j_sg.bake_from_pyramid)(jp, jb)))
    back = slab_grad.pyramid_to_data(tp, tb, rows.shape[0], rows.shape[1])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax.jit(
            j_sg.pyramid_to_data, static_argnums=(2, 3))(
            jp, jb, rows.shape[0], rows.shape[1])))
    for a, b in zip(tp, slab_grad.data_to_pyramid(back, tb)):
        assert torch.equal(a, b)


def test_bake_from_pyramid_grad_matches_jax_vjp(maps):
    """Autograd's transpose of the pyramid bake (masked sum-pools) equals
    the reference's VJP to 1e-6 of each level's largest entry (the two sum
    the pooled blocks in different orders); entries outside a level's mask
    get exactly zero gradient."""
    _, _, _, tb, jdev, _, jb = maps
    rows = _rows32(jdev)
    G, D = tb.G, tb.D
    R = np.random.default_rng(0).normal(size=(G, G, G, D)).astype(np.float32)
    tp = [p.requires_grad_(True) for p in slab_grad.data_to_pyramid(
        torch.tensor(rows), tb)]
    gt = torch.autograd.grad(
        torch.sum(slab_grad.bake_from_pyramid(tp, tb) * torch.tensor(R)), tp)
    jp = j_sg.data_to_pyramid(jnp.asarray(rows), jb)
    (gj,) = jax.jit(lambda p, r: jax.vjp(
        lambda q: j_sg.bake_from_pyramid(q, jb), p)[1](r))(jp, jnp.asarray(R))
    for a, b, m in zip(gt, gj, tb.masks):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(b).max()))
        assert not bool(a[~m.expand_as(a)].any())


def _march_setup(maps, stop_thresh=None):
    """One pose's reference geometry and both packages' march inputs, on
    the bf16-rounded payload."""
    kind, _, tg, _, _, jg, _ = maps
    cam = make_cam(BACKS[kind], width=W, height=H, fx=30.0)
    jopt = JOPT.replace(renormalize=False, render_depth=False)
    if stop_thresh is not None:
        jopt = jopt.replace(stop_thresh=stop_thresh)
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
    t = dict(planar=torch.tensor(p16).to(torch.bfloat16),
             params=torch.tensor(np.asarray(params)),
             zb=torch.tensor(np.asarray(zb)),
             qs=torch.ones(jg.data_dim))
    return cfg, pperm, gm, jg, t


def _march_port(cfg, t):
    return slab_march.march_slabs(
        t["planar"], t["params"][None], t["qs"], t["zb"][None], cfg.G,
        cfg.gi, cfg.D, cfg.bd, cfg.perm, slab_ids=cfg.ids, flip=cfg.flip,
        bbox_full=True, dir_win=False)[0]


def _cotangent(gi, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(gi, gi, 3)).astype(np.float32),
            rng.normal(size=(gi, gi)).astype(np.float32))


def _rel_cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return (float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))


@pytest.fixture(scope="module")
def march_case(maps):
    """The march inputs, a seeded cotangent, and the reference's scan march
    and its jax.vjp on the bf16-rounded payload (traced once per scene)."""
    cfg, pperm, gm, jg, t = _march_setup(maps)
    g_acc, g_T = _cotangent(cfg.gi)

    @jax.jit
    def fwd_and_vjp(pp, ga, gt):
        out, vjp = jax.vjp(
            lambda q: j_sg._march_fwd_impl(cfg, q, jg.extra, gm), pp)
        return out, vjp((ga, gt))[0]

    (a, T), gs = fwd_and_vjp(pperm, jnp.asarray(g_acc), jnp.asarray(g_T))
    return cfg, t, g_acc, g_T, np.asarray(a), np.asarray(T), np.asarray(gs)


def test_training_march_matches_reference_scan(march_case):
    """Kernel M's training mode (its plain version here) against the
    reference's scan march on the same bf16-rounded payload: both f32,
    they agree to 5e-6 (summation order over 16 slabs)."""
    cfg, t, _, _, a, T, _ = march_case
    acc4 = _march_port(cfg, t).numpy()
    np.testing.assert_allclose(acc4[:3], np.moveaxis(a, -1, 0), atol=5e-6)
    np.testing.assert_allclose(acc4[3], T, atol=5e-6)
    assert float(acc4[3].min()) < 0.5          # the scene was seen


def test_march_bwd_matches_jax_grad_of_scan(march_case):
    """march_slabs_bwd (its plain version) == jax.grad of the reference's
    scan march on the same bf16-rounded payload. Relative L2 below 1e-5
    and cosine above 1 - 1e-9 (the reference's own kernel test allows 2e-2
    for its bf16 matmuls; the port keeps f32). No ray sits at the stop
    threshold here, so no freeze flips."""
    cfg, t, g_acc, g_T, _, _, gs = march_case
    acc4 = _march_port(cfg, t)
    gacc4 = torch.tensor(np.concatenate([np.moveaxis(g_acc, -1, 0),
                                         g_T[None]]))
    gk = slab_march.march_slabs_bwd(
        t["planar"], t["params"], t["qs"], t["zb"], gacc4, acc4, cfg.G,
        cfg.gi, cfg.D, cfg.bd, cfg.perm, flip=cfg.flip, bbox_full=True)
    assert gk.dtype == torch.float32
    rel, cos = _rel_cos(np.transpose(gk.numpy(), (0, 2, 3, 1)), gs)
    assert rel < 1e-5 and cos > 1 - 1e-9, (rel, cos)


def test_march_bwd_matches_port_autograd_and_lean_output(maps):
    """The same cotangent against autograd of the port's own scan march
    (a third witness, relative L2 < 1e-5), and the bf16 output (the lean
    trainer's) equal to the f32 one rounded once (2^-8 relative)."""
    cfg, _, _, _, t = _march_setup(maps)
    tcfg = slab_grad.SlabCfg(G=cfg.G, gi=cfg.gi, D=cfg.D, bd=cfg.bd,
                             fmt=cfg.fmt, perm=cfg.perm, flip=cfg.flip,
                             ids=cfg.ids,
                             opt=OPT.replace(renormalize=False))
    kind, tg = maps[0], maps[2]
    cam = make_cam(BACKS[kind], width=W, height=H, fx=30.0)
    geom = slab_render.FrameGeom(tg, cam.transform, cam.fx, cam.fy,
                                 cfg.perm, cfg.flip, W, H, tcfg.opt, GI)
    gm = dict(cz=geom.cz[0], cy=geom.cy[0], cx=geom.cx[0], uy=geom.uy[0],
              ux=geom.ux[0], z_lo=geom.z_lo_pix[0], z_hi=geom.z_hi_pix[0],
              scale=geom.scale, lo=geom.lo, hi=geom.hi, dirM=geom.dirM[0])
    params = slab_grad._pack_geom_params(geom, tcfg, 1.0 / geom.scale)[0]
    zb = torch.stack([geom.z_lo_pix[0], geom.z_hi_pix[0]])
    g_acc, g_T = _cotangent(cfg.gi, seed=1)
    pp = t["planar"].float().permute(0, 2, 3, 1).contiguous()
    pp.requires_grad_(True)
    a, T = slab_grad._march_fwd_impl(tcfg, pp, tg.extra, gm)
    gs = torch.autograd.grad(torch.sum(a * torch.tensor(g_acc))
                             + torch.sum(T * torch.tensor(g_T)), pp)[0]
    acc4 = slab_march.march_slabs(
        t["planar"], params[None], t["qs"], zb[None], cfg.G, cfg.gi, cfg.D,
        cfg.bd, cfg.perm, slab_ids=cfg.ids, flip=cfg.flip, bbox_full=True,
        dir_win=False)[0]
    gacc4 = torch.cat([torch.tensor(g_acc).permute(2, 0, 1),
                       torch.tensor(g_T)[None]])
    outs = [slab_march.march_slabs_bwd(
        t["planar"], params, t["qs"], zb, gacc4, acc4, cfg.G, cfg.gi, cfg.D,
        cfg.bd, cfg.perm, flip=cfg.flip, bbox_full=True, out_dtype=dt)
        for dt in (torch.float32, torch.bfloat16)]
    rel, cos = _rel_cos(outs[0].permute(0, 2, 3, 1).numpy(), gs.numpy())
    assert rel < 1e-5 and cos > 1 - 1e-9, (rel, cos)
    assert outs[1].dtype == torch.bfloat16
    np.testing.assert_allclose(outs[1].float().numpy(), outs[0].numpy(),
                               rtol=2 ** -8, atol=1e-30)


def test_march_bwd_state_init_segments_match_whole_grid(maps):
    """The kernel interface slice D's z-sharded training will use: two
    z-segments, each back-marched from the incoming (T, A) state of the
    segments upstream (params[30] = the segment's z base, aux planes 2/3 =
    state_init), together equal the whole-grid cotangent (relative L2 <
    1e-5). Segment semantics: stop_thresh = 0, as the reference's
    z-sharded march forces."""
    cfg, _, _, _, t = _march_setup(maps, stop_thresh=0.0)
    G, gi, D, bd = cfg.G, cfg.gi, cfg.D, cfg.bd
    g_acc, g_T = _cotangent(gi, seed=2)
    gacc4 = torch.cat([torch.tensor(g_acc).permute(2, 0, 1),
                       torch.tensor(g_T)[None]])
    whole_acc = _march_port(cfg, t)
    whole = slab_march.march_slabs_bwd(
        t["planar"], t["params"], t["qs"], t["zb"], gacc4, whole_acc, G, gi,
        D, bd, cfg.perm, flip=cfg.flip, bbox_full=True)

    half = G // 2
    segs = []
    for i in range(2):
        prm = torch.cat([t["params"], torch.tensor([i * half / G])])
        zb4 = slab_march._zb_planes(prm[None], t["zb"][None], G, gi)
        pay = t["planar"][i * half:(i + 1) * half].contiguous()
        wins, masks = slab_march._window_masks(
            tuple(range(half - 1, -1, -1) if cfg.flip else range(half)), 4)
        acc = slab_march.march_slabs_ref(
            pay, t["qs"], prm[None], zb4, wins, masks, G, gi, D, bd, 4,
            cfg.flip)[0]
        segs.append((prm, zb4[0], pay, acc))
    # forward partials combine in march order; each segment's incoming
    # (T, A) follows from the upstream partials
    order = (1, 0) if cfg.flip else (0, 1)
    Tc, Ac = torch.ones((gi, gi)), torch.zeros((gi, gi))
    C = torch.zeros((3, gi, gi))
    state = {}
    for i in order:
        acc = segs[i][3]
        state[i] = torch.stack([Tc, Ac])
        Ac = Ac + Tc * torch.sum(gacc4[:3] * acc[:3], 0)
        C = C + Tc * acc[:3]
        Tc = Tc * acc[3]
    acc_all = torch.cat([C, Tc[None]])
    np.testing.assert_allclose(acc_all.numpy(), whole_acc.numpy(),
                               atol=1e-5)
    parts = []
    for i in range(2):
        prm, zb4, pay, _ = segs[i]
        aux = torch.cat([torch.sum(gacc4[:3] * acc_all[:3], 0)[None],
                         (gacc4[3] * acc_all[3])[None], state[i]])
        parts.append(slab_march.march_slabs_bwd_ref(
            pay, t["qs"], prm, zb4, gacc4, aux, G, gi, D, bd, cfg.flip))
    rel, _ = _rel_cos(torch.cat(parts).numpy(), whole.numpy())
    assert rel < 1e-5, rel


def _frame_data(maps):
    """bf16-representable leaf rows (so the kernel path's bf16 cast is
    exact) as numpy, and one pose."""
    kind, _, _, _, jdev, jg, _ = maps
    rows = np.asarray(jnp.asarray(_rows32(jdev)).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    cam = make_cam(BACKS[kind], width=W, height=H, fx=30.0)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       W, H)
    return rows, cam, perm, flip


def _reference_frame(jg, jb, rows, cam, perm, flip, tgt):
    """The reference's training frame, loss and pyramid gradient for one
    pose (one jax.vjp trace)."""
    jp = j_sg.data_to_pyramid(jnp.asarray(rows), jb)
    tr = jnp.asarray(cam.transform)

    @jax.jit
    def frame_loss_grad(p):
        out, vjp = jax.vjp(lambda q: j_sg.render_frame_train(
            q, jb, jg, tr, cam.fx, cam.fy, perm, flip, W, H, JOPT, gi=GI), p)
        diff = out[..., :3] - tgt[..., :3]
        ct = jnp.concatenate([2.0 * diff / diff.size,
                              jnp.zeros((H, W, 1), jnp.float32)], -1)
        return out, jnp.mean(diff * diff), vjp(ct)[0]

    out, loss, grads = frame_loss_grad(jp)
    return np.asarray(out), float(loss), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def frame_case(maps):
    """bf16-representable data, a pose, a seeded target, and the
    reference's training frame, loss and pyramid gradient (one jax.vjp
    trace per scene)."""
    _, _, _, _, _, jg, jb = maps
    rows, cam, perm, flip = _frame_data(maps)
    tgt = np.random.default_rng(3).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    out, loss, grads = _reference_frame(jg, jb, rows, cam, perm, flip, tgt)
    return rows, cam, perm, flip, tgt, out, loss, grads


def _use_scan(monkeypatch):
    """Select the scan march where "auto" would take the kernels."""
    monkeypatch.setattr(slab_grad, "_kernel_train_ok", lambda cfg: False)


@pytest.mark.parametrize("backend", ["kernel", "scan"])
def test_loss_and_grad_frame_matches_reference(maps, frame_case, backend,
                                               monkeypatch):
    """render_frame_train and loss_and_grad_frame (pyramid parameters)
    through the port's kernel path (plain versions on the CPU) and its scan
    path, against the reference's (its scan march on the CPU, jitted):
    frames within 1e-5 (f32 rounding of values ~1 in another order), loss
    to rtol 1e-5, gradient relative L2 < 1e-4 per pyramid level."""
    _, _, tg, tb, _, _, _ = maps
    rows, cam, perm, flip, tgt, ref, jl, jgr = frame_case
    if backend == "scan":
        _use_scan(monkeypatch)
    tp = slab_grad.data_to_pyramid(torch.tensor(rows), tb)
    args = (cam.transform, cam.fx, cam.fy, perm, flip, W, H)
    with torch.no_grad():
        out = slab_grad.render_frame_train(tp, tb, tg, *args, OPT, gi=GI)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    n0 = slab_march.march_slabs.launches
    loss, g = slab_grad.loss_and_grad_frame(tp, tb, tg, *args, tgt, OPT,
                                            gi=GI)
    assert slab_march.march_slabs.launches == n0     # CPU: plain versions
    assert np.isclose(float(loss), jl, rtol=1e-5)
    for a, b in zip(g, jgr):
        if float(np.abs(b).max()) == 0.0:
            assert not bool(a.any())
            continue
        rel, _ = _rel_cos(a.numpy(), b)
        assert rel < 1e-4, rel


PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


@pytest.fixture(scope="module", params=[1, 4], ids=lambda b: f"SH{b}")
def perm_scene(request):
    """The dense scene at SH1 (D = 4) and SH4 (D = 13), f16-baked by both
    packages, bf16-representable leaf rows, one camera per (perm, flip)
    group and a seeded target."""
    tdev, tg, jdev, jg = scene("dense", request.param, "f16")
    rows = np.asarray(jnp.asarray(_rows32(jdev)).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    tgt = np.random.default_rng(5).uniform(0, 1, (H, W, 4)).astype(
        np.float32)
    return (tg, slab_grad.build_bake_map(tdev), jg, j_sg.build_bake_map(jdev),
            rows, group_cams(tg, W, H, 30.0), tgt)


@pytest.mark.parametrize("perm", PERMS)
def test_kernel_frame_gradient_every_perm(perm_scene, perm, monkeypatch):
    """loss_and_grad_frame on the kernel path (its plain versions on the
    CPU) for each of the six slab permutations,
    flip alternating, at SH1 and SH4, against the reference's scan march
    and jax.vjp: frame within 1e-5, loss to rtol 1e-5, gradient relative
    L2 < 1e-4 per pyramid level (the tolerances of
    test_loss_and_grad_frame_matches_reference)."""
    tg, tb, jg, jb, rows, cams, tgt = perm_scene
    flip = bool(PERMS.index(perm) % 2)
    cam = cams[(perm, flip)]
    assert slab_render.choose_axis(tg, cam.transform, cam.fx, cam.fy, W,
                                   H)[:2] == (perm, flip)
    ref, jl, jgr = _reference_frame(jg, jb, rows, cam, perm, flip, tgt)
    calls = []
    bwd_ref = slab_march.march_slabs_bwd_ref
    monkeypatch.setattr(slab_march, "march_slabs_bwd_ref",
                        lambda *a, **k: calls.append(1) or bwd_ref(*a, **k))
    tp = slab_grad.data_to_pyramid(torch.tensor(rows), tb)
    args = (cam.transform, cam.fx, cam.fy, perm, flip, W, H)
    with torch.no_grad():
        out = slab_grad.render_frame_train(tp, tb, tg, *args, OPT, gi=GI,
                                           backend="kernel")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    loss, g = slab_grad.loss_and_grad_frame(tp, tb, tg, *args, tgt, OPT,
                                            gi=GI)
    assert calls == [1]                    # the kernel path's backward
    assert np.isclose(float(loss), jl, rtol=1e-5)
    assert any(float(np.abs(b).max()) > 0 for b in jgr)
    for a, b in zip(g, jgr):
        if float(np.abs(b).max()) == 0.0:
            assert not bool(a.any())
            continue
        rel, _ = _rel_cos(a.numpy(), b)
        assert rel < 1e-4, rel


def test_pyramid_and_leaf_gradients_agree(maps, frame_case):
    """loss_and_grad_frame on pyramid parameters and on leaf rows (the
    same function, reparameterized): identical loss, the pyramid gradient
    at each leaf's block equals that leaf row's gradient (rtol 1e-6), and
    masked-off pyramid entries get exactly zero (the reference's
    test_pyramid_loss_and_grads_match_leaf)."""
    _, _, tg, tb, _, _, _ = maps
    rows, cam, perm, flip, tgt, _, _, _ = frame_case
    args = (cam.transform, cam.fx, cam.fy, perm, flip, W, H, tgt, OPT)
    t_rows = torch.tensor(rows)
    l_leaf, g_leaf = slab_grad.loss_and_grad_frame(t_rows, tb, tg, *args,
                                                   gi=GI)
    l_pyr, g_pyr = slab_grad.loss_and_grad_frame(
        slab_grad.data_to_pyramid(t_rows, tb), tb, tg, *args, gi=GI)
    assert float(l_leaf) == float(l_pyr)
    for p, r, c, m in zip(g_pyr, tb.rows, tb.coords, tb.masks):
        if not r.numel():
            continue
        np.testing.assert_allclose(p.reshape(-1, tb.D)[c].numpy(),
                                   g_leaf[r][:, :tb.D].numpy(), rtol=1e-6,
                                   atol=1e-7)
        assert not bool(p[~m.expand_as(p)].any())


def test_precise_warp_and_its_gradient_match_reference(maps):
    """The training warp (_warp_to_screen_ref with an f32 quad table) and
    its autograd transpose against the reference's warp and jax.vjp, both
    to 1e-5 (the jitted reference rounds the screen->slope arithmetic
    differently; values are ~1)."""
    kind, _, tg, _, _, jg, _ = maps
    cam = make_cam(BACKS[kind], width=W, height=H, fx=30.0)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       W, H)
    jgm = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                           perm, flip, W, H, JOPT, GI)
    g = slab_render.FrameGeom(tg, cam.transform, cam.fx, cam.fy, perm, flip,
                              W, H, OPT, GI)
    inter = np.random.default_rng(7).uniform(0, 1, (GI, GI, 4)).astype(
        np.float32)
    ti = torch.tensor(inter)[None].requires_grad_(True)
    n0 = slab_render._warp_to_screen_ref.poses
    out = slab_render._warp_to_screen(
        ti, OPT, g.R, g.fx, g.fy, W, H, GI, perm, g.u0, g.du, g.v0, g.dv,
        g.scale, precise=True)[0]
    # the training warp is not a display fallback
    assert slab_render._warp_to_screen_ref.poses == n0
    ct = np.random.default_rng(4).normal(size=out.shape).astype(np.float32)

    @jax.jit
    def warp_and_vjp(x, c):
        o, vjp = jax.vjp(lambda y: j_slab._warp_to_screen(
            y, JOPT, jgm.R, jgm.fx, jgm.fy, W, H, GI, perm, jgm.u0, jgm.du,
            jgm.v0, jgm.dv, jgm.scale, precise=True), x)
        return o, vjp(c)[0]

    ref, gref = warp_and_vjp(jnp.asarray(inter), jnp.asarray(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    (gt,) = torch.autograd.grad(out, ti, torch.tensor(ct))
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("call", ["zsharded", "frames_sharded", "z_base"])
def test_later_slices_raise(call):
    """The z-sharded and pose-sharded training entry points, and a
    z-segment payload in the backward wrapper, raise naming slice D."""
    with pytest.raises(NotImplementedError, match="slice"):
        if call == "zsharded":
            slab_grad.render_frame_train_zsharded()
        elif call == "frames_sharded":
            slab_grad.loss_and_grad_frames_sharded()
        else:
            z = torch.zeros((4, 4, 4))
            slab_march.march_slabs_bwd(
                torch.zeros((4, 13, 4, 4), dtype=torch.bfloat16),
                torch.zeros(30), torch.ones(13), z[:2], z, z, 4, 4, 13, 4,
                (0, 1, 2), bbox_full=True, z_base=0.5)
