"""The slab path on z-segments: kernel M (display and training modes) and
M-bwd with ``z_base``, ``acc_init`` and ``state_init`` (their plain
versions on the CPU), the z-sharded frame renders of
``volrend_torch/parallel/dist.py`` and the z-sharded and pose-sharded
training of ``ops/slab_grad.py`` and ``train.py``, against the port's
unsharded path and the reference (``volrend_tpu``) on the CPU.

The sharded cases run in one gloo world of four spawned ranks
(tests/_torch_dist.py); the segment algebra's cases need no ranks.
Tolerances: z-sharded frames atol 3e-3 against the port's unsharded
frame (tests/test_dist.py's; here they agree far closer), and the
port's frame gate against the reference's (PSNR 45 dB, alpha 2e-2:
tests/test_torch_frames.py), batched against per-pose 2e-3; the z-sharded training march's payload gradient relative
L2 < 1e-5 against the whole grid and against ``jax.vjp`` of the
reference's scan march on the same bf16-rounded payload (f32 rounding,
as tests/test_torch_slab_grad.py holds the unsharded one); the sharded
trainer steps the dry run's (loss 1e-5 relative; parameters atol 2e-4,
rtol 1e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist as td
from _torch_scenes import interpret, psnr, scene
from volrend_tpu.ops import slab_grad as j_sg
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.ops import slab_grad, slab_march, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

torch.set_num_threads(1)

FLIP_CAM = dict(center=(2.4, 0.5, 0.7), back=(0.92, 0.2, 0.27))
FWD_CAM = dict(center=(-2.4, 0.4, 0.6), back=(-0.93, 0.15, 0.25))
SEG_OPT = RenderOptions(max_steps=512, stop_thresh=0.0, renormalize=False)
SEG_JOPT = JOpt(max_steps=512, stop_thresh=0.0, renormalize=False)
GI_T = 48


def _cam(center, back, size=32, fx=40.0):
    return Camera.from_vectors(center=center, v_back=back, width=size,
                               height=size, fx=fx)


def _march_inputs():
    """The training march's inputs as the reference builds them for the
    flip pose at 24^2, gi 48, stop_thresh 0: the bf16-rounded planar
    payload, params, z interval, a seeded cotangent, and the reference
    scan march's output and jax.vjp (traced once)."""
    _, _, _, jg = scene("dense", 4, "f16")
    cam = _cam(FLIP_CAM["center"], FLIP_CAM["back"], 24, 30.0)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       24, 24)
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, 24, 24, SEG_JOPT, GI_T)
    ids = tuple(range(jg.G - 1, -1, -1) if flip else range(jg.G))
    cfg = j_sg.SlabCfg(G=jg.G, gi=GI_T, D=jg.data_dim, bd=jg.basis_dim,
                       fmt=int(jg.fmt), perm=perm, flip=flip, ids=ids,
                       opt=SEG_JOPT)
    planar = jnp.transpose(jnp.asarray(jg.data, jnp.float32),
                           (perm[0], 3, perm[1], perm[2]))
    p16 = np.asarray(planar.astype(jnp.bfloat16).astype(jnp.float32))
    pperm = jnp.asarray(np.transpose(p16, (0, 2, 3, 1)))
    gm = dict(cz=geom.cz, cy=geom.cy, cx=geom.cx, uy=geom.uy, ux=geom.ux,
              z_lo=geom.z_lo_pix, z_hi=geom.z_hi_pix, scale=geom.scale,
              lo=geom.lo, hi=geom.hi, dirM=geom.dirM)
    rng = np.random.default_rng(7)
    g_acc = rng.normal(size=(GI_T, GI_T, 3)).astype(np.float32)
    g_T = rng.normal(size=(GI_T, GI_T)).astype(np.float32)

    @jax.jit
    def fwd_and_vjp(pp):
        out, vjp = jax.vjp(
            lambda q: j_sg._march_fwd_impl(cfg, q, jg.extra, gm), pp)
        return out, vjp((jnp.asarray(g_acc), jnp.asarray(g_T)))[0]

    (a, T), gs = fwd_and_vjp(pperm)
    inputs = dict(
        planar=p16, params=np.asarray(j_sg._pack_geom_params(
            geom, cfg, 1.0 / geom.scale)),
        zb=np.asarray(jnp.stack([geom.z_lo_pix, geom.z_hi_pix])),
        perm=perm, flip=flip, g_acc=g_acc, g_T=g_T)
    return inputs, (np.asarray(a), np.asarray(T), np.asarray(gs))


@pytest.fixture(scope="module")
def ranks_and_refs():
    inputs, ref = _march_inputs()
    cases = (
        ("frame2", 2, "zframe", {}),
        ("frame4", 4, "zframe", {}),
        ("frame4_slab_dirs", 4, "zframe", dict(dir_win=False)),
        ("forward4", 4, "zframe", dict(back=FWD_CAM["back"],
                                       center=FWD_CAM["center"])),
        ("batched4", 4, "zframes_batched", {}),
        ("march2", 2, "zmarch", dict(inputs=inputs)),
        ("march4", 4, "zmarch", dict(inputs=inputs)),
        ("grad4", 4, "ztrain_grad", {}),
        ("step4", 4, "ztrain_steps", {}),
        ("descend4", 4, "ztrain_steps", dict(steps=15, compare=False)),
        ("frames4", 4, "frames_sharded", {}),
        ("frames2", 2, "frames_sharded", {}),
    )
    return td.world(4, cases), ref


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded frames of the z-sharded cases' poses, with the
    segment semantics (stop_thresh 0, no renormalization)."""
    _, grid = td.zscene()
    out = {}
    for key, c in (("flip", FLIP_CAM), ("fwd", FWD_CAM)):
        cam = _cam(c["center"], c["back"])
        perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                                cam.fy, 32, 32)
        out[key] = (slab_render.render_frame(
            grid, cam.transform, cam.fx, cam.fy, perm, flip, 32, 32, SEG_OPT,
            gi=96).numpy(), flip)
    return out


def _reference_frame(monkeypatch, c):
    """The reference's unsharded slab frame (Pallas in interpret mode)."""
    _, _, _, jg = scene("dense", 4, "f16")
    cam = _cam(c["center"], c["back"])
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       32, 32)
    with interpret(monkeypatch):
        return np.asarray(j_slab.render_frame(
            jg, jnp.asarray(cam.transform), cam.fx, cam.fy, perm, flip, 32,
            32, SEG_JOPT, gi=96))


def _against_reference(got, want):
    """The port's frame against the reference's: rgb PSNR >= 45 dB, alpha
    within 2e-2 (tests/test_torch_frames.py's gate: the reference's kernel
    rounds its warp weights to bf16, the port's does not)."""
    assert psnr(got[..., :3], want[..., :3]) >= 45.0
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=2e-2)
    assert float(want[..., 3].max()) > 0.5          # the scene is in view


def _same(outs):
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("n", [2, 4])
def test_slab_zsharded_matches_single(ranks_and_refs, unsharded, n):
    """The payload z-sharded over 2 and 4 ranks, each marching its segment
    through kernel M (z_base), the parts gathered and folded (this pose
    marches toward -z: the fold runs from the last rank down): the frame
    equals the unsharded slab frame (K-aligned segments reproduce the
    window directions, so far closer than the 3e-3 allowed)."""
    res, _ = ranks_and_refs
    got = _same(td.result(res, f"frame{n}"))
    want, flip = unsharded["flip"]
    assert flip
    np.testing.assert_allclose(got, want, atol=3e-3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_slab_zsharded_matches_reference(ranks_and_refs, monkeypatch):
    """The four-rank z-sharded frame against the reference's unsharded
    slab frame with the segment semantics (its Pallas kernels in
    interpret mode), at the port's frame gate (_against_reference)."""
    res, _ = ranks_and_refs
    got = _same(td.result(res, "frame4"))
    _against_reference(got, _reference_frame(monkeypatch, FLIP_CAM))


def test_slab_zsharded_per_slab_directions(ranks_and_refs, unsharded):
    """With per-slab shading directions (slab_march._DIR_WIN off) the
    z-sharded frame equals the unsharded one marched the same way."""
    res, _ = ranks_and_refs
    got = _same(td.result(res, "frame4_slab_dirs"))
    _, grid = td.zscene()
    cam = _cam(FLIP_CAM["center"], FLIP_CAM["back"])
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, 32, 32)
    prev = slab_march._DIR_WIN
    slab_march._DIR_WIN = False
    try:
        want = slab_render.render_frame(grid, cam.transform, cam.fx, cam.fy,
                                        perm, flip, 32, 32, SEG_OPT, gi=96)
    finally:
        slab_march._DIR_WIN = prev
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_slab_zsharded_forward_direction(ranks_and_refs, unsharded,
                                         monkeypatch):
    """A pose marching toward +z: segments fold in ascending rank order;
    against the unsharded frame and the reference's."""
    res, _ = ranks_and_refs
    got = _same(td.result(res, "forward4"))
    want, flip = unsharded["fwd"]
    assert not flip
    np.testing.assert_allclose(got, want, atol=3e-3)
    _against_reference(got, _reference_frame(monkeypatch, FWD_CAM))


def test_slab_zsharded_batched_matches_per_pose(ranks_and_refs):
    """Three poses of one group in one launch a rank == the per-pose
    calls."""
    res, _ = ranks_and_refs
    batch, single = td.result(res, "batched4")[0]
    assert batch.shape == (3, 32, 32, 4)
    np.testing.assert_allclose(batch, single, atol=2e-3)


def test_zsharded_segments_raise():
    """A mesh axis that does not divide G, or segments that split the
    display march's K-slab shading windows, raise ValueError naming the
    reason (per-slab directions take any divisor)."""
    from volrend_torch.parallel import dist
    with pytest.raises(ValueError, match="not divisible"):
        dist._check_segments(16, 3, True)
    with pytest.raises(ValueError, match="4-slab windows"):
        dist._check_segments(16, 8, True)
    assert dist._check_segments(16, 8, False) == 2
    assert dist._check_segments(16, 4, True) == 4


@pytest.mark.parametrize("n", [2, 4])
def test_zsharded_train_march_matches_whole_and_reference(ranks_and_refs,
                                                          n):
    """The z-sharded training march (kernel M's training mode on each
    rank's segment, the fold; M-bwd from each segment's incoming (T, A),
    the segments' cotangents gathered): its output and payload gradient
    against the port's unsharded march and against the reference's scan
    march and jax.vjp on the same bf16-rounded payload."""
    res, (a, T, gs) = ranks_and_refs
    outs = td.result(res, f"march{n}")
    z, whole = outs[0]["z"], outs[0]["whole"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["z"][2], z[2])
    np.testing.assert_allclose(z[0], whole[0], atol=1e-6)
    np.testing.assert_allclose(z[1], whole[1], atol=1e-6)
    np.testing.assert_allclose(z[0], a, atol=5e-6)
    np.testing.assert_allclose(z[1], T, atol=5e-6)
    for g in (whole[2], gs):
        rel = np.linalg.norm(z[2] - g) / np.linalg.norm(g)
        assert rel < 1e-5, rel


def test_zsharded_frame_gradient_matches_unsharded(ranks_and_refs):
    """The whole training frame (bake, z-sharded march, precise warp) over
    four ranks: loss and leaf gradient against the unsharded kernel path
    (relative 1e-5)."""
    res, _ = ranks_and_refs
    out = td.result(res, "grad4")
    (lz, gz), (lu, gu) = out[0]["z"], out[0]["whole"]
    assert np.isclose(lz, lu, rtol=1e-5)
    assert np.linalg.norm(gz - gu) / np.linalg.norm(gu) < 1e-5
    np.testing.assert_array_equal(out[-1]["z"][1], gz)


def test_frame_trainer_zsharded_step_matches_unsharded(ranks_and_refs):
    """FrameTrainer.step_frame_zsharded over four ranks equals step_frame:
    the loss within 1e-5 relative, the pyramid after the step within atol
    2e-4, rtol 1e-4; every rank holds the same parameters."""
    res, _ = ranks_and_refs
    outs = td.result(res, "step4")
    o = outs[0]
    assert abs(o["z"][0] - o["whole"][0]) <= 1e-5 * max(1.0,
                                                        abs(o["whole"][0]))
    for pz, pu in zip(o["pz"], o["pu"]):
        np.testing.assert_allclose(pz, pu, atol=2e-4, rtol=1e-4)
    for other in outs[1:]:
        for a, b in zip(other["pz"], o["pz"]):
            np.testing.assert_array_equal(a, b)


def test_frame_trainer_zsharded_descends(ranks_and_refs):
    """Fifteen z-sharded steps over four ranks: the loss falls below 0.6
    of the first (tests/test_slab_grad.py's criterion)."""
    res, _ = ranks_and_refs
    losses = td.result(res, "descend4")[0]["z"]
    assert losses[-1] < 0.6 * losses[0], losses


@pytest.mark.parametrize("n", [2, 4])
def test_frame_trainer_sharded_matches_single(ranks_and_refs, n):
    """Four poses sharded over 2 and 4 ranks (one all-reduce): the loss
    equals the mean of the per-frame losses and the gradients the mean of
    the per-frame gradients; one FrameTrainer.step_frames_sharded step
    equals the same step in a one-rank world."""
    res, _ = ranks_and_refs
    outs = td.result(res, f"frames{n}")
    o = outs[0]
    assert np.isclose(o["loss"], np.mean(o["per_loss"]), rtol=1e-5)
    for k, g in enumerate(o["grads"]):
        want = np.mean([p[k] for p in o["per_grads"]], 0)
        if not np.abs(want).max():
            assert not np.abs(g).max()
            continue
        assert np.linalg.norm(g - want) / np.linalg.norm(want) < 1e-5
    ls, l1 = o["step"]
    assert abs(ls - l1) <= 1e-5 * max(1.0, abs(l1))
    for a, b in zip(o["ps"], o["p1"]):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4)
    for other in outs[1:]:
        for a, b in zip(other["ps"], o["ps"]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The segment algebra on the plain versions (no ranks)
# ---------------------------------------------------------------------------

def _display_inputs(dtype):
    _, grid = scene("dense", 4, dtype)[:2]
    cam = _cam(FLIP_CAM["center"], FLIP_CAM["back"])
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, 32, 32)
    g = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                              flip, 32, 32, SEG_OPT, 48)
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip,
                                                 SEG_OPT)
    return grid, perm, flip, params, zb


@pytest.mark.parametrize("dtype", ["int8", "f16"])
@pytest.mark.parametrize("n", [2, 4])
def test_display_segments_chained_equal_whole_grid(dtype, n):
    """Kernel M's display mode (plain version) on n z-segments, each
    started from the upstream segments' state (``acc_init``) at its own
    ``z_base``, ends where the whole-grid march ends, bit for bit; the
    independent segments folded front to back agree to f32 rounding; a
    segment with no slab returns its acc_init."""
    from volrend_torch.parallel import dist
    grid, perm, flip, params, zb = _display_inputs(dtype)
    G = grid.G
    kw = dict(sig2=grid.quantized, flip=flip, bbox_full=True, dir_win=True)
    args = (grid.qscale, zb, G, 48, grid.data_dim, grid.basis_dim, perm)
    whole = slab_march.march_slabs(
        slab_render._permuted_grid(grid, perm), params, *args,
        slab_ids=tuple(range(G - 1, -1, -1) if flip else range(G)), **kw)
    Gl = G // n
    order = list(range(n - 1, -1, -1) if flip else range(n))
    lids = tuple(range(Gl - 1, -1, -1) if flip else range(Gl))
    acc, parts = None, {}
    for i in order:
        pay = dist._zsegment(grid, perm, Gl, i)
        acc = slab_march.march_slabs(pay, params, *args, slab_ids=lids,
                                     z_base=i * Gl / G, acc_init=acc, **kw)
        parts[i] = slab_march.march_slabs(pay, params, *args,
                                          slab_ids=lids, z_base=i * Gl / G,
                                          **kw)
    np.testing.assert_array_equal(acc.numpy(), whole.numpy())
    C, T = dist.fold_segments(torch.stack([parts[i] for i in range(n)]),
                              order, 1)
    np.testing.assert_allclose(torch.cat([C, T[:, None]], 1).numpy(),
                               whole.numpy(), atol=1e-6)
    empty = slab_march.march_slabs(pay, params, *args, slab_ids=(),
                                   z_base=0.5, acc_init=acc[0], **kw)
    np.testing.assert_array_equal(empty.numpy(), acc.numpy())


def test_display_segment_matches_reference_kernel(monkeypatch):
    """The second of two int8 segments, started from a seeded upstream
    state, against the reference's Pallas kernel with the same z_base and
    acc_init (interpret mode), at tests/test_torch_march.py's tolerance:
    rgb PSNR >= 45 dB, T within 2e-2 (the reference rounds its warp
    weights and channels to bf16)."""
    from _torch_scenes import np32, to_torch
    from volrend_tpu.ops import pallas_slab
    _, _, _, jg = scene("dense", 4, "int8")
    cam = _cam(FLIP_CAM["center"], FLIP_CAM["back"])
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       32, 32)
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, 32, 32, SEG_JOPT, 48)
    params, zb = j_slab._pallas_frame_fields(jg, geom, perm, flip, SEG_JOPT)
    planar = j_slab._permuted_grid(jg, perm, True)[0]
    G, Gl = jg.G, jg.G // 2
    i = 0 if flip else 1          # the downstream segment
    seg = planar[i * Gl:(i + 1) * Gl]
    acc0 = np.random.default_rng(3).uniform(0.2, 1.0, (4, 48, 48)).astype(
        np.float32)
    kw = dict(slab_ids=tuple(range(Gl - 1, -1, -1) if flip else range(Gl)),
              sig2=True, fmt=int(jg.fmt), flip=flip, bbox_full=True,
              dir_win=True, k_per_step=4)
    with interpret(monkeypatch):
        want = pallas_slab.march_slabs(
            seg, params, jg.qscale, zb, G, 48, jg.data_dim, jg.basis_dim,
            perm, z_base=i * Gl / G, acc_init=jnp.asarray(acc0), **kw)
    got = slab_march.march_slabs(
        to_torch(seg), to_torch(params)[None], to_torch(jg.qscale),
        to_torch(zb)[None], G, 48, jg.data_dim, jg.basis_dim, perm,
        z_base=i * Gl / G, acc_init=torch.tensor(acc0), **kw)
    got, want = got[0].numpy(), np32(want)
    assert psnr(got[:3], want[:3]) >= 45.0
    np.testing.assert_allclose(got[3], want[3], atol=2e-2)
    assert float(got[3].min()) < 0.9       # the segment holds the scene


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("sign", [-1.0, 1.0], ids=["forward", "flip"])
def test_zsharded_bwd_prefix_matches_unsharded(n, sign):
    """The backward prefix on its own: per-segment march_slabs_bwd (plain
    version) from (T_in, A_in) rebuilt from the forward's parts
    (slab_grad.segment_states) equals the unsharded backward on the same
    bf16 payload, 2, 4 and 8 segments, both march directions (relative L2
    < 1e-5; tests/test_slab_grad.py's gate on the reference's kernels)."""
    tdev, grid = td.zscene()
    bmap = slab_grad.build_bake_map(tdev)
    bake = slab_grad.bake_from_data(tdev.data.float(), bmap)
    back = (sign * 0.92, 0.2, 0.27)
    cam = _cam(tuple(2.5 * np.asarray(back) / np.linalg.norm(back)), back,
               24, 30.0)
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, 24, 24)
    assert flip == (sign > 0)
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, 24, 24, SEG_OPT, GI_T)
    G, D, bd = grid.G, grid.data_dim, grid.basis_dim
    cfg = slab_grad.SlabCfg(G=G, gi=GI_T, D=D, bd=bd, fmt=int(grid.fmt),
                            perm=perm, flip=flip, ids=(), opt=SEG_OPT)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)[0]
    zb = torch.stack([geom.z_lo_pix[0], geom.z_hi_pix[0]])
    q = (perm[0], 3, perm[1], perm[2])
    planar = bake.to(torch.bfloat16).permute(*q).contiguous()
    qs = torch.ones(D)
    gacc4 = torch.as_tensor(np.random.default_rng(11).normal(
        size=(4, GI_T, GI_T)).astype(np.float32))
    kw = dict(flip=flip, bbox_full=True)
    whole_acc = slab_march.march_slabs(
        planar, params[None], qs, zb[None], G, GI_T, D, bd, perm,
        slab_ids=tuple(range(G - 1, -1, -1) if flip else range(G)),
        dir_win=False, **kw)[0]
    whole = slab_march.march_slabs_bwd(planar, params, qs, zb, gacc4,
                                       whole_acc, G, GI_T, D, bd, perm, **kw)
    Gl = G // n
    order = list(range(n - 1, -1, -1) if flip else range(n))
    lids = tuple(range(Gl - 1, -1, -1) if flip else range(Gl))
    parts = torch.stack([slab_march.march_slabs(
        planar[i * Gl:(i + 1) * Gl], params[None], qs, zb[None], G, GI_T, D,
        bd, perm, slab_ids=lids, dir_win=False, z_base=i * Gl / G, **kw)[0]
        for i in range(n)])
    states = slab_grad.segment_states(parts, gacc4, order)
    segs = [slab_march.march_slabs_bwd(
        planar[i * Gl:(i + 1) * Gl], params, qs, zb, gacc4, whole_acc, G,
        GI_T, D, bd, perm, z_base=i * Gl / G, state_init=states[i], **kw)
        for i in range(n)]
    got = torch.cat(segs).double()
    rel = float((got - whole.double()).norm() / whole.double().norm())
    assert rel < 1e-5, rel


def test_train_segments_chained_equal_whole_grid():
    """Kernel M's training mode (plain version) on two z-segments of a
    bake (slab_grad.zsegment), the second resumed from the first
    (acc_init, z_base), equals the whole-grid march; the segment payload
    (slab axis outermost) passes the backward kernel's stride check, a
    z-slice in the bake's own layout or a strided view does not."""
    tdev, grid = td.zscene()
    bmap = slab_grad.build_bake_map(tdev)
    bake = slab_grad.bake_from_data(tdev.data.float(), bmap)
    cam = _cam(FLIP_CAM["center"], FLIP_CAM["back"], 24, 30.0)
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, 24, 24)
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, 24, 24, SEG_OPT, GI_T)
    G, D, bd = grid.G, grid.data_dim, grid.basis_dim
    cfg = slab_grad.SlabCfg(G=G, gi=GI_T, D=D, bd=bd, fmt=int(grid.fmt),
                            perm=perm, flip=flip, ids=(), opt=SEG_OPT)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    q = (perm[0], 3, perm[1], perm[2])
    qs = torch.ones(D)
    kw = dict(flip=flip, bbox_full=True, dir_win=False, train=True)
    whole = slab_march.march_slabs(
        bake.permute(*q), params, qs, zb, G, GI_T, D, bd, perm,
        slab_ids=tuple(range(G - 1, -1, -1) if flip else range(G)), **kw)
    Gl = G // 2
    acc = None
    for i in ([1, 0] if flip else [0, 1]):
        seg = slab_grad.zsegment(bake.permute(*q), i, Gl)
        assert slab_march._record_strides(seg, bake=True)
        acc = slab_march.march_slabs(
            seg, params, qs, zb, G, GI_T, D, bd, perm,
            slab_ids=tuple(range(Gl - 1, -1, -1) if flip else range(Gl)),
            z_base=i * Gl / G, acc_init=acc, **kw)
    np.testing.assert_array_equal(acc.numpy(), whole.numpy())
    # a z-slice whose voxel records run slab-innermost
    inner = bake.narrow(perm[0], 0, Gl).permute(
        perm[1], perm[2], perm[0], 3).contiguous().permute(2, 3, 0, 1)
    with pytest.raises(ValueError, match="z-segment"):
        slab_march._record_strides(inner, bake=True)
    with pytest.raises(ValueError, match="z-segment"):
        slab_march._record_strides(bake.permute(*q)[:, :, :, :Gl],
                                   bake=True)


@pytest.mark.parametrize("over", [dict(cull=True), dict(backend="scan"),
                                  dict(use_custom_vjp=False)],
                         ids=["cull", "scan", "no_custom_vjp"])
def test_zsharded_march_refuses_what_it_cannot_shard(over):
    """render_frame_train with a mesh takes the fused kernels over every
    slab: a culled slab list or the scan march raises ValueError instead
    of running unsharded."""
    from volrend_torch.parallel import mesh as mesh_mod
    tdev, grid = td.zscene()
    bmap = slab_grad.build_bake_map(tdev)
    cam = _cam(FLIP_CAM["center"], FLIP_CAM["back"], 24, 30.0)
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, 24, 24)
    with pytest.raises(ValueError, match="z-sharded march"):
        slab_grad.render_frame_train(
            tdev.data.float(), bmap, grid, cam.transform, cam.fx, cam.fy,
            perm, flip, 24, 24, SEG_OPT, GI_T,
            mesh=mesh_mod.make_mesh("z", device="cpu"), **over)


@pytest.mark.slow
def test_scaled_sharded_epoch_with_midrun_resume(tmp_path):
    """tests/test_train.py's slow case on the port: the fast slab pipeline
    at 256^2, 8 poses sharded over an 8-rank gloo world, 4 epochs; a run
    checkpointed after 2 epochs and restored into a fresh trainer. The
    PSNR of pose 0 rises by more than 3 dB, and the resumed run ends bit
    for bit where the uninterrupted one does. Marked slow as the
    reference marks its own."""
    res = td.world(8, (("epoch", 8, "scaled_epoch",
                        dict(ckpt=str(tmp_path / "mid.npz"))),))
    outs = td.result(res, "epoch")
    o = outs[0]
    assert o["p1"] > o["p0"] + 3.0, (o["p0"], o["p1"])
    assert o["steps"] == 2
    assert all(r["equal"] for r in outs)
