"""The port's CUDA kernels on the card, against their plain PyTorch versions
and against the CPU run of the same display path. These need an NVIDIA GPU
and nvcc (a CUDA kernel has no interpret mode): marked ``cuda``, they skip
on a machine without a card. This file imports neither JAX nor the JAX
package, so on a machine without JAX it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from volrend_torch.models.synthetic import make_solid_tree, make_test_tree
from volrend_torch.ops import dense_grid, display_warp, slab_march, \
    slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.options import RenderOptions

pytestmark = pytest.mark.cuda

W = H = 160
GI = 64
OPT = RenderOptions(max_steps=512)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["dense", "solid"])
def grids(card, request):
    """(cpu grid, cuda grid) of one scene (G=32 dense fog / G=64 solid)."""
    if request.param == "dense":
        tree = make_test_tree(max_depth=4, basis_dim=16, seed=5,
                              sigma_scale=60.0)
    else:
        tree = make_solid_tree(max_depth=5, basis_dim=16, seed=3)
    cpu = dense_grid.bake_dense(tree.to_device(lut_depth=None, device="cpu"),
                                dtype="int8")
    gpu = dense_grid.bake_dense(tree.to_device(lut_depth=None, device=card),
                                dtype="int8")
    return cpu, gpu


def _cams(backs, fx=200.0):
    out = []
    for b in backs:
        b = np.asarray(b, np.float64)
        b /= np.linalg.norm(b)
        up = (0.0, 0.0, 1.0) if abs(b[2]) < 0.9 else (0.0, 1.0, 0.0)
        out.append(Camera.from_vectors(center=tuple(2.5 * b),
                                       v_back=tuple(b), v_world_up=up,
                                       width=W, height=H, fx=fx))
    return out


def test_bake_on_card_bit_equal(grids):
    cpu, gpu = grids
    assert torch.equal(cpu.data, gpu.data.cpu())
    assert torch.equal(cpu.qscale, gpu.qscale.cpu())
    assert cpu.occ_max == gpu.occ_max


@pytest.mark.parametrize("fx", [200.0, 80.0])
def test_kernels_match_plain_versions(grids, fx):
    """Kernels M, B and C against their plain versions on the same CUDA
    tensors (fx=80: a steep pose, slope ~3.5, footprints over several
    pieces)."""
    _, g = grids
    cams = _cams([(1.0, 0.25, 0.35), (1.0, 0.1, 0.45)], fx)
    perm, flip, slope = slab_render.choose_axis(g, cams[0].transform, fx,
                                                fx, W, H)
    assert slope < slab_render.MAX_SLAB_SLOPE
    crop = slab_render.inplane_crop(g, perm, OPT.sigma_thresh)
    pay = slab_render.prepare_payload(g, perm, OPT)
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 fx, fx, perm, flip, W, H, OPT, GI)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, OPT)
    ids = g.slab_ids(perm[0], flip, OPT.sigma_thresh)
    n0 = slab_march.march_slabs.launches
    acc = slab_march.march_slabs(
        pay, params, g.qscale, zb, g.G, GI, g.data_dim, g.basis_dim, perm,
        slab_ids=ids, sig2=True, flip=flip, bbox_full=True, dir_win=True,
        crop=crop)
    assert slab_march.march_slabs.launches == n0 + 1
    m = slab_march.march_inputs(pay, params, zb, g.G, GI, ids, 4, crop)
    ref = slab_march.march_slabs_ref(pay, g.qscale, D=g.data_dim,
                                     bd=g.basis_dim, flip=flip, **m)
    torch.cuda.synchronize()
    assert float((acc - ref).abs().max()) < 1e-3

    inter = slab_render._finalize_planar(acc, OPT).contiguous()
    tbl = display_warp.build_table(inter, (5, 5))
    assert torch.equal(tbl, display_warp.build_table_ref(inter, (5, 5)))
    gys, gxs, okm, Y0, X0 = display_warp._level_geometry(
        (geom.R, geom.fx, geom.fy, W, H, GI, perm, geom.u0, geom.du,
         geom.v0, geom.dv, geom.scale), GI, (4, 4), (5, 5))
    args = (tbl, Y0.contiguous(), X0.contiguous(),
            (gys - Y0.float()[:, None]).contiguous(),
            (gxs - X0.float()[:, None]).contiguous(), okm.contiguous(), GI,
            H, W, (4, 4), (5, 5), 1.0)
    for od, tol in ((torch.uint8, 1.0), (None, 1e-5)):
        got = display_warp.combine_emit(*args, out_dtype=od)
        want = display_warp.combine_emit_ref(*args, out_dtype=od)
        assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("out_dtype", [torch.uint8, None])
def test_render_frames_card_matches_cpu(grids, out_dtype):
    """The whole display path on the card equals the CPU run (the plain
    kernel versions) to float rounding."""
    cpu, gpu = grids
    cams = _cams([(1.0, 0.25, 0.35), (1.0, 0.1, 0.45), (1.0, 0.3, 0.2)])
    perm, flip, _ = slab_render.choose_axis(cpu, cams[0].transform, 200.0,
                                            200.0, W, H)
    trs = np.stack([c.transform for c in cams])
    a = slab_render.render_frames(cpu, trs, 200.0, 200.0, perm, flip, W, H,
                                  OPT, gi=GI, out_dtype=out_dtype)
    n0 = display_warp.combine_emit.poses
    b = slab_render.render_frames(gpu, trs, 200.0, 200.0, perm, flip, W, H,
                                  OPT, gi=GI, out_dtype=out_dtype).cpu()
    assert display_warp.combine_emit.poses == n0 + 3
    tol = 1.0 if out_dtype == torch.uint8 else 1e-4
    assert float((a.float() - b.float()).abs().max()) <= tol


def test_wrappers_check_their_inputs(card):
    """A launch with a wrong dtype, shape or layout raises before the
    kernel runs."""
    inter = torch.zeros((1, 4, 32, 32), device=card)
    with pytest.raises(ValueError):
        display_warp.build_table(inter.double(), (4, 4))
    with pytest.raises(ValueError):
        display_warp.build_table(inter.transpose(2, 3), (4, 4))


# ---------------------------------------------------------------------------
# Training path: kernel M in its training mode and the backward kernel
# ---------------------------------------------------------------------------

# tolerances, as in chip_smoke.py: f32 both ways, summation order differs
TOL_TRAIN_M = 1e-3
MAX_FREEZE_FLIPS = 1e-4       # share of rays (stop-threshold freeze flips)
TOL_BWD_REL = 1e-3            # relative L2 of the payload cotangent
MIN_BWD_COS = 0.9999


@pytest.fixture(scope="module")
def train_parts(card):
    """A G=64 SH9 solid scene on the card, one orbit pose at gi=64: the
    march config, the training march's bf16 planar payload, params, z
    interval, and a seeded upstream cotangent."""
    from volrend_torch.ops import slab_grad
    tree = make_solid_tree(max_depth=5, basis_dim=9, seed=7)
    tdev = tree.to_device(lut_depth=None, device=card)
    grid = dense_grid.bake_dense(tdev)
    cam = _cams([(np.cos(0.25), np.sin(0.25), 0.45)], fx=200.0)[0]
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, W, H)
    opt = OPT.replace(renormalize=False)
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, W, H, opt, GI)
    ids = tuple(range(grid.G - 1, -1, -1) if flip else range(grid.G))
    cfg = slab_grad.SlabCfg(G=grid.G, gi=GI, D=grid.data_dim,
                            bd=grid.basis_dim, fmt=int(grid.fmt), perm=perm,
                            flip=flip, ids=ids, opt=opt)
    planar = grid.data.permute(perm[0], 3, perm[1], perm[2]).to(
        torch.bfloat16).contiguous()
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    rng = np.random.default_rng(0)
    gacc4 = torch.as_tensor(rng.normal(size=(4, GI, GI)).astype(np.float32),
                            device=card)
    return cfg, planar, params, zb, gacc4


def _march_train(cfg, planar, params, zb):
    return slab_march.march_slabs(
        planar, params, torch.ones(cfg.D, device=planar.device), zb, cfg.G,
        GI, cfg.D, cfg.bd, cfg.perm, slab_ids=cfg.ids, flip=cfg.flip,
        bbox_full=True, dir_win=False)


def test_train_march_matches_plain(train_parts):
    cfg, planar, params, zb, _ = train_parts
    n0 = slab_march.march_slabs.launches
    acc = _march_train(cfg, planar, params, zb)
    assert slab_march.march_slabs.launches == n0 + 1
    m = slab_march.march_inputs(planar, params, zb, cfg.G, GI, cfg.ids)
    ref = slab_march.march_slabs_ref(planar, torch.ones(cfg.D,
                                                        device=planar.device),
                                     D=cfg.D, bd=cfg.bd, flip=cfg.flip, **m)
    torch.cuda.synchronize()
    diff = (acc - ref).abs().amax(1)
    off = diff > TOL_TRAIN_M
    sat = torch.maximum(acc[:, 3], ref[:, 3]) < OPT.stop_thresh
    assert float(acc[:, 3].min()) < 0.5       # the scene was seen
    assert bool(torch.all(sat[off]))
    assert int(off.sum()) <= MAX_FREEZE_FLIPS * off.numel() + 1


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_march_bwd_matches_plain(train_parts, out_dtype):
    cfg, planar, params, zb, gacc4 = train_parts
    acc4 = _march_train(cfg, planar, params, zb)[0]
    qs = torch.ones(cfg.D, device=planar.device)
    n0 = slab_march.march_slabs_bwd.launches
    gk = slab_march.march_slabs_bwd(planar, params[0], qs, zb[0], gacc4,
                                    acc4, cfg.G, GI, cfg.D, cfg.bd,
                                    cfg.perm, flip=cfg.flip, bbox_full=True,
                                    out_dtype=out_dtype)
    assert slab_march.march_slabs_bwd.launches == n0 + 1
    assert gk.dtype == out_dtype
    ref = slab_march.march_slabs_bwd(planar.cpu(), params[0].cpu(), qs.cpu(),
                                     zb[0].cpu(), gacc4.cpu(), acc4.cpu(),
                                     cfg.G, GI, cfg.D, cfg.bd, cfg.perm,
                                     flip=cfg.flip, bbox_full=True)
    gk = gk.float().cpu().double()
    ref = ref.double()
    rel = float((gk - ref).norm() / ref.norm())
    cos = float((gk * ref).sum() / (gk.norm() * ref.norm()))
    # bf16 output: the f32 cotangent rounded once (2^-9 relative)
    tol = TOL_BWD_REL if out_dtype == torch.float32 else 4e-3
    assert float(ref.abs().max()) > 0
    assert rel < tol and cos > MIN_BWD_COS, (rel, cos)


def test_frame_train_card_matches_cpu(card):
    """loss_and_grad_frame through both kernels on the card equals the CPU
    run (their plain versions) on a G=16 scene."""
    from volrend_torch.ops import slab_grad
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5,
                          sigma_scale=60.0)
    out = []
    for dev in ("cpu", card):
        tdev = tree.to_device(lut_depth=None, device=dev)
        grid = dense_grid.bake_dense(tdev)
        bmap = slab_grad.build_bake_map(tdev)
        pyr = slab_grad.data_to_pyramid(tdev.data.float(), bmap)
        cam = _cams([(1.0, 0.2, 0.3)], fx=60.0)[0]
        perm, flip, _ = slab_render.choose_axis(grid, cam.transform, 60.0,
                                                60.0, 48, 48)
        tgt = torch.zeros((48, 48, 4), device=dev)
        n0 = slab_march.march_slabs_bwd.launches
        loss, g = slab_grad.loss_and_grad_frame(
            pyr, bmap, grid, cam.transform, 60.0, 60.0, perm, flip, 48, 48,
            tgt, OPT, gi=48)
        if dev != "cpu":
            assert slab_march.march_slabs_bwd.launches == n0 + 1
        out.append((float(loss), torch.cat([x.reshape(-1).cpu()
                                            for x in g]).double()))
    (l_c, g_c), (l_g, g_g) = out
    assert np.isclose(l_c, l_g, rtol=1e-5)
    assert float((g_c - g_g).norm() / g_c.norm()) < 1e-3


def test_frame_trainer_on_card_uses_the_kernels(card):
    """Every step_frame runs one launch of each kernel (default and lean
    trainers) and descends."""
    from volrend_torch.train import FrameTrainer
    tree = make_solid_tree(max_depth=4, basis_dim=9, seed=7)
    tdev = tree.to_device(lut_depth=None, device=card)
    cams = _cams([(np.cos(0.25), np.sin(0.25), 0.45)], fx=200.0)
    for lean in (False, True):
        tr = FrameTrainer(tdev, opt=OPT, lr=5e-2, gi=64, lean=lean)
        tgt = torch.full((H, W, 4), 0.5, device=card)
        m0 = slab_march.march_slabs.launches
        b0 = slab_march.march_slabs_bwd.launches
        losses = [tr.step_frame(cams[0], tgt) for _ in range(3)]
        assert slab_march.march_slabs.launches == m0 + 3
        assert slab_march.march_slabs_bwd.launches == b0 + 3
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert tr.pyramid[-1].device.type == "cuda"
