"""The port's CUDA kernels on the card, against their plain PyTorch versions
and against the CPU run of the same display path. These need an NVIDIA GPU
and nvcc (a CUDA kernel has no interpret mode): marked ``cuda``, they skip
on a machine without a card. This file imports neither JAX nor the JAX
package, so on a machine without JAX it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from volrend_torch.models.synthetic import make_solid_tree, make_test_tree
from volrend_torch.ops import dense_grid, display_warp, slab_march, \
    slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.probes._common import mean_fits, table_warp_level
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
    n0 = display_warp.warp_display.poses
    b = slab_render.render_frames(gpu, trs, 200.0, 200.0, perm, flip, W, H,
                                  OPT, gi=GI, out_dtype=out_dtype).cpu()
    assert display_warp.warp_display.poses == n0 + 3
    tol = 1.0 if out_dtype == torch.uint8 else 1e-4
    assert float((a.float() - b.float()).abs().max()) <= tol


# ---------------------------------------------------------------------------
# Kernel W (csrc/warp_display.cu): the display path's fused warp and its
# fit mode, against their plain versions and the parent's composition of
# the PyTorch geometry with kernels B and C
# ---------------------------------------------------------------------------

LEVELS = display_warp._CASCADE


def _warp_case(g, fx=200.0, backs=((1.0, 0.25, 0.35), (1.0, 0.1, 0.45),
                                   (1.0, 0.3, 0.2))):
    """(geometry args, (P, 16) parameter rows, seeded (P, 4, gi, gi)
    planes with values outside [0, 1] too) for poses on grid ``g``."""
    cams = _cams(backs, fx)
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform, fx, fx,
                                            W, H)
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 fx, fx, perm, flip, W, H, OPT, GI)
    args = (geom.R, geom.fx, geom.fy, W, H, GI, perm, geom.u0, geom.du,
            geom.v0, geom.dv, geom.scale)
    prm = display_warp.display_params(geom.R, geom.fx, geom.fy, geom.u0,
                                      geom.du, geom.v0, geom.dv, geom.scale,
                                      perm)
    inter = torch.as_tensor(np.random.default_rng(3).uniform(
        -0.1, 1.1, (len(cams), 4, GI, GI)).astype(np.float32),
        device=g.data.device)
    return args, prm, inter


#: the production levels (their own instantiations) and levels of the
#: generic kernel: a non-square block and window, 8 x 8 blocks, and blocks
#: wider than 8 with the largest window
W_LEVELS = LEVELS + (((2, 4), (4, 5)), ((8, 8), (4, 4)),
                     ((16, 10), (8, 8)))


@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("level", W_LEVELS)
def test_warp_display_matches_plain_and_parent(grids, out_dtype, level):
    """W on two of three poses, in place: the parent's composition (the
    same arithmetic, so equal), the plain version (einsum sums the window
    in another order: uint8 within one quantum, f32 within 1e-5), and the
    third pose's slot untouched."""
    _, g = grids
    B, win = level
    args, prm, inter = _warp_case(g)
    sel = torch.tensor([2, 0], dtype=torch.int32, device=g.data.device)
    fill = 7 if out_dtype == torch.uint8 else -3.0
    out = torch.full((3, H, W, 4), fill, dtype=out_dtype,
                     device=g.data.device)
    n0 = (display_warp.warp_display.launches, display_warp.warp_display.poses)
    got = display_warp.warp_display(inter, prm, sel, out.clone(), B, win, GI,
                                    1.0)
    assert (display_warp.warp_display.launches,
            display_warp.warp_display.poses) == (n0[0] + 1, n0[1] + 2)
    assert torch.equal(got[1], out[1])
    want = display_warp.warp_display_ref(inter, prm, sel, out.clone(), B,
                                         win, GI, 1.0)
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= (1.0 if out_dtype == torch.uint8 else 1e-5)
    parent = table_warp_level(args, inter, sel.long(), B, win, 1.0,
                              torch.uint8 if out_dtype == torch.uint8
                              else None)
    assert torch.equal(got[sel.long()], parent)


@pytest.mark.parametrize("fx,levels", [
    (200.0, LEVELS), (80.0, LEVELS), (45.0, LEVELS),
    (80.0, (((1, 2), (4, 4)), ((2, 4), (4, 5)), ((4, 4), (5, 5)))),
    (80.0, (((2, 2), (4, 4)), ((5, 5), (6, 6))))])
def test_fit_counts_bit_equal(grids, fx, levels):
    """W's fit mode against its plain version on the card and on the CPU
    (bit-equal counts), and its decisions against the parent's
    predicates (torch.mean of the misfits on the card), for poses that
    fit, a steep and a wide one; and on two other level sets, three levels
    that nest in a 4 x 4 super block (positions shared, as for the
    production pair) and two that do not (each level its own positions)."""
    _, g = grids
    args, prm, _ = _warp_case(g, fx)
    n0 = display_warp.level_fit_counts.launches
    counts = display_warp.level_fit_counts(prm, levels, GI, H, W)
    assert display_warp.level_fit_counts.launches == n0 + 1
    assert torch.equal(counts, display_warp.level_fit_counts_ref(
        prm, levels, GI, H, W))
    assert torch.equal(counts.cpu(), display_warp.level_fit_counts_ref(
        prm.cpu(), levels, GI, H, W))
    fits = display_warp._fits_from_counts(counts, levels, H, W)
    want = mean_fits(args, levels)
    assert torch.equal(fits, want), counts
    gyf, gxf = display_warp._pixel_slopes(*args)
    for li, (B, win) in enumerate(levels):
        assert torch.equal(display_warp._level_fits(gyf, gxf, GI, B, win),
                           want[li])


def test_mixed_cascade_batch_on_card(grids):
    """One batch of steep poses, the last on a 7x finer slope grid so that
    it takes the reference warp while the others take a superquad level,
    on the card against the CPU: the same choices, the reference-warp pose
    counted, uint8 within one quantum."""
    cpu, gpu = grids
    outs = []
    for g in (cpu, gpu):
        args, _, inter = _warp_case(g, fx=80.0)
        R, fx, fy, w, h, gi, perm, u0, du, v0, dv, scale = args
        du = du * torch.tensor([1.0, 1.0, 1.0 / 7.0], device=du.device)
        plan = display_warp.plan_fits(R, fx, fy, w, h, gi, perm, u0, du, v0,
                                      dv, scale)
        choice = plan.choice()
        r0 = slab_render._warp_to_screen_ref.poses
        out = display_warp.warp_to_screen_sq(
            inter, OPT, R, fx, fy, w, h, gi, perm, u0, du, v0, dv, scale,
            out_dtype=torch.uint8, planar=True, plan=plan)
        assert slab_render._warp_to_screen_ref.poses == r0 + 1
        outs.append((choice, out.cpu()))
    (c_cpu, a), (c_gpu, b) = outs
    assert np.array_equal(c_cpu, c_gpu) and c_gpu[2] == -1
    assert float((a.float() - b.float()).abs().max()) <= 1.0


# ---------------------------------------------------------------------------
# Kernel M's display mode (csrc/slab_march_display.cu) against its plain
# version: f32 both, another summation order (TOL_M), and the rare
# stop-threshold freeze flip in a saturated ray (as chip_smoke.py allows)
# ---------------------------------------------------------------------------

TOL_M = 1e-3


def _agree(acc, ref):
    diff = (acc - ref).abs().amax(1)
    off = diff > TOL_M
    sat = torch.maximum(acc[:, 3], ref[:, 3]) < OPT.stop_thresh
    assert bool(torch.all(sat[off])), float(diff.max())
    assert int(off.sum()) <= MAX_FREEZE_FLIPS * off.numel() + 1
    assert float(diff.max()) <= OPT.stop_thresh + TOL_M


def _display_case(g, backs, fx=200.0, crop=None, cull=None):
    """One display batch on grid ``g``: (payload, params, zb, slab ids,
    perm, flip, crop). ``crop`` (y0, Gy, x0, Gx) slices the payload in
    plane; ``cull`` drops the slab ids it is true for."""
    cams = _cams(backs, fx)
    perm, flip, slope = slab_render.choose_axis(g, cams[0].transform, fx,
                                                fx, W, H)
    assert slope < slab_render.MAX_SLAB_SLOPE
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 fx, fx, perm, flip, W, H, OPT, GI)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, OPT)
    pay = slab_render._permuted_grid(g, perm, crop=crop)
    ids = tuple(range(g.G - 1, -1, -1) if flip else range(g.G))
    if cull is not None:
        ids = tuple(i for i in ids if not cull(i))
    return pay, params, zb, ids, perm, flip, crop


def _display_vs_plain(g, case, seen=True):
    pay, params, zb, ids, perm, flip, crop = case
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
    if seen:
        assert float(acc[:, 3].min()) < 0.9
    _agree(acc, ref)
    return acc


@pytest.fixture(scope="module", params=[1, 4, 9, 16, 25])
def sh_grid(card, request):
    """A G=32 fog scene of SH degree bd, baked int8 on the card."""
    tree = make_test_tree(max_depth=5, basis_dim=request.param, seed=5,
                          sigma_scale=60.0)
    return dense_grid.bake_dense(tree.to_device(lut_depth=None, device=card),
                                 dtype="int8")


@pytest.mark.parametrize("side", [1.0, -1.0])
def test_display_march_matches_plain(sh_grid, side):
    """The display kernel on every SH degree, marching toward +z and -z
    (both flips over the two sides)."""
    case = _display_case(sh_grid, [(side, 0.25, 0.35), (side, 0.1, 0.45)])
    _display_vs_plain(sh_grid, case)


def test_display_march_covers_both_flips(card):
    tree = make_test_tree(max_depth=5, basis_dim=1, seed=5)
    g = dense_grid.bake_dense(tree.to_device(lut_depth=None, device=card),
                              dtype="int8")
    flips = {_display_case(g, [(side, 0.25, 0.35)])[5]
             for side in (1.0, -1.0)}
    assert flips == {False, True}


@pytest.fixture(scope="module")
def solid64(card):
    tree = make_solid_tree(max_depth=6, basis_dim=16, seed=3)
    return dense_grid.bake_dense(tree.to_device(lut_depth=None, device=card),
                                 dtype="int8")


@pytest.mark.parametrize("crop", [(8, 48, 16, 32), (0, 64, 21, 20),
                                  (4, 56, 3, 9)])
def test_display_march_cropped_and_culled(solid64, crop):
    """A cropped payload (rows of 32 cells, staged with cp.async; 20 and 9
    cells, not a multiple of 16, staged by byte copies) and a culled slab
    list whose windows keep only some of their slabs."""
    case = _display_case(solid64, [(1.0, 0.25, 0.35), (1.0, 0.3, 0.2)],
                         crop=crop, cull=lambda i: i % 3 == 1)
    _display_vs_plain(solid64, case, seen=crop[2] > 8)


def test_display_march_batch_equals_single_poses(solid64):
    """A batch of poses against the same poses launched one at a time."""
    backs = [(1.0, 0.25, 0.35), (1.0, 0.1, 0.45), (1.0, 0.3, 0.2)]
    pay, params, zb, ids, perm, flip, _ = _display_case(solid64, backs)
    g = solid64

    def run(prm, z):
        return slab_march.march_slabs(
            pay, prm, g.qscale, z, g.G, GI, g.data_dim, g.basis_dim, perm,
            slab_ids=ids, sig2=True, flip=flip, bbox_full=True, dir_win=True)

    whole = run(params, zb)
    for i in range(len(backs)):
        one = run(params[i:i + 1], zb[i:i + 1])
        assert float((one[0] - whole[i]).abs().max()) <= 1e-6


@pytest.mark.parametrize("rows", [1, 2])
def test_display_march_tile_heights_match_plain(solid64, rows):
    """Both tile heights the launch rule picks from (32x8 and 32x16) compute
    the same function on the steep fx = 80 pose, and the card holds two
    blocks of each an SM."""
    g = solid64
    pay, params, zb, ids, perm, flip, _ = _display_case(
        g, [(1.0, 0.25, 0.35), (1.0, 0.1, 0.45)], fx=80.0)
    m = slab_march.march_inputs(pay, params, zb, g.G, GI, ids, 4)
    cfg = dict(slab_march.display_config(2, GI, len(m["wins"]),
                                         pay.shape[1], 132), rows=rows)
    acc = slab_march._display_launch(pay, g.qscale, m["params"], m["zb"],
                                     m["wins"], m["masks"], g.G, GI,
                                     g.basis_dim, m["K"], flip, 0, 0, cfg)
    ref = slab_march.march_slabs_ref(pay, g.qscale, D=g.data_dim,
                                     bd=g.basis_dim, flip=flip, **m)
    torch.cuda.synchronize()
    _agree(acc, ref)
    from volrend_torch import kernels
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib("slab_march_display").vt_march_display_info(
        g.basis_dim, rows, cfg["smem"], out), "slab_march_display")
    assert out[0] == 2 and out[1] > 0 and out[2] == 0, list(out)


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
    march config, the bake (f32) and its lean bf16 cast, params, z
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
    bake = grid.data.float().contiguous()
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    rng = np.random.default_rng(0)
    gacc4 = torch.as_tensor(rng.normal(size=(4, GI, GI)).astype(np.float32),
                            device=card)
    return cfg, {torch.float32: bake, torch.bfloat16: bake.to(
        torch.bfloat16)}, params, zb, gacc4


def _view(bake, perm):
    """The training march's payload: the bake seen through the group's
    permutation (channel stride 1)."""
    return bake.permute(perm[0], 3, perm[1], perm[2])


def _march_train(cfg, planar, params, zb, gi=GI):
    return slab_march.march_slabs(
        planar, params, torch.ones(cfg.D, device=planar.device), zb, cfg.G,
        gi, cfg.D, cfg.bd, cfg.perm, slab_ids=cfg.ids, flip=cfg.flip,
        bbox_full=True, dir_win=False)


def _march_plain(cfg, planar, params, zb, gi=GI):
    m = slab_march.march_inputs(planar, params, zb, cfg.G, gi, cfg.ids)
    return slab_march.march_slabs_ref(
        planar, torch.ones(cfg.D, device=planar.device), D=cfg.D, bd=cfg.bd,
        flip=cfg.flip, **m)


def _freeze_flip_ok(acc, ref):
    """TOL_TRAIN_M, except stop-threshold freeze flips: in saturated rays,
    on at most MAX_FREEZE_FLIPS of them (+1), by at most stop + TOL."""
    diff = (acc - ref).abs().amax(1)
    off = diff > TOL_TRAIN_M
    sat = torch.maximum(acc[:, 3], ref[:, 3]) < OPT.stop_thresh
    assert float(diff.max()) <= OPT.stop_thresh + TOL_TRAIN_M
    assert bool(torch.all(sat[off]))
    assert int(off.sum()) <= MAX_FREEZE_FLIPS * off.numel() + 1


def _bwd_agrees(gk, ref, out_dtype):
    gk = gk.float().cpu().double()
    ref = ref.float().cpu().double()
    rel = float((gk - ref).norm() / ref.norm())
    cos = float((gk * ref).sum() / (gk.norm() * ref.norm()))
    # bf16 output: the f32 cotangent rounded once (2^-9 relative)
    tol = TOL_BWD_REL if out_dtype == torch.float32 else 4e-3
    assert float(ref.abs().max()) > 0
    assert rel < tol and cos > MIN_BWD_COS, (rel, cos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_march_matches_plain(train_parts, dtype):
    """Kernel M's training mode on the bake's own f32 tensor and on the lean
    trainer's bf16 one, through the group's permutation, against its plain
    version on the same view."""
    cfg, bakes, params, zb, _ = train_parts
    planar = _view(bakes[dtype], cfg.perm)
    n0 = slab_march.march_slabs.launches
    acc = _march_train(cfg, planar, params, zb)
    assert slab_march.march_slabs.launches == n0 + 1
    ref = _march_plain(cfg, planar, params, zb)
    torch.cuda.synchronize()
    assert float(acc[:, 3].min()) < 0.5       # the scene was seen
    _freeze_flip_ok(acc, ref)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_march_bwd_matches_plain(train_parts, out_dtype):
    cfg, bakes, params, zb, gacc4 = train_parts
    planar = _view(bakes[out_dtype], cfg.perm)
    acc4 = _march_train(cfg, planar, params, zb)[0]
    qs = torch.ones(cfg.D, device=planar.device)
    n0 = slab_march.march_slabs_bwd.launches
    gk = slab_march.march_slabs_bwd(planar, params[0], qs, zb[0], gacc4,
                                    acc4, cfg.G, GI, cfg.D, cfg.bd,
                                    cfg.perm, flip=cfg.flip, bbox_full=True,
                                    out_dtype=out_dtype)
    assert slab_march.march_slabs_bwd.launches == n0 + 1
    assert gk.dtype == out_dtype and gk.stride() == planar.stride()
    ref = slab_march.march_slabs_bwd(planar.cpu(), params[0].cpu(), qs.cpu(),
                                     zb[0].cpu(), gacc4.cpu(), acc4.cpu(),
                                     cfg.G, GI, cfg.D, cfg.bd, cfg.perm,
                                     flip=cfg.flip, bbox_full=True)
    _bwd_agrees(gk, ref, out_dtype)


@pytest.fixture(scope="module")
def group_geom(card):
    """A G=32 solid scene's geometry on the card and one camera per
    (perm, flip) group (48^2 frames, gi=40)."""
    from _torch_perms import group_cams
    tree = make_solid_tree(max_depth=4, basis_dim=1, seed=3)
    grid = dense_grid.bake_dense(tree.to_device(lut_depth=None, device=card))
    return grid, group_cams(grid, 48, 48, 60.0)


def _two_cubes(G, D, dtype, device, seed):
    """A (G, G, G, D) bake with sigma above the threshold only in two cubes
    apart ([G/8, 3G/8) and [5G/8, 7G/8) on every axis), so every slab axis
    meets empty slabs before, between and after them; colours everywhere."""
    rng = np.random.default_rng(seed)
    bake = rng.normal(0.0, 0.6, size=(G, G, G, D)).astype(np.float32)
    sig = rng.uniform(-2.0, -0.5, size=(G, G, G)).astype(np.float32)
    for lo in (G // 8, 5 * G // 8):
        hi = lo + G // 4
        sig[lo:hi, lo:hi, lo:hi] = rng.uniform(
            5.0, 80.0, size=(hi - lo,) * 3)
    bake[..., D - 1] = sig
    return torch.as_tensor(bake, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bd", [1, 4, 9, 16])
def test_train_kernels_every_group_and_record(group_geom, bd, dtype):
    """Both training kernels against their plain versions in every (perm,
    flip) group, on f32 and bf16 bakes whose records (D = 4, 13, 28, 49:
    16, 52, 112, 196 B in f32, half in bf16) take 16-byte copies where they
    are 16-byte aligned and 4-byte words elsewhere, on a scene with empty
    slabs between occupied ones: the launch counts show slabs skipped as
    empty and slabs shaded; the coarse occupancy equals its plain version
    bit for bit."""
    from volrend_torch.ops import slab_grad
    grid, cams = group_geom
    assert len(cams) == 12
    G, D, gi = grid.G, 3 * bd + 1, 40
    bake = _two_cubes(G, D, dtype, grid.data.device, seed=bd)
    opt = OPT.replace(renormalize=False)
    rng = np.random.default_rng(bd)
    for (perm, flip), cam in sorted(cams.items()):
        geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy,
                                     perm, flip, 48, 48, opt, gi)
        ids = tuple(range(G - 1, -1, -1) if flip else range(G))
        cfg = slab_grad.SlabCfg(G=G, gi=gi, D=D, bd=bd, fmt=int(grid.fmt),
                                perm=perm, flip=flip, ids=ids, opt=opt)
        params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
        zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
        planar = _view(bake, perm)
        m = slab_march.march_inputs(planar, params, zb, G, gi, ids)
        qs = torch.ones(D, device=planar.device)
        occ = slab_march.march_occupancy(planar, m["params"], qs)
        assert torch.equal(occ, slab_march.march_occupancy_ref(
            planar, m["params"], qs))
        counts = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64,
                             device=planar.device)
        acc = slab_march._march_train_cuda(planar, qs, D=D, bd=bd, flip=flip,
                                           counts=counts, **m)
        ref = slab_march.march_slabs_ref(planar, qs, D=D, bd=bd, flip=flip,
                                         **m)
        torch.cuda.synchronize()
        assert float(acc[:, 3].min()) < 0.5, (perm, flip)
        _freeze_flip_ok(acc, ref)
        entered, shaded = int(counts[0]), int(counts[1])
        assert 0 < shaded < entered, (perm, flip, counts.tolist())
        gacc4 = torch.as_tensor(rng.normal(size=(4, gi, gi)).astype(
            np.float32), device=planar.device)
        gk = slab_march.march_slabs_bwd(planar, params[0], qs, zb[0], gacc4,
                                        acc[0], G, gi, D, bd, perm,
                                        flip=flip, bbox_full=True,
                                        out_dtype=dtype)
        assert gk.stride() == planar.stride()
        prm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
            params[0], zb[0], gacc4, acc[0], G, gi)
        gp = slab_march.march_slabs_bwd_ref(planar, qs, prm, bzb, bgacc, aux,
                                            G, gi, D, bd, flip)
        _bwd_agrees(gk, gp, dtype)


def test_train_kernels_past_512_columns(card):
    """Both training kernels at G = 600 (a dense fog, f32, SH1) against
    their plain versions: past 512 columns the coarse occupancy takes two
    64-bit masks a row, and a wide view's tile footprints cover most of a
    slab (up to 25 x 25 pieces with a voxel above the threshold, more on
    average than one round of the job list holds, LIST_CAP = 512), so
    slabs are split across rounds. The coarse occupancy equals its plain
    version bit for bit."""
    from _torch_perms import group_cams
    from volrend_torch.ops import slab_grad
    G, D, bd, gi, side = 600, 4, 1, 8, 32
    tree = make_solid_tree(max_depth=2, basis_dim=1, seed=3)
    grid = dataclasses.replace(dense_grid.bake_dense(
        tree.to_device(lut_depth=None, device=card)), G=G, occ_max=None)
    (perm, flip), cam = sorted(group_cams(grid, side, side, 12.0).items())[0]
    opt = OPT.replace(renormalize=False)
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, side, side, opt, gi)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=gi, D=D, bd=bd, fmt=int(grid.fmt),
                            perm=perm, flip=flip, ids=ids, opt=opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    gen = torch.Generator(device=card).manual_seed(0)
    bake = torch.empty((G, G, G, D), device=card)
    bake[..., :D - 1].normal_(0.0, 0.6, generator=gen)
    bake[..., D - 1].uniform_(0.5, 1.5, generator=gen)
    planar = _view(bake, perm)
    m = slab_march.march_inputs(planar, params, zb, G, gi, ids)
    qs = torch.ones(D, device=card)
    occ = slab_march.march_occupancy(planar, m["params"], qs)
    assert occ.shape == (G, G // 8, 2)
    assert torch.equal(occ, slab_march.march_occupancy_ref(
        planar, m["params"], qs))
    counts = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64,
                         device=card)
    acc = slab_march._march_train_cuda(planar, qs, D=D, bd=bd, flip=flip,
                                       counts=counts, occ=occ, **m)
    ref = slab_march.march_slabs_ref(planar, qs, D=D, bd=bd, flip=flip, **m)
    torch.cuda.synchronize()
    assert float(acc[:, 3].min()) < 0.5
    _freeze_flip_ok(acc, ref)
    met, _, pieces, staged, _ = counts.tolist()
    assert pieces > 512 * met and staged == pieces, counts.tolist()
    gacc4 = torch.randn((4, gi, gi), device=card, generator=gen)
    gk = slab_march.march_slabs_bwd(planar, params[0], qs, zb[0], gacc4,
                                    acc[0], G, gi, D, bd, perm, flip=flip,
                                    bbox_full=True, occupancy=occ)
    assert gk.stride() == planar.stride()
    prm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
        params[0], zb[0], gacc4, acc[0], G, gi)
    gp = slab_march.march_slabs_bwd_ref(planar, qs, prm, bzb, bgacc, aux, G,
                                        gi, D, bd, flip)
    _bwd_agrees(gk, gp, torch.float32)


@pytest.mark.parametrize("lean", [False, True])
def test_march_gradient_on_card_has_the_bake_layout(train_parts, lean):
    """Through _MarchKernel on the card, the gradient that reaches the bake
    (through the permutation back and, for the lean trainer, the cast) is
    contiguous, and the kernel's cotangent has the view's strides."""
    from volrend_torch.ops import slab_grad
    cfg, bakes, params, zb, _ = train_parts
    leaf = bakes[torch.float32].clone().requires_grad_(True)
    bake = leaf * 1.0
    seen, grad_view = [], []
    bake.register_hook(seen.append)
    pdt = torch.bfloat16 if lean else torch.float32
    planar = _view(bake.to(pdt), cfg.perm)
    planar.register_hook(grad_view.append)
    acc, T = slab_grad._MarchKernel.apply(planar, params[0], zb[0], cfg)
    (torch.sum(acc) + torch.sum(T)).backward()
    (gb,), (gv,) = seen, grad_view
    assert gb.is_contiguous() and gb.dtype == torch.float32
    assert gv.dtype == pdt and gv.stride() == planar.stride()
    assert float(gb.abs().max()) > 0


def test_frame_train_card_matches_cpu(card):
    """loss_and_grad_frame through the kernels on the card (the bake
    kernel with its live bits, the coarse occupancy's bits mode, both
    march kernels) equals the CPU run (their plain versions) on a G=16
    scene: the loss to rtol 1e-5, the gradient to relative L2 1e-3."""
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
        k0 = slab_grad.bake_from_pyramid.launches
        l0 = slab_march.march_occupancy.launches_live
        loss, g = slab_grad.loss_and_grad_frame(
            pyr, bmap, grid, cam.transform, 60.0, 60.0, perm, flip, 48, 48,
            tgt, OPT, gi=48)
        if dev != "cpu":  # the bake kernel and the bits mode on the card
            assert slab_march.march_slabs_bwd.launches == n0 + 1
            assert slab_grad.bake_from_pyramid.launches == k0 + 1
            assert slab_march.march_occupancy.launches_live == l0 + 1
        out.append((float(loss), torch.cat([x.reshape(-1).cpu()
                                            for x in g]).double()))
    (l_c, g_c), (l_g, g_g) = out
    assert np.isclose(l_c, l_g, rtol=1e-5)
    assert float((g_c - g_g).norm() / g_c.norm()) < 1e-3


_COPY_OPS = ("aten::copy_", "aten::_to_copy", "aten::to", "aten::clone",
             "aten::contiguous")


def test_frame_trainer_on_card_uses_the_kernels(card):
    """Every step_frame runs one launch of each kernel (default and lean
    trainers; one coarse occupancy serves both march kernels) and descends;
    no step copies the bake into a planar (G, D, G, G) tensor (no copy op
    in the profiler's record takes one: the kernels read the bake's own
    tensor)."""
    from torch.profiler import ProfilerActivity, profile
    from volrend_torch.ops import slab_grad
    from volrend_torch.train import FrameTrainer
    tree = make_solid_tree(max_depth=4, basis_dim=9, seed=7)
    tdev = tree.to_device(lut_depth=None, device=card)
    cams = _cams([(np.cos(0.25), np.sin(0.25), 0.45)], fx=200.0)
    for lean in (False, True):
        tr = FrameTrainer(tdev, opt=OPT, lr=5e-2, gi=64, lean=lean)
        G, D = tr.grid.G, tr.grid.data_dim
        tgt = torch.full((H, W, 4), 0.5, device=card)
        m0 = slab_march.march_slabs.launches
        b0 = slab_march.march_slabs_bwd.launches
        o0 = slab_march.march_occupancy.launches
        l0 = slab_march.march_occupancy.launches_live
        k0 = slab_grad.bake_from_pyramid.launches
        losses = [tr.step_frame(cams[0], tgt) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            losses.append(tr.step_frame(cams[0], tgt))
        assert slab_march.march_slabs.launches == m0 + 3
        assert slab_march.march_slabs_bwd.launches == b0 + 3
        # one bake kernel a step, whose live bits give the one coarse
        # occupancy both march kernels share (the bits mode)
        assert slab_grad.bake_from_pyramid.launches == k0 + 3
        assert slab_march.march_occupancy.launches_live == l0 + 3
        assert slab_march.march_occupancy.launches == o0
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert tr.pyramid[-1].device.type == "cuda"
        planar = [G, D, G, G]
        copies = [e.name for e in prof.events()
                  if e.name in _COPY_OPS and planar in (e.input_shapes or [])]
        assert not copies, (lean, copies)


# ---------------------------------------------------------------------------
# The pyramid bake kernel (csrc/bake_pyramid.cu) and the coarse occupancy's
# bits mode (vt_march_occupancy_live)
# ---------------------------------------------------------------------------

THRESH = 0.01  # the trainer's sigma threshold (RenderOptions' default)


def _near_thresh_pyramid(bmap, K, device, seed):
    """A seeded pyramid of (K, D) leaf rows whose sigma lies around THRESH
    (some values cross it only after bf16 rounding) or below zero."""
    from volrend_torch.ops import slab_grad
    rng = np.random.default_rng(seed)
    rows = rng.normal(0.0, 0.6, size=(K, bmap.D)).astype(np.float32)
    sig = rng.uniform(0.0098, 0.0102, size=K).astype(np.float32)
    sig[rng.random(K) < 0.3] = -1.0
    rows[:, -1] = sig
    return slab_grad.data_to_pyramid(torch.tensor(rows, device=device), bmap)


def _bake_case(tdev, seed, grad=False):
    """The bake kernel against its plain versions on one tree's pyramid:
    the bake bit for bit, with and without its live bits, and the bits
    equal to live_bits_ref; with ``grad``, the gradient equal to autograd
    through the plain version."""
    from volrend_torch.ops import slab_grad
    bmap = slab_grad.build_bake_map(tdev)
    pyr = _near_thresh_pyramid(bmap, int(tdev.data.shape[0]),
                               tdev.data.device, seed)
    if grad:
        pyr = [p.requires_grad_(True) for p in pyr]
    n0 = slab_grad.bake_from_pyramid.launches
    bake, live = slab_grad.bake_from_pyramid(pyr, bmap, live_thresh=THRESH)
    alone = slab_grad.bake_from_pyramid(pyr, bmap)
    plain = slab_grad.bake_from_pyramid_ref(pyr, bmap)
    assert slab_grad.bake_from_pyramid.launches == n0 + 2
    assert torch.equal(bake, plain) and torch.equal(alone, plain)
    ref = slab_grad.live_bits_ref(plain, THRESH)
    assert torch.equal(live.bits, ref.bits) and live.thresh == ref.thresh
    on = plain[..., -1].to(torch.bfloat16).float() > THRESH
    assert 0 < int(on.sum()) < on.numel()
    if grad:
        gen = torch.Generator(device=bake.device).manual_seed(0)
        R = torch.randn(bake.shape, device=bake.device, generator=gen)
        gk = torch.autograd.grad(torch.sum(bake * R), pyr)
        gp = torch.autograd.grad(torch.sum(plain * R), pyr)
        for a, b in zip(gk, gp):
            assert torch.equal(a, b)
    return bmap


@pytest.mark.parametrize("bd", [1, 4, 9, 16, 25])
def test_bake_kernel_bit_equal(card, bd):
    """The bake kernel equals its plain version bit for bit for D = 4, 13,
    28, 49, 76 (records of 16, 52, 112, 196, 304 bytes: 16-byte units and
    4-byte words), its live bits equal live_bits_ref (sigma around the
    threshold), and its gradient equals autograd through the plain version
    (G = 32)."""
    from volrend_torch.ops import slab_grad
    tree = make_test_tree(max_depth=4, basis_dim=bd, seed=bd,
                          sigma_scale=60.0)
    bmap = _bake_case(tree.to_device(lut_depth=None, device=card), bd,
                      grad=True)
    assert bmap.G == 32 and len(slab_grad.level_map(bmap).unique()) > 1


def test_bake_kernel_n3(card):
    """At N = 3 (G = 27, a partial bit word a row, SH9) the bake kernel and
    its live bits equal their plain versions."""
    from _torch_trees import tree_n
    tree = tree_n(3, 2, 28, seed=3)
    bmap = _bake_case(tree.to_device(lut_depth=None, device=card), 3,
                      grad=True)
    assert bmap.G == 27 and bmap.N == 3


@pytest.mark.parametrize("G", [256, 600])
def test_occupancy_bits_mode_every_perm(card, G):
    """The coarse occupancy's bits mode equals march_occupancy_ref for all
    six view permutations at G = 256 and at G = 600 (two mask words a row,
    partial bit words and row blocks); the bits are taken from a random
    sigma view by live_bits_ref, as the 600 case has no bake map."""
    from volrend_torch.ops import slab_grad
    gen = torch.Generator(device=card).manual_seed(G)
    bake = torch.empty((G, G, G, 4), device=card)
    bake[..., :3].normal_(0.0, 0.6, generator=gen)
    u = torch.rand((G, G, G), device=card, generator=gen)
    bake[..., 3] = torch.where(u < 2e-3, 0.02, -1.0)
    c = G // 3
    bake[c:c + 40, c + 7:c + 50, c + 3:c + 30, 3] = 0.0101
    live = slab_grad.live_bits_ref(bake, THRESH)
    prm = torch.full((1, 15), THRESH)
    qs = torch.ones(4, device=card)
    for perm in itertools.permutations(range(3)):
        view = bake.permute(perm[0], 3, perm[1], perm[2])
        n0 = slab_march.march_occupancy.launches_live
        occ = slab_march.march_occupancy(view, prm, qs, live=live, perm=perm)
        assert slab_march.march_occupancy.launches_live == n0 + 1
        want = slab_march.march_occupancy_ref(view, prm.to(card), qs)
        assert occ.shape == want.shape == (G, -(-G // 8), -(-G // 512))
        assert torch.equal(occ, want), perm
        assert 0 < int(want.count_nonzero()) < want.numel()


# ---------------------------------------------------------------------------
# The precise superquad training warp: kernels B and C in their f32 table
# mode, the combine adjoint (kernel 5) and the build adjoint (kernel 6)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def precise_parts(card):
    """One pose's warp geometry at 160^2, gi=64 on the card (the solid
    scene's metadata), a seeded (1, gi, gi, 4) intermediate image and a
    (1, H, W, 4) cotangent."""
    tree = make_solid_tree(max_depth=4, basis_dim=9, seed=7)
    grid = dense_grid.bake_dense(tree.to_device(lut_depth=None, device=card))
    cam = _cams([(1.0, 0.25, 0.35)])[0]
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, W, H)
    g = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                              flip, W, H, OPT, GI)
    geom = (g.R, g.fx, g.fy, W, H, GI, perm, g.u0, g.du, g.v0, g.dv,
            g.scale)
    rng = np.random.default_rng(11)
    inter = torch.as_tensor(rng.uniform(0, 1, (1, GI, GI, 4)).astype(
        np.float32), device=card)
    ct = torch.as_tensor(rng.normal(size=(1, H, W, 4)).astype(np.float32),
                         device=card)
    return geom, inter, ct


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def _precise_level(geom, inter, B, win):
    """Kernel C's f32-mode arguments at one level: the f32 table of
    ``inter`` and the level's geometry."""
    tbl = display_warp.build_table(inter, win, dtype=torch.float32,
                                   planar=False)
    gys, gxs, okm, Y0, X0 = display_warp._level_geometry(geom, GI, B, win)
    return (tbl, Y0.contiguous(), X0.contiguous(),
            (gys - Y0.float()[:, None]).contiguous(),
            (gxs - X0.float()[:, None]).contiguous(), okm.contiguous(), GI,
            H, W, B, win, 0.7)


def test_precise_kernels_match_plain(precise_parts):
    """B and C in their f32 mode, kernels 5 and 6 against their plain
    versions on the same CUDA tensors: B bit-equal, C within 1e-5, the
    adjoints to relative L2 1e-6 (f32, another summation order; kernel 5
    adds the blocks that share a table row with atomics, in a
    run-dependent order)."""
    geom, inter, ct = precise_parts
    bg = 0.7
    counts = (display_warp.build_table.launches_f32,
              display_warp.combine_emit.launches_f32,
              display_warp.combine_adjoint.launches,
              display_warp.build_adjoint.launches)
    args = _precise_level(geom, inter, (2, 2), (4, 4))
    tbl = args[0]
    assert torch.equal(tbl, display_warp.build_table_ref(
        inter, (4, 4), dtype=torch.float32, planar=False))
    got = display_warp.combine_emit(*args, qscale=1.0, qshift=0.0)
    want = display_warp.combine_emit_ref(*args, qscale=1.0, qshift=0.0)
    assert float((got - want).abs().max()) <= 1e-5
    Y0, X0, ry, rx, okm = args[1:6]
    dtbl5 = display_warp.combine_adjoint(ct, ry, rx, okm, Y0, X0, GI, bg)
    assert _rel(dtbl5, display_warp.combine_adjoint_ref(
        ct, ry, rx, okm, Y0, X0, GI, bg)) <= 1e-6
    # kernel 6 on a dense table (every row non-zero), then on kernel 5's
    dtbl = torch.randn(tbl.shape, device=tbl.device)
    d = display_warp.build_adjoint(dtbl, GI)
    assert _rel(d, display_warp.build_adjoint_ref(dtbl, GI)) <= 1e-6
    d = display_warp.build_adjoint(dtbl5, GI)
    assert _rel(d, display_warp.build_adjoint_ref(dtbl5, GI)) <= 1e-6
    assert (display_warp.build_table.launches_f32,
            display_warp.combine_emit.launches_f32,
            display_warp.combine_adjoint.launches,
            display_warp.build_adjoint.launches) == tuple(
                c + n for c, n in zip(counts, (1, 1, 1, 2)))


@pytest.mark.parametrize("case", ["shared", "two_poses", "masked"])
def test_combine_adjoint_cases_match_plain(precise_parts, case):
    """Kernel 5 against its plain version (the block rows, then
    index_add_) to relative L2 1e-6 (atomic summation order): many
    blocks on each of a few table rows; two poses, each adding into its
    own table; every subpixel masked, which leaves the table zero."""
    geom, inter, ct = precise_parts
    _, Y0, X0, ry, rx, okm = _precise_level(geom, inter, (2, 2),
                                            (4, 4))[:6]
    if case == "shared":
        hh = torch.arange(Y0.shape[1], device=Y0.device)[:, None]
        wh = torch.arange(Y0.shape[2], device=Y0.device)[None]
        Y0 = (hh // 8 * 3).expand_as(Y0[0])[None].int().contiguous()
        X0 = (wh // 8 * 5).expand_as(X0[0])[None].int().contiguous()
    elif case == "two_poses":
        W3 = GI - 3
        Y0, X0 = (torch.cat([Y0, X0.flip(2)]).contiguous(),
                  torch.cat([X0, W3 - 1 - Y0]).contiguous())
        ry, rx, okm = (torch.cat([t, t.flip(3)]).contiguous()
                       for t in (ry, rx, okm))
        ct = torch.cat([ct, ct.flip(1)]).contiguous()
    else:
        okm = torch.zeros_like(okm)
    dtbl = display_warp.combine_adjoint(ct, ry, rx, okm, Y0, X0, GI, 0.7)
    want = display_warp.combine_adjoint_ref(ct, ry, rx, okm, Y0, X0, GI,
                                            0.7)
    if case == "masked":
        assert not bool(dtbl.any()) and not bool(want.any())
    else:
        assert _rel(dtbl, want) <= 1e-6


@pytest.mark.parametrize("level", [((2, 2), (4, 4)), ((4, 4), (5, 5)),
                                   ((2, 2), (3, 3))])
def test_combine_f32_levels(precise_parts, level):
    """Kernel C's f32 mode against its plain version within 1e-5 at the
    precise level (its constant-size kernel) and at two others (the
    generic one); at the precise level the constant-size kernel equals
    the generic kernel bit for bit."""
    geom, inter, _ = precise_parts
    args = _precise_level(geom, inter, *level)
    got = display_warp.combine_emit(*args, qscale=1.0, qshift=0.0)
    want = display_warp.combine_emit_ref(*args, qscale=1.0, qshift=0.0)
    assert float((got - want).abs().max()) <= 1e-5
    if level == ((2, 2), (4, 4)):
        display_warp._COMBINE_GENERIC = True
        try:
            generic = display_warp.combine_emit(*args, qscale=1.0,
                                                qshift=0.0)
        finally:
            display_warp._COMBINE_GENERIC = False
        assert torch.equal(got, generic)


def test_precise_warp_matches_reference_warp(precise_parts):
    """The whole precise warp on the card (output and gradient) against
    autograd through the reference warp with an f32 table, at the
    reference test's tolerances."""
    geom, inter, ct = precise_parts
    outs = []
    for fn in (lambda x: display_warp.warp_precise(x, 1.0, *geom),
               lambda x: slab_render._warp_to_screen_ref(
                   x, OPT, *geom, precise=True)):
        x = inter.clone().requires_grad_(True)
        out = fn(x)
        (g,) = torch.autograd.grad(out, x, ct)
        outs.append((out.detach(), g))
    (out, g), (ref, gref) = outs
    assert float((out - ref).abs().max()) <= 5e-5
    tol = 5e-5 * float(gref.abs().max()) + 5e-4 * gref.abs()
    assert bool(torch.all((g - gref).abs() <= tol))


def test_frame_trainer_precise_switch_uses_its_kernels(card, monkeypatch):
    """With _PRECISE_SQ on, every step_frame runs one launch of each of
    M, M-bwd, B-f32, C-f32 and kernels 5 and 6, and no pose takes the
    reference warp."""
    from volrend_torch.train import FrameTrainer
    monkeypatch.setattr(display_warp, "_PRECISE_SQ", True)
    tree = make_solid_tree(max_depth=4, basis_dim=9, seed=7)
    tdev = tree.to_device(lut_depth=None, device=card)
    cams = _cams([(np.cos(0.25), np.sin(0.25), 0.45)], fx=200.0)
    tr = FrameTrainer(tdev, opt=OPT, lr=5e-2, gi=64)
    tgt = torch.full((H, W, 4), 0.5, device=card)

    def counts():
        return (slab_march.march_slabs.launches,
                slab_march.march_slabs_bwd.launches,
                display_warp.build_table.launches_f32,
                display_warp.combine_emit.launches_f32,
                display_warp.combine_adjoint.launches,
                display_warp.build_adjoint.launches,
                slab_render._warp_to_screen_ref.precise_poses)

    c0 = counts()
    losses = [tr.step_frame(cams[0], tgt) for _ in range(3)]
    assert counts() == tuple(c + 3 for c in c0[:6]) + (c0[6],)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# The measurement probes' kernels (volrend_torch/probes/)
# ---------------------------------------------------------------------------

def test_probe_combine_matches_plain(card):
    """P7 against its plain version: f32 both, another summation order
    (1e-5); positions past the window and masked subpixels."""
    from volrend_torch.probes import perf_sq3
    rng = np.random.default_rng(5)
    Hh, Wh = 40, 56
    qgp = torch.as_tensor(rng.uniform(0.0, 1.0, (64, Hh, Wh)).astype(
        np.float32)).to(torch.bfloat16).to(card)
    ry, rx = (torch.as_tensor(rng.uniform(-0.7, 3.7, (4, Hh, Wh)).astype(
        np.float32), device=card) for _ in range(2))
    okm = torch.as_tensor((rng.uniform(size=(4, Hh, Wh)) > 0.25).astype(
        np.float32), device=card)
    n0 = perf_sq3.combine_probe.launches
    got = perf_sq3.combine_probe(qgp, ry, rx, okm, 0.7)
    assert perf_sq3.combine_probe.launches == n0 + 1
    want = perf_sq3.combine_probe_ref(qgp, ry, rx, okm, 0.7)
    assert float((got - want).abs().max()) <= 1e-5


def test_probe_stream_matches_plain(card):
    """P8 against its plain version, exactly: every window, then a permuted
    subset."""
    from volrend_torch.probes import perf_overlap
    rng = np.random.default_rng(6)
    G, Dp = 128, 3
    pay = torch.as_tensor(rng.integers(-128, 128, (G, Dp, G, G),
                                       dtype=np.int8), device=card)
    for ids in (np.arange(G // 4), rng.permutation(G // 4)[:12]):
        ids = torch.as_tensor(ids.astype(np.int32), device=card)
        n0 = perf_overlap.stream_probe.launches
        out, sums = perf_overlap.stream_probe(pay, ids)
        assert perf_overlap.stream_probe.launches == n0 + 1
        want_out, want_sums = perf_overlap.stream_probe_ref(pay, ids)
        assert torch.equal(out, want_out) and torch.equal(sums, want_sums)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("gi", [35, 40])
def test_probe_build_matches_plain(card, gi, planar):
    """P9 in both layouts, bit-equal to its plain version, padding rows
    (gi = 40: 37 rows padded to 48) included."""
    from volrend_torch.probes import perf_sq4
    it = torch.as_tensor(np.random.default_rng(7).uniform(
        0.0, 1.0, (4, gi, gi)).astype(np.float32)).to(torch.bfloat16).to(
            card)
    counter = "launches_planar" if planar else "launches"
    n0 = getattr(perf_sq4.build_probe, counter)
    got = perf_sq4.build_probe(it, gi, planar=planar)
    assert getattr(perf_sq4.build_probe, counter) == n0 + 1
    assert torch.equal(got, perf_sq4.build_probe_ref(it, gi, planar=planar))
