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
from volrend_torch.probes._common import mean_fits, rows_table_warp, \
    table_warp_level
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
    """(cpu grid, cuda grid) of one scene (G=32 dense fog / G=64 solid;
    "ndc", which a test asks for by indirect parametrization: ndc_grids)."""
    if request.param == "ndc":
        return request.getfixturevalue("ndc_grids")
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


def _warp_case(g, fx=200.0, gi=GI, backs=((1.0, 0.25, 0.35),
                                           (1.0, 0.1, 0.45),
                                           (1.0, 0.3, 0.2))):
    """(geometry args, (P, 16) parameter rows, seeded (P, 4, gi, gi)
    planes with values outside [0, 1] too) for poses on grid ``g``: on a
    world grid display_params' rows of the poses looking back along
    ``backs``, on an NDC grid display_params_ndc's of three poses near
    bench.py's NDC pose (the args then with the sidecar and the poses'
    origins)."""
    if g.ndc is None:
        cams = _cams(backs, fx)
    else:
        cams = _ndc_cams(fx) + [Camera.from_vectors(
            center=(-0.04, 0.03, 0.14), v_back=(0.07, -0.02, 1.0),
            v_world_up=(0.0, 1.0, 0.0), width=W, height=H, fx=fx)]
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform, fx, fx,
                                            W, H)
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 fx, fx, perm, flip, W, H, OPT, gi)
    args = (geom.R, geom.fx, geom.fy, W, H, gi, perm, geom.u0, geom.du,
            geom.v0, geom.dv, geom.scale)
    if g.ndc is None:
        prm = display_warp.display_params(*args[:3], *args[7:12], perm)
    else:
        assert perm[0] == 2
        args += (g.ndc, geom.origin_w)
        prm = display_warp.display_params_ndc(*args[:3], *args[7:12], perm,
                                              g.ndc, geom.origin_w)
    inter = torch.as_tensor(np.random.default_rng(3).uniform(
        -0.1, 1.1, (len(cams), 4, gi, gi)).astype(np.float32),
        device=g.data.device)
    return args, prm, inter


#: the production levels (their own instantiations) and levels of the
#: generic kernel: a non-square block and window, 8 x 8 blocks, and blocks
#: wider than 8 with the largest window
W_LEVELS = LEVELS + (((2, 4), (4, 5)), ((8, 8), (4, 4)),
                     ((16, 10), (8, 8)))


@pytest.mark.parametrize("grids", ["dense", "solid", "ndc"], indirect=True)
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("level", W_LEVELS)
def test_warp_display_matches_plain_and_parent(grids, out_dtype, level):
    """W on two of three poses, in place: the parent's composition (the
    same arithmetic, so equal; on NDC rows kernels B and C on the rows'
    own geometry, as the parent's world2ndc geometry is another), the
    plain version (einsum sums the window in another order: uint8 within
    one quantum, f32 within 1e-5), and the third pose's slot untouched."""
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
    od = torch.uint8 if out_dtype == torch.uint8 else None
    if g.ndc is None:
        parent = table_warp_level(args, inter, sel.long(), B, win, 1.0, od)
    else:
        parent, _ = rows_table_warp(prm, inter, sel, B, win, GI, H, W, 1.0,
                                    od)
    assert torch.equal(got[sel.long()], parent)


@pytest.mark.parametrize("grids,fx,levels,gi", [
    *((scene, fx, levels, GI) for scene in ("dense", "solid")
      for fx, levels in (
          (200.0, LEVELS), (80.0, LEVELS), (45.0, LEVELS),
          (80.0, (((1, 2), (4, 4)), ((2, 4), (4, 5)), ((4, 4), (5, 5)))),
          (80.0, (((2, 2), (4, 4)), ((5, 5), (6, 6)))))),
    ("ndc", 200.0, LEVELS, GI), ("ndc", 200.0, LEVELS, 160),
    ("ndc", 80.0, LEVELS, 160)], indirect=["grids"])
def test_fit_counts_bit_equal(grids, fx, levels, gi):
    """W's fit mode against its plain version on the card and on the CPU
    (bit-equal counts), and its decisions against the parent's
    predicates (torch.mean of the misfits on the card), for poses that
    fit, a steep and a wide one; on two other level sets, three levels
    that nest in a 4 x 4 super block (positions shared, as for the
    production pair) and two that do not (each level its own positions);
    and on NDC rows at the tests' grid (every level fits) and at a finer
    one with two focal lengths (the (4, 4) level misfits)."""
    _, g = grids
    args, prm, _ = _warp_case(g, fx, gi)
    n0 = display_warp.level_fit_counts.launches
    counts = display_warp.level_fit_counts(prm, levels, gi, H, W)
    assert display_warp.level_fit_counts.launches == n0 + 1
    assert torch.equal(counts, display_warp.level_fit_counts_ref(
        prm, levels, gi, H, W))
    assert torch.equal(counts.cpu(), display_warp.level_fit_counts_ref(
        prm.cpu(), levels, gi, H, W))
    fits = display_warp._fits_from_counts(counts, levels, H, W)
    want = mean_fits(args, levels)
    assert torch.equal(fits, want), counts
    gyf, gxf = display_warp._pixel_slopes(*args)
    for li, (B, win) in enumerate(levels):
        assert torch.equal(display_warp._level_fits(gyf, gxf, gi, B, win),
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


def _agree(acc, ref, tol=TOL_M):
    diff = (acc - ref).abs().amax(1)
    off = diff > tol
    sat = torch.maximum(acc[:, 3], ref[:, 3]) < OPT.stop_thresh
    assert bool(torch.all(sat[off])), float(diff.max())
    assert int(off.sum()) <= MAX_FREEZE_FLIPS * off.numel() + 1
    assert float(diff.max()) <= OPT.stop_thresh + tol


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


# ---------------------------------------------------------------------------
# The last two display pose classes: NDC trees (kernel M on the NDC
# geometry, then kernel W and its fit mode on display_params_ndc's rows;
# kernels B and C held on the same geometry) and split-frame class passes
# (kernel M over the unit slope box, then kernel W)
# ---------------------------------------------------------------------------

NDC_CFG = (float(W), float(H), 200.0)


def _ndc_tree():
    """An NDC tree: G=32 fog, the bench's NDC scene at depth 4."""
    from volrend_torch.models.n3tree import NdcConfig
    tree = make_test_tree(max_depth=4, basis_dim=16, seed=4, n_blobs=6,
                          sigma_scale=60.0)
    tree.use_ndc = True
    tree.ndc = NdcConfig(*NDC_CFG)
    return tree


@pytest.fixture(scope="module")
def ndc_grids(card):
    """(cpu grid, cuda grid) of the NDC tree, baked int8."""
    tree = _ndc_tree()
    return tuple(dense_grid.bake_dense(
        tree.to_device(lut_depth=None, device=d), dtype="int8")
        for d in ("cpu", card))


def _ndc_cams(fx=200.0):
    return [Camera.from_vectors(center=c, v_back=b,
                                v_world_up=(0.0, 1.0, 0.0), width=W,
                                height=H, fx=fx)
            for c, b in (((0.0, 0.0, 0.2), (0.05, 0.02, 1.0)),
                         ((0.05, -0.02, 0.3), (-0.04, 0.03, 1.0)))]


def test_ndc_kernels_match_plain(ndc_grids):
    """Kernel M on two NDC poses (the NDC dirM), then kernel B's int8
    table and kernel C's generic combine on the NDC geometry, against
    their plain versions on the same CUDA tensors."""
    _, g = ndc_grids
    cams = _ndc_cams()
    perm, flip, slope = slab_render.choose_axis(g, cams[0].transform, 200.0,
                                                200.0, W, H)
    assert perm[0] == 2 and np.isfinite(slope)
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 200.0, 200.0, perm, flip, W, H, OPT, GI)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, OPT)
    pay = slab_render._permuted_grid(g, perm)
    ids = g.slab_ids(perm[0], flip, OPT.sigma_thresh)
    acc = _display_vs_plain(g, (pay, params, zb, ids, perm, flip, None))
    inter = slab_render._finalize_planar(acc, OPT).contiguous()
    args = (geom.R, geom.fx, geom.fy, W, H, GI, perm, geom.u0, geom.du,
            geom.v0, geom.dv, geom.scale, g.ndc, geom.origin_w)
    for B, win in LEVELS:
        tbl = display_warp.build_table(inter, win)
        assert torch.equal(tbl, display_warp.build_table_ref(inter, win))
        gys, gxs, okm, Y0, X0 = display_warp._level_geometry(args, GI, B,
                                                             win)
        cargs = (tbl, Y0.contiguous(), X0.contiguous(),
                 (gys - Y0.float()[:, None]).contiguous(),
                 (gxs - X0.float()[:, None]).contiguous(), okm.contiguous(),
                 GI, H, W, B, win, 1.0)
        for od, tol in ((torch.uint8, 1.0), (None, 1e-5)):
            got = display_warp.combine_emit(*cargs, out_dtype=od)
            want = display_warp.combine_emit_ref(*cargs, out_dtype=od)
            assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("out_dtype", [torch.uint8, None])
def test_ndc_render_frames_card_matches_cpu(ndc_grids, out_dtype):
    """NDC frames on the card (M, the fit mode and W on the NDC rows, no
    kernels B or C and no reference warp) equal the CPU run: uint8 within
    one quantum, f32 within one code of the int8 table (1/255): the
    march's float rounding, card against CPU, can move an intermediate
    value across a rounding boundary of its table code."""
    cpu, gpu = ndc_grids
    cams = _ndc_cams()
    perm, flip, _ = slab_render.choose_axis(cpu, cams[0].transform, 200.0,
                                            200.0, W, H)
    trs = np.stack([c.transform for c in cams])
    a = slab_render.render_frames(cpu, trs, 200.0, 200.0, perm, flip, W, H,
                                  OPT, gi=GI, out_dtype=out_dtype)
    n = (display_warp.build_table.launches, display_warp.combine_emit.poses,
         display_warp.warp_display.poses,
         display_warp.level_fit_counts.launches,
         slab_render._warp_to_screen_ref.poses)
    b = slab_render.render_frames(gpu, trs, 200.0, 200.0, perm, flip, W, H,
                                  OPT, gi=GI, out_dtype=out_dtype).cpu()
    assert display_warp.build_table.launches == n[0]
    assert display_warp.combine_emit.poses == n[1]
    assert display_warp.warp_display.poses == n[2] + 2
    assert display_warp.level_fit_counts.launches == n[3] + 1
    assert slab_render._warp_to_screen_ref.poses == n[4]
    assert float(b[..., 3].max()) > 0.5
    tol = 1.0 if out_dtype == torch.uint8 else 1.0 / 255.0
    assert float((a.float() - b.float()).abs().max()) <= tol


def _steep_cam():
    back = np.asarray((1.0, 0.3, 0.4))
    back /= np.linalg.norm(back)
    return Camera.from_vectors(center=tuple(1.2 * back), v_back=tuple(back),
                               v_world_up=(0.0, 0.0, 1.0), width=W,
                               height=H, fx=50.0)


def test_unit_box_pass_march_matches_plain(grids):
    """Kernel M on each class pass of a steep pose (the unit slope box,
    perm (axis, axis+1, axis+2)) against its plain version."""
    _, g = grids
    cam = _steep_cam()
    classes = slab_render.split_classes(g, cam.transform, cam.fx, cam.fy, W,
                                        H)
    assert len(classes) > 1
    for axis, flip in classes:
        perm = (axis, (axis + 1) % 3, (axis + 2) % 3)
        geom = slab_render.FrameGeom(g, cam.transform, cam.fx, cam.fy, perm,
                                     flip, W, H, OPT, GI,
                                     unit_slope_box=True)
        params, zb = slab_render._march_frame_fields(g, geom, perm, flip,
                                                     OPT)
        crop = slab_render.inplane_crop(g, perm, OPT.sigma_thresh)
        pay = slab_render._permuted_grid(g, perm, crop=crop)
        ids = g.slab_ids(perm[0], flip, OPT.sigma_thresh)
        _display_vs_plain(g, (pay, params, zb, ids, perm, flip, crop),
                          seen=False)


def test_split_frame_card_matches_cpu(grids):
    """A steep pose's split frame on the card (every class pass through
    kernels M and W) equals the CPU run."""
    cpu, gpu = grids
    cam = _steep_cam()
    a = slab_render.render_frame_split(cpu, cam.transform, cam.fx, cam.fy,
                                       W, H, OPT, gi=GI)
    n = slab_render._warp_to_screen_ref.poses
    b = slab_render.render_frame_split(gpu, cam.transform, cam.fx, cam.fy,
                                       W, H, OPT, gi=GI).cpu()
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) <= 1e-4
    assert slab_render._warp_to_screen_ref.poses == n


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
        g.basis_dim, rows, 1, 0, 0, cfg["smem"], out), "slab_march_display")
    assert out[0] == 2 and out[1] > 0 and out[2] == 0, list(out)


def test_wrappers_check_their_inputs(card):
    """A launch with a wrong dtype, shape or layout raises before the
    kernel runs."""
    inter = torch.zeros((1, 4, 32, 32), device=card)
    with pytest.raises(ValueError):
        display_warp.build_table(inter.double(), (4, 4))
    with pytest.raises(ValueError):
        display_warp.build_table(inter.transpose(2, 3), (4, 4))


def _build_input(P, gi, planar, seed):
    """A (P, 4, gi, gi) or (P, gi, gi, 4) f32 intermediate with values
    outside [0, 1] and exactly on the int8 code's rounding ties."""
    a = np.random.default_rng(seed).uniform(
        -0.2, 1.2, (P, 4, gi, gi)).astype(np.float32)
    a[:, 0, :4, :4] = np.array([0.5, 1.5, 2.5, -0.3], np.float32) / 255.0
    a[:, 1, :2, :2] = [[1.7, -2.0], [1.0, 0.0]]
    a[:, 2, 1, :8] = (np.arange(8, dtype=np.float32) + 0.5) / 255.0
    if not planar:
        a = np.ascontiguousarray(np.moveaxis(a, 1, -1))
    return torch.as_tensor(a)


@pytest.mark.parametrize("gi", [37, 40])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("win", [(4, 4), (5, 5), (3, 3), (2, 5), (8, 8),
                                 (56, 56)])
@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_build_table_matches_plain(card, dtype, planar, win, P, gi):
    """Kernel B bit-equal to its plain version in both table types and
    input layouts, at the production windows, others (spans that start
    off 16-byte boundaries in int8; column chunks that end early) and a
    window whose f32 stage does not fit shared memory (56 x 56 at gi =
    61 and 64, read from global memory), on one and three poses."""
    if win == (56, 56):
        gi += 24
    x = _build_input(P, gi, planar, 10 * gi + P)
    counter = "launches_f32" if dtype == torch.float32 else "launches"
    n0 = getattr(display_warp.build_table, counter)
    got = display_warp.build_table(x.to(card), win, dtype=dtype,
                                   planar=planar)
    assert getattr(display_warp.build_table, counter) == n0 + 1
    want = display_warp.build_table_ref(x, win, dtype=dtype, planar=planar)
    assert torch.equal(got.cpu(), want)


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
        bbox_full=True, dir_win=False, train=True)


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


#: the bake kernel's wider cases: (G, D) of tests/_torch_trees.py trees,
#: a deeper pyramid (G = 128, leaves at every level), partial bit words
#: (G = 16) and the run-time width (D = 19)
_BAKE_TREES = [(128, 4), (128, 13), (128, 19), (128, 28), (16, 4),
               (16, 13), (16, 19), (16, 28), (32, 19)]


@pytest.mark.parametrize("case", [1, 4, 9, 16, 25] + [
    f"G{G}-D{D}" for G, D in _BAKE_TREES])
def test_bake_kernel_bit_equal(card, case):
    """The bake kernel equals its plain version bit for bit for D = 4, 13,
    28, 49, 76 (records of 16, 52, 112, 196, 304 bytes: 16-byte units and
    4-byte words), its live bits equal live_bits_ref (sigma around the
    threshold), and its gradient equals autograd through the plain version
    (G = 32); and on _BAKE_TREES: a G = 128 pyramid with leaves at every
    one of its seven levels (the walk's longest), G = 16 rows of half a
    bit word (the partial-word path) and D = 19 (bake_kernel<0>)."""
    from volrend_torch.ops import slab_grad
    if isinstance(case, int):
        tree = make_test_tree(max_depth=4, basis_dim=case, seed=case,
                              sigma_scale=60.0)
        bmap = _bake_case(tree.to_device(lut_depth=None, device=card), case,
                          grad=True)
        assert bmap.G == 32 and len(slab_grad.level_map(bmap).unique()) > 1
        return
    from _torch_trees import tree_n
    G, D = (int(v[1:]) for v in case.split("-"))
    depth = {16: 3, 32: 4, 128: 6}[G]
    tree = tree_n(2, depth, D, seed=G + D)
    bmap = _bake_case(tree.to_device(lut_depth=None, device=card), G + D,
                      grad=G < 128)
    assert bmap.G == G and bmap.D == D
    if G == 128:
        levels = slab_grad.level_map(bmap).unique()
        assert len(levels) == len(bmap.masks) == 7, levels


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
@pytest.mark.parametrize("gi", [35, 40, 61, 800])
def test_probe_build_matches_plain(card, gi, planar):
    """P9 in both layouts, bit-equal to its plain version, padding rows
    (gi = 40: 37 rows padded to 48; gi = 61: 58 rows padded to 64, so the
    last 8-row tile of the planar build holds 2 window rows and 6 padding
    rows) included; gi = 800's planar tiles do not fit shared memory and
    are read from global memory."""
    from volrend_torch.probes import perf_sq4
    it = torch.as_tensor(np.random.default_rng(7).uniform(
        0.0, 1.0, (4, gi, gi)).astype(np.float32)).to(torch.bfloat16).to(
            card)
    counter = "launches_planar" if planar else "launches"
    n0 = getattr(perf_sq4.build_probe, counter)
    got = perf_sq4.build_probe(it, gi, planar=planar)
    assert getattr(perf_sq4.build_probe, counter) == n0 + 1
    assert torch.equal(got, perf_sq4.build_probe_ref(it, gi, planar=planar))


# ---------------------------------------------------------------------------
# Kernel M's display variants: the f16 bake's bf16 payload, SG, ASG and RGBA
# trees and the viewer's options (depth, render_bbox, the basis window,
# rot_dirs), each against its plain version on the same CUDA tensors
# ---------------------------------------------------------------------------

def _lobes(fmt, bd, seed):
    """SG (bd, 4) or ASG (bd, 11) lobes drawn from ``seed`` (as
    tests/_torch_scenes.py ``lobes`` draws them)."""
    rng = np.random.default_rng(seed)
    if fmt == "SG":
        mu = rng.normal(size=(bd, 3))
        mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
        return np.concatenate([rng.uniform(1.0, 6.0, (bd, 1)), mu],
                              -1).astype(np.float32)
    extra = np.zeros((bd, 11), np.float32)
    for i in range(bd):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        extra[i, :2] = rng.uniform(0.5, 4.0, 2)
        extra[i, 2:] = q.T.reshape(-1)
    return extra


@pytest.fixture(scope="module")
def format_grids(card):
    """{(format, bake dtype): grid on the card}: the G=32 SH16 fog read as
    SH16, SG16, ASG16 (its leaves as lobe coefficients) and as an RGBA tree
    (its first three colour coefficients and sigma), baked int8 and f16."""
    from volrend_torch.models.data_format import BasisType
    tree = make_test_tree(max_depth=4, basis_dim=16, seed=5,
                          sigma_scale=60.0)
    out = {}
    for fmt in ("SH", "SG", "ASG", "RGBA"):
        dev = tree.to_device(lut_depth=None, device=card)
        if fmt in ("SG", "ASG"):
            dev = dataclasses.replace(
                dev, fmt=BasisType[fmt],
                extra=torch.as_tensor(_lobes(fmt, 16, 4), device=card))
        elif fmt == "RGBA":
            D = dev.data_dim
            rows = torch.cat([torch.sigmoid(dev.data[:, 0:48:16].float()),
                              dev.data[:, D - 1:D].float()], 1)
            dev = dataclasses.replace(
                dev, data=rows.to(dev.data.dtype).contiguous(), data_dim=4,
                basis_dim=-1, fmt=BasisType.RGBA)
        for dt in ("int8", "f16"):
            out[(fmt, dt)] = dense_grid.bake_dense(dev, dtype=dt)
    return out


def _variant_vs_plain(g, opt, backs=((1.0, 0.25, 0.35), (1.0, 0.1, 0.45)),
                      fx=200.0, crop=None, dir_win=True, shade_bf16=False,
                      tol=TOL_M):
    """Kernel M on grid ``g`` with the format and options of ``opt`` (and
    the display knobs ``dir_win``, ``shade_bf16``) against its plain
    version within ``tol``; returns (acc, the launch's variant)."""
    cams = _cams(backs, fx)
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform, fx, fx, W,
                                            H)
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 fx, fx, perm, flip, W, H, opt, GI)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, opt)
    pay = slab_render._permuted_grid(g, perm, crop=crop)
    ids = g.slab_ids(perm[0], flip, opt.sigma_thresh)
    rotm = slab_render._rodrigues_matrix(opt.rot_dirs)
    kw = dict(fmt=int(g.fmt), extra=g.extra, depth=bool(opt.render_depth),
              rot=(None if rotm is None
                   else tuple(float(v) for v in rotm.reshape(-1))),
              bbox_full=slab_render._bbox_full(opt),
              basis_lo=int(opt.basis_minmax[0]),
              basis_hi=int(opt.basis_minmax[1]))
    n0 = slab_march.march_slabs.launches
    acc = slab_march.march_slabs(
        pay, params, g.qscale, zb, g.G, GI, g.data_dim, g.basis_dim, perm,
        slab_ids=ids, sig2=g.quantized, flip=flip, dir_win=dir_win,
        shade_bf16=shade_bf16, crop=crop, **kw)
    assert slab_march.march_slabs.launches == n0 + 1
    variant = slab_march.march_slabs.display["variant"]
    m = slab_march.march_inputs(pay, params, zb, g.G, GI, ids, 4, crop)
    ref = slab_march.march_slabs_ref(
        pay, g.qscale, D=g.data_dim, bd=g.basis_dim, flip=flip,
        dir_win=dir_win, bf16_shade=shade_bf16 and g.fmt == 1
        and not opt.render_depth, **kw, **m)
    torch.cuda.synchronize()
    assert float(acc[:, 3].min()) < 0.9
    _agree(acc, ref, tol)
    return acc, variant


_OPTIONS = {
    "none": {}, "depth": dict(render_depth=True),
    "bbox": dict(render_bbox=(0.25,) * 3 + (0.75,) * 3),
    "window": dict(basis_minmax=(0, 8)), "rot": dict(rot_dirs=(0.3, -0.2,
                                                               0.5)),
    "all": dict(rot_dirs=(0.25, -0.15, 0.3), basis_minmax=(1, 5),
                render_bbox=(0.1, 0.1, 0.0, 0.9, 0.9, 1.0)),
}


@pytest.mark.parametrize("fmt", ["SH", "SG", "ASG", "RGBA"])
@pytest.mark.parametrize("dt", ["int8", "f16"])
@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_display_variants_match_plain(format_grids, fmt, dt, option):
    """Every format on both bakes, with each option and all together,
    through the variant its mode names (slab_march.display_variant)."""
    g = format_grids[(fmt, dt)]
    opt = dataclasses.replace(OPT, **_OPTIONS[option])
    _, variant = _variant_vs_plain(g, opt)
    want = slab_march.display_variant(
        slab_march.MarchMode(
            int(g.fmt), None, bool(opt.render_depth),
            None if slab_render._rodrigues_matrix(opt.rot_dirs) is None
            else (0.0,) * 9,
            slab_render._bbox_full(opt), *opt.basis_minmax),
        g.basis_dim, dt == "f16")
    assert variant == want, (variant, want)
    assert variant.startswith(fmt + ("-bf16" if dt == "f16" else "-int8"))


@pytest.mark.parametrize("fmt", ["SH", "SG", "RGBA"])
def test_display_bf16_unaligned_rows_match_plain(format_grids, fmt):
    """A bf16 payload whose rows are not whole 16-byte chunks (a crop of
    Gx = 30) is staged by element copies, and agrees."""
    g = format_grids[(fmt, "f16")]
    _variant_vs_plain(g, dataclasses.replace(OPT, render_depth=fmt == "SG"),
                      crop=(0, 32, 1, 30))


def _rgba_backs(P):
    """P view directions of one (perm, flip) group, spread over an arc."""
    t = np.linspace(0.0, 1.0, P)
    return [(1.0, 0.1 + 0.3 * a, 0.2 + 0.25 * (1.0 - a)) for a in t]


def _rgba_blocks(P):
    """The blocks an SM display_config gives RGBA's kernel of its own at P
    poses: three past one wave of two blocks an SM, else two (at GI = 64,
    P = 1 and 4 take two, 51 three)."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 3 if P * -(-GI // 32) * -(-GI // 8) > 2 * n_sm else 2


def _rgba_launch(g, P, bbox=False, crop=None, option_variant=False):
    """One RGBA display launch of P poses on grid ``g`` (32x8 tiles), with a
    render_bbox or without; ``option_variant``: the option variant
    (vt_march_display's opt 1) under a bbox that holds the whole grid,
    which masks nothing. Returns (acc, the plain version's acc, the
    launch's configuration)."""
    opt = OPT
    if bbox:
        opt = dataclasses.replace(OPT, **_OPTIONS["bbox"])
    cams = _cams(_rgba_backs(P))
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform, 200.0,
                                            200.0, W, H)
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 200.0, 200.0, perm, flip, W, H, opt, GI)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, opt)
    pay = slab_render._permuted_grid(g, perm, crop=crop)
    ids = g.slab_ids(perm[0], flip, opt.sigma_thresh)
    mode = slab_march.MarchMode(
        int(g.fmt), None, False, None,
        slab_render._bbox_full(opt) and not option_variant)
    n0 = slab_march.march_slabs.launches
    acc = slab_march.march_slabs(
        pay, params, g.qscale, zb, g.G, GI, g.data_dim, g.basis_dim,
        perm, slab_ids=ids, sig2=g.quantized, flip=flip, dir_win=True,
        k_per_step=slab_march._K_STEP, crop=crop, fmt=mode.fmt,
        bbox_full=mode.bbox_full)
    assert slab_march.march_slabs.launches == n0 + 1
    m = slab_march.march_inputs(pay, params, zb, g.G, GI, ids,
                                slab_march._K_STEP, crop)
    ref = slab_march.march_slabs_ref(pay, g.qscale, D=g.data_dim, bd=-1,
                                     flip=flip, dir_win=True,
                                     **mode._asdict(), **m)
    torch.cuda.synchronize()
    return acc, ref, dict(slab_march.march_slabs.display)


@pytest.mark.parametrize("P", [1, 4, 51])
@pytest.mark.parametrize("dt", ["int8", "f16"])
def test_rgba_kernel_matches_plain(format_grids, dt, P):
    """RGBA without a bbox takes its kernel of its own (rgba_kernel on
    32x8 tiles, vt_march_display's opt 0 at two blocks an SM, 4 at three:
    1 and 4 poses take two, 51 three) on both payloads, named
    ``RGBA-<payload>``, and agrees with the plain version (TOL_M, freeze
    flips aside)."""
    g = format_grids[("RGBA", dt)]
    acc, ref, cfg = _rgba_launch(g, P)
    blocks = _rgba_blocks(P)
    assert blocks == (3 if P == 51 else 2)
    assert cfg["variant"] == ("RGBA-bf16" if dt == "f16" else "RGBA-int8")
    assert (cfg["rows"], cfg["chan_cells"], cfg["blocks"]) == (1, 0, blocks)
    assert cfg["opt"] == {2: 0, 3: 4}[blocks]
    assert float(acc[:, 3].min()) < 0.9
    _agree(acc, ref)


@pytest.mark.parametrize("P", [1, 4, 51])
@pytest.mark.parametrize("dt", ["int8", "f16"])
def test_rgba_bbox_keeps_the_option_variant(format_grids, dt, P):
    """RGBA with a render_bbox keeps the option variant (32x8, named
    ``-opt``) and agrees with the plain version."""
    g = format_grids[("RGBA", dt)]
    acc, ref, cfg = _rgba_launch(g, P, bbox=True)
    assert cfg["variant"].endswith("-opt") and cfg["opt"] == 1
    _agree(acc, ref)


@pytest.mark.parametrize("dt", ["int8", "f16"])
def test_rgba_kernel_bit_equal_to_the_option_variant(format_grids, dt):
    """Where each tile-slab footprint stages in one piece (this grid's
    all do), the RGBA kernel's output is the option variant's bit for bit
    at two and three blocks an SM: the taps decode each cell with the
    shade pass's arithmetic and sum in its order (4 poses: two blocks; 51:
    three)."""
    g = format_grids[("RGBA", dt)]
    for P, blocks in ((4, 2), (51, 3)):
        acc_o, _, cfg_o = _rgba_launch(g, P, option_variant=True)
        assert cfg_o["opt"] == 1
        acc, _, cfg = _rgba_launch(g, P)
        assert blocks == _rgba_blocks(P)
        assert cfg["opt"] == {2: 0, 3: 4}[blocks]
        assert torch.equal(acc, acc_o)


@pytest.mark.parametrize("P, blocks", [(4, 2), (51, 3)])
def test_rgba_kernel_unaligned_bf16_rows(format_grids, P, blocks):
    """A bf16 crop whose rows are not whole 16-byte chunks (Gx = 30) is
    staged into the RGBA kernel's slots by the producer's element copies,
    at two blocks an SM (4 poses) and three (51), and agrees."""
    g = format_grids[("RGBA", "f16")]
    acc, ref, cfg = _rgba_launch(g, P, crop=(0, 32, 1, 30))
    assert blocks == _rgba_blocks(P)
    assert cfg["opt"] == {2: 0, 3: 4}[blocks]
    _agree(acc, ref)


@pytest.mark.parametrize("P", [1, 51])
@pytest.mark.parametrize("levels", [
    (((4, 4), (5, 5)), ((2, 2), (4, 4))),
    (((4, 4), (5, 5)), ((5, 5), (6, 6)))], ids=["cascade", "spare"])
def test_fit_cascade_bit_equal_at_a_group(grids, levels, P):
    """W's fit mode at 1 and 51 poses: the production cascade, biggest
    block first as plan_fits hands it (its kernel of its own,
    fit_cascade), and a level set that does not nest in 16 pixels
    (fit_kernel), bit-equal to the plain version."""
    _, g = grids
    _, prm, _ = _warp_case(g, 80.0, backs=_rgba_backs(P))
    counts = display_warp.level_fit_counts(prm, levels, GI, H, W)
    assert torch.equal(counts, display_warp.level_fit_counts_ref(
        prm, levels, GI, H, W))


@pytest.mark.parametrize("crop", [(0, 32, 1, 30), (2, 28, 16, 16)])
@pytest.mark.parametrize("dt", ["int8", "f16"])
@pytest.mark.parametrize("option", ["bbox", "all"])
def test_display_cropped_options_match_plain(format_grids, crop, dt, option):
    """The bbox mask on a cropped payload, as a sparse scene with a box
    takes it: the crop's in-plane offset (x0 = 1, staged by element
    copies; x0 = 16, by cp.async) shifts every cell's global index, which
    the mask reads."""
    g = format_grids[("SH", dt)]
    _variant_vs_plain(g, dataclasses.replace(OPT, **_OPTIONS[option]),
                      crop=crop)


@pytest.mark.parametrize("fmt, dt", [("SG", "int8"), ("SG", "f16"),
                                     ("ASG", "int8"), ("ASG", "f16")])
def test_display_variants_lobe_counts(card, fmt, dt):
    """SG and ASG lobe counts from 1 to 25 on both bakes, each against the
    plain version (one instantiation takes every count at run time), and
    a count past them, which raises ValueError naming the set."""
    from volrend_torch.models.data_format import BasisType
    for bd in (1, 5, 9, 12, 16, 25):
        tree = make_test_tree(max_depth=4, basis_dim=bd if bd in (
            1, 9, 16, 25) else 4, seed=5, sigma_scale=60.0)
        dev = tree.to_device(lut_depth=None, device=card)
        if dev.basis_dim != bd:
            # widen to bd lobes: repeat the leaf's coefficients
            D = dev.data_dim
            cols = dev.data[:, :D - 1].float().reshape(-1, 3, dev.basis_dim)
            cols = cols[:, :, torch.arange(bd, device=card) % dev.basis_dim]
            data = torch.cat([cols.reshape(-1, 3 * bd),
                              dev.data[:, D - 1:D].float()], 1)
            dev = dataclasses.replace(dev, data=data.to(dev.data.dtype),
                                      data_dim=3 * bd + 1, basis_dim=bd)
        dev = dataclasses.replace(
            dev, fmt=BasisType[fmt],
            extra=torch.as_tensor(_lobes(fmt, bd, bd), device=card))
        g = dense_grid.bake_dense(dev, dtype=dt)
        _, variant = _variant_vs_plain(g, OPT)
        assert variant == f"{fmt}-{'bf16' if dt == 'f16' else 'int8'}"
    g = dataclasses.replace(g, basis_dim=26, data_dim=79)
    with pytest.raises(ValueError, match="1..25"):
        slab_render.prepare_payload(g, (0, 1, 2), OPT)


@pytest.mark.parametrize("P", [1, 51])
def test_lobe_and_depth_display_launch_configuration(card, P):
    """Every SG and ASG instantiation (both payloads, both tile heights)
    and the depth variant (both payloads) at the launch configuration
    display_config gives it: two blocks an SM, no spill bytes, at most
    128 registers."""
    from volrend_torch import kernels
    lib = kernels.lib("slab_march_display")
    cases = [(fmt, bf16, rows, False) for fmt in (2, 3) for bf16 in (0, 1)
             for rows in (1, 2)]
    cases += [(1, bf16, 1, True) for bf16 in (0, 1)]
    for fmt, bf16, rows, depth in cases:
        nb = 16
        Dp = 3 * nb + (1 if bf16 else 2)
        cfg = slab_march.display_config(P, 256, 64, Dp, 132, esz=1 + bf16,
                                        opt=True, depth=depth)
        out = (ctypes.c_int * 4)()
        kernels.check(lib.vt_march_display_info(
            nb, rows, fmt, bf16, 5 if depth else 1, cfg["smem"], out),
            "slab_march_display")
        assert out[0] == 2 and out[2] == 0 and out[1] <= 128, (
            fmt, bf16, rows, depth, list(out))


@pytest.mark.parametrize("dt", ["int8", "f16"])
@pytest.mark.parametrize("fmt", ["SH", "ASG"])
def test_display_depth_unaligned_rows_match_plain(format_grids, fmt, dt):
    """The depth variant on both payloads on a crop whose rows are not
    whole 16-byte chunks (Gx = 30: staged by element copies), and on an
    aligned crop (Gx = 16 at x0 = 16: cp.async), against the plain
    version; named ``-depth``."""
    g = format_grids[(fmt, dt)]
    dopt = dataclasses.replace(OPT, render_depth=True)
    for crop in ((0, 32, 1, 30), (2, 28, 16, 16)):
        _, variant = _variant_vs_plain(g, dopt, crop=crop)
        assert variant.endswith("-depth"), variant


@pytest.mark.parametrize("dt", ["int8", "f16"])
def test_display_depth_ndc_matches_plain(card, ndc_grids, dt):
    """The depth variant on two NDC poses (the NDC geometry's z0 and
    tview planes) on both payloads, against the plain version."""
    g = ndc_grids[1] if dt == "int8" else dense_grid.bake_dense(
        _ndc_tree().to_device(lut_depth=None, device=card), dtype="f16")
    dopt = dataclasses.replace(OPT, render_depth=True)
    cams = _ndc_cams()
    perm, flip, _ = slab_render.choose_axis(g, cams[0].transform, 200.0,
                                            200.0, W, H)
    geom = slab_render.FrameGeom(g, np.stack([c.transform for c in cams]),
                                 200.0, 200.0, perm, flip, W, H, dopt, GI)
    params, zb = slab_render._march_frame_fields(g, geom, perm, flip, dopt)
    pay = slab_render._permuted_grid(g, perm)
    ids = g.slab_ids(perm[0], flip, dopt.sigma_thresh)
    kw = dict(fmt=int(g.fmt), extra=g.extra, depth=True, bbox_full=True)
    acc = slab_march.march_slabs(
        pay, params, g.qscale, zb, g.G, GI, g.data_dim, g.basis_dim, perm,
        slab_ids=ids, sig2=g.quantized, flip=flip, dir_win=True, **kw)
    assert slab_march.march_slabs.display["variant"].endswith("-depth")
    m = slab_march.march_inputs(pay, params, zb, g.G, GI, ids, 4)
    ref = slab_march.march_slabs_ref(pay, g.qscale, D=g.data_dim,
                                     bd=g.basis_dim, flip=flip,
                                     dir_win=True, **kw, **m)
    torch.cuda.synchronize()
    assert float(acc[:, 0].max()) > 0.0
    _agree(acc, ref)


@pytest.mark.parametrize("bd", [1, 4, 9, 16, 25])
def test_default_display_launch_configuration(card, bd):
    """The SH int8 default keeps its launch: the tile rule's two heights,
    two blocks an SM with no spills, and its own instantiation (no option
    variant) for the default options."""
    from volrend_torch import kernels
    Dp = 3 * bd + 2
    for P, rows in ((1, 1), (51, 2)):
        cfg = slab_march.display_config(P, 256, 64, Dp, 132)
        assert cfg["rows"] == rows
        out = (ctypes.c_int * 4)()
        kernels.check(kernels.lib("slab_march_display")
                      .vt_march_display_info(bd, rows, 1, 0, 0, cfg["smem"],
                                             out), "slab_march_display")
        assert out[0] == 2 and out[2] == 0 and out[1] <= 128, list(out)
    assert slab_march.display_variant(slab_march.MarchMode(), bd,
                                      False) == "SH-int8"


# ---------------------------------------------------------------------------
# The training pair's formats and options (kernel M's training mode and
# M-bwd: SG and ASG of 1 to 25 lobes, RGBA, SH with rot, a basis window and
# a bbox) and the bake kernel's run-time record widths
# ---------------------------------------------------------------------------

#: the default SH instantiations' launches before the training pair took
#: formats and options (commit 48b6bfc, NVIDIA H100 80GB HBM3; read by
#: ``python volrend_torch/probes/train_info.py --root <that checkout>``):
#: per variant, M's (blocks per SM, registers, spill bytes, dynamic shared
#: memory) and M-bwd's (pass 1's four, pass 2's blocks, registers, spills)
DEFAULT_TRAIN_INFO = {
    "SH1-f32": ([5, 96, 40, 36864], [4, 114, 40, 36864, 16, 32, 0]),
    "SH1-bf16": ([5, 96, 40, 26112], [4, 115, 40, 26112, 16, 32, 0]),
    "SH4-f32": ([4, 96, 40, 41472], [4, 120, 40, 41472, 12, 40, 0]),
    "SH4-bf16": ([4, 105, 40, 32256], [4, 122, 40, 32256, 16, 32, 0]),
    "SH9-f32": ([2, 96, 48, 73728], [2, 128, 40, 73728, 10, 48, 0]),
    "SH9-bf16": ([4, 96, 40, 44544], [4, 96, 128, 44544, 10, 46, 0]),
    "SH16-f32": ([2, 96, 40, 96768], [2, 126, 40, 96768, 8, 64, 0]),
    "SH16-bf16": ([3, 122, 40, 59904], [3, 124, 40, 59904, 8, 64, 0]),
    "SH25-f32": ([1, 128, 40, 147456], [1, 128, 168, 147456, 5, 96, 0]),
    "SH25-bf16": ([2, 128, 40, 81408], [2, 154, 40, 81408, 5, 93, 0]),
}


def _train_variant_case(group_geom, fmt, nb, dtype, options=None, seed=0):
    """Kernel M's training mode and M-bwd of one variant on a two-cube bake
    (G = 32) seen from one (perm, flip) group against their plain versions
    on the same CUDA tensors; returns the launches' variant names."""
    from volrend_torch.models.data_format import BasisType
    from volrend_torch.ops import slab_grad
    grid, cams = group_geom
    (perm, flip), cam = sorted(cams.items())[seed % len(cams)]
    D = 4 if fmt == "RGBA" else 3 * nb + 1
    G, gi = grid.G, 40
    dev = grid.data.device
    bake = _two_cubes(G, D, dtype, dev, seed)
    opt = OPT.replace(renormalize=False, **(options or {}))
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, 48, 48, opt, gi)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=gi, D=D, bd=nb, fmt=int(BasisType[fmt]),
                            perm=perm, flip=flip, ids=ids, opt=opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    st = slab_grad._kernel_statics(cfg)
    st.pop("flip")
    st["extra"] = (torch.as_tensor(_lobes(fmt, nb, seed), device=dev)
                   if fmt in ("SG", "ASG") else None)
    planar = _view(bake, perm)
    qs = torch.ones(D, device=dev)
    slab_march.march_slabs.train_variants = {}
    slab_march.march_slabs_bwd.variants = {}
    acc = slab_march.march_slabs(planar, params, qs, zb, G, gi, D, nb, perm,
                                 slab_ids=ids, flip=flip, dir_win=False,
                                 train=True, **st)
    m = slab_march.march_inputs(planar, params, zb, G, gi, ids)
    ref = slab_march.march_slabs_ref(planar, qs, D=D, bd=nb, flip=flip,
                                     **st, **m)
    torch.cuda.synchronize()
    assert float(acc[:, 3].min()) < 0.5, (fmt, nb)
    _freeze_flip_ok(acc, ref)
    gacc4 = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(4, gi, gi)).astype(np.float32), device=dev)
    gk = slab_march.march_slabs_bwd(planar, params[0], qs, zb[0], gacc4,
                                    acc[0], G, gi, D, nb, perm, flip=flip,
                                    out_dtype=dtype, **st)
    assert gk.stride() == planar.stride()
    prm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
        params[0], zb[0], gacc4, acc[0], G, gi)
    mode = slab_march.MarchMode(cfg.fmt, st["extra"], False, st["rot"],
                                st["bbox_full"], st["basis_lo"],
                                st["basis_hi"])
    gp = slab_march.march_slabs_bwd_ref(planar, qs, prm, bzb, bgacc, aux, G,
                                        gi, D, nb, flip, mode=mode)
    _bwd_agrees(gk, gp, dtype)
    name = slab_march.train_variant(mode, nb, dtype == torch.float32)
    assert slab_march.march_slabs.train_variants == {name: 1}
    assert slab_march.march_slabs_bwd.variants == {name: 1}
    return name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb", [1, 3, 6, 16, 25])
@pytest.mark.parametrize("fmt", ["SG", "ASG"])
def test_train_lobe_variants_match_plain(group_geom, fmt, nb, dtype):
    """SG and ASG trees of 1, 3, 6, 16 and 25 lobes (the lobe bounds 4, 9,
    16 and 25, records of 4 to 76 values whose width the kernels take at
    run time: 16-byte copies where a record is a whole number of 16-byte
    units, aligned words elsewhere) through both training kernels, f32 and
    bf16, against their plain versions."""
    name = _train_variant_case(group_geom, fmt, nb, dtype, seed=nb)
    assert name.startswith(fmt + "-")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_rgba_matches_plain(group_geom, dtype):
    """An RGBA bake (D = 4: raw colours, no sigmoid) through both training
    kernels against their plain versions."""
    assert _train_variant_case(group_geom, "RGBA", -1, dtype,
                               seed=2).startswith("RGBA-")


@pytest.mark.parametrize("pay, out, options", [
    (torch.float32, torch.float32, {}),
    (torch.bfloat16, torch.bfloat16, {}),
    (torch.bfloat16, torch.float32,
     dict(render_bbox=(0.2,) * 3 + (0.8,) * 3))])
def test_train_rgba_zsegment_matches_plain(group_geom, pay, out, options):
    """M-bwd on the two z-segments of an RGBA bake (slab_grad.zsegment),
    each launched with its z_base and an incoming (T, A) state
    (state_init), against its plain version on the same CUDA tensors:
    with an f32 cotangent (pass 1 writes it itself; on a bf16 payload, and
    with a bbox) and with a bf16 one (the sum buffer and pass 2)."""
    from volrend_torch.models.data_format import BasisType
    from volrend_torch.ops import slab_grad
    grid, cams = group_geom
    (perm, flip), cam = sorted(cams.items())[3 % len(cams)]
    G, D, gi = grid.G, 4, 40
    dev = grid.data.device
    opt = OPT.replace(renormalize=False, **options)
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, 48, 48, opt, gi)
    cfg = slab_grad.SlabCfg(G=G, gi=gi, D=D, bd=-1,
                            fmt=int(BasisType.RGBA), perm=perm, flip=flip,
                            ids=(), opt=opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    st = slab_grad._kernel_statics(cfg)
    st.pop("flip")
    mode = slab_march.MarchMode(cfg.fmt, None, False, st["rot"],
                                st["bbox_full"], st["basis_lo"],
                                st["basis_hi"])
    qs = torch.ones(D, device=dev)
    rng = np.random.default_rng(7)
    gacc4 = torch.as_tensor(rng.normal(size=(4, gi, gi)).astype(np.float32),
                            device=dev)
    acc4 = torch.as_tensor(rng.uniform(size=(4, gi, gi)).astype(np.float32),
                           device=dev)
    planar = _view(_two_cubes(G, D, pay, dev, 3), perm)
    Gl = G // 2
    for i in range(2):
        seg = slab_grad.zsegment(planar, i, Gl)
        state = torch.as_tensor(np.stack([
            rng.uniform(0.3, 1.0, (gi, gi)), rng.normal(0.0, 0.5, (gi, gi))
        ]).astype(np.float32), device=dev)
        n0 = slab_march.march_slabs_bwd.segments
        gk = slab_march.march_slabs_bwd(
            seg, params[0], qs, zb[0], gacc4, acc4, G, gi, D, -1, perm,
            flip=flip, z_base=i * Gl / G, state_init=state, out_dtype=out,
            **st)
        assert slab_march.march_slabs_bwd.segments == n0 + 1
        assert gk.dtype == out and gk.stride() == seg.stride()
        bprm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
            params[0], zb[0], gacc4, acc4, G, gi, state, i * Gl / G)
        gp = slab_march.march_slabs_bwd_ref(seg, qs, bprm, bzb, bgacc, aux,
                                            G, gi, D, -1, flip, mode=mode)
        _bwd_agrees(gk, gp, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bd", [1, 4, 9, 16, 25])
@pytest.mark.parametrize("option", ["rot", "window", "bbox", "all"])
def test_train_sh_options_match_plain(group_geom, option, bd, dtype):
    """SH trees with rot_dirs, a basis window, a non-full render_bbox and
    all three through both training kernels' option variants against their
    plain versions."""
    opts = {"rot": dict(rot_dirs=(0.3, -0.2, 0.5)),
            "window": dict(basis_minmax=(1, max(1, bd - 3))),
            "bbox": dict(render_bbox=(0.2,) * 3 + (0.7,) * 3)}
    options = ({k: v for o in opts.values() for k, v in o.items()}
               if option == "all" else opts[option])
    name = _train_variant_case(group_geom, "SH", bd, dtype, options,
                               seed=bd + 1)
    assert name.endswith("-opt")


def test_default_train_launches_keep_their_configuration(card):
    """The default SH instantiations of kernel M's training mode and of
    M-bwd keep the registers, spills, blocks per SM and shared memory they
    had before the option variants were added (DEFAULT_TRAIN_INFO)."""
    from volrend_torch import kernels
    assert DEFAULT_TRAIN_INFO
    for key, want in DEFAULT_TRAIN_INFO.items():
        bd, f32 = int(key.split("-")[0][2:]), int(key.endswith("f32"))
        m = (ctypes.c_int * 11)()
        b = (ctypes.c_int * 7)()
        kernels.check(kernels.lib("slab_march").vt_march_slabs_info(
            bd, f32, 1, 0, m), "slab_march")
        kernels.check(kernels.lib("slab_march_bwd").vt_march_slabs_bwd_info(
            bd, f32, 1, 0, b), "slab_march_bwd")
        assert (list(m[:4]), list(b)) == (want[0], want[1]), key


#: the SG and ASG instantiations of the training pair (by lobe bound and
#: payload) before their lobes were folded and streamed (commit 5ec07bc,
#: NVIDIA H100 80GB HBM3; ``python volrend_torch/probes/train_info.py``):
#: resident blocks per SM of M, M-bwd's pass 1 and its pass 2, which the
#: redesign keeps or raises
LOBE_TRAIN_INFO = {
    "SG<=4-f32": (4, 4, 12),
    "SG<=4-bf16": (4, 5, 12),
    "SG<=9-f32": (2, 2, 12),
    "SG<=9-bf16": (4, 4, 12),
    "SG<=16-f32": (2, 2, 8),
    "SG<=16-bf16": (3, 3, 8),
    "SG<=25-f32": (1, 1, 5),
    "SG<=25-bf16": (2, 2, 5),
    "ASG<=4-f32": (4, 4, 12),
    "ASG<=4-bf16": (4, 5, 12),
    "ASG<=9-f32": (2, 2, 10),
    "ASG<=9-bf16": (4, 4, 10),
    "ASG<=16-f32": (2, 2, 7),
    "ASG<=16-bf16": (3, 3, 7),
    "ASG<=25-f32": (1, 1, 4),
    "ASG<=25-bf16": (2, 2, 4),
}


def test_lobe_train_launches_stay_within_their_limits(card):
    """Every SG and ASG instantiation of kernel M's training mode and of
    M-bwd, at lobe bounds 4, 9, 16 and 25 on f32 and bf16 payloads: M and
    pass 1 take no more local bytes than the SH default of the same bound
    and payload, pass 2 takes none, and each holds at least the blocks an
    SM it held before the redesign (LOBE_TRAIN_INFO); pass 1 at bound 4 on
    bf16 held five by spilling at 96 registers, and holds the SH
    default's four without spills (faster: PERF.md)."""
    assert len(LOBE_TRAIN_INFO) == 16

    def info(bd, f32, fmt):
        m = (ctypes.c_int * 11)()
        b = (ctypes.c_int * 7)()
        opt = int(fmt != 1)
        kernels.check(slab_march.train_lib("slab_march", fmt, opt)
                      .vt_march_slabs_info(bd, f32, fmt, opt, m),
                      "slab_march")
        kernels.check(slab_march.train_lib("slab_march_bwd", fmt, opt)
                      .vt_march_slabs_bwd_info(bd, f32, fmt, opt, b),
                      "slab_march_bwd")
        # (blocks, local bytes) of M, pass 1 and pass 2
        return ((m[0], m[2]), (b[0], b[2]), (b[4], b[6]))

    from volrend_torch import kernels
    for key, blocks in LOBE_TRAIN_INFO.items():
        name, rest = key.split("<=")
        bound, pay = rest.split("-")
        f32 = int(pay == "f32")
        sh = info(int(bound), f32, 1)
        got = info(int(bound), f32, 2 if name == "SG" else 3)
        want = (blocks[0], min(blocks[1], sh[1][0]), blocks[2])
        assert all(g[0] >= b for g, b in zip(got, want)), (key, got)
        assert got[0][1] <= sh[0][1] and got[1][1] <= sh[1][1], (key, got,
                                                                  sh)
        assert got[2][1] == 0, (key, got)


#: the SH option and RGBA instantiations of the training pair (by bound and
#: payload) since their redesign (NVIDIA H100 80GB HBM3;
#: ``python volrend_torch/probes/train_info.py``): resident blocks per SM
#: of M, M-bwd's pass 1 (RGBA on f32: the pass that writes the cotangent
#: itself) and its pass 2
OPT_TRAIN_INFO = {
    "SH1-opt-f32": (4, 4, 12),
    "SH1-opt-bf16": (4, 4, 12),
    "SH4-opt-f32": (4, 4, 10),
    "SH4-opt-bf16": (4, 4, 10),
    "SH9-opt-f32": (2, 2, 8),
    "SH9-opt-bf16": (4, 4, 8),
    "SH16-opt-f32": (2, 2, 6),
    "SH16-opt-bf16": (3, 3, 6),
    "SH25-opt-f32": (1, 1, 4),
    "SH25-opt-bf16": (2, 2, 4),
    "RGBA-f32": (4, 4, 12),
    "RGBA-bf16": (4, 4, 12),
}


#: kernel M's local bytes a thread in every SH option and RGBA
#: instantiation (commit bb0fdfb, NVIDIA H100 80GB HBM3; ``python
#: volrend_torch/probes/train_info.py``): the launch's counts
OPT_TRAIN_M_LOCAL = 40


def test_opt_train_launches_stay_within_their_limits(card):
    """Every SH option (SH1 to SH25 with rot, a basis window or a bbox) and
    RGBA instantiation of kernel M's training mode and of M-bwd, on f32
    and bf16 payloads: M-bwd's pass 1 takes no more local bytes than the
    SH default of the same bound and payload (RGBA's 4-value records:
    SH1's), pass 2 takes none, kernel M no more than OPT_TRAIN_M_LOCAL,
    and each holds at least the blocks an SM of OPT_TRAIN_INFO."""
    from volrend_torch import kernels
    assert len(OPT_TRAIN_INFO) == 12

    def info(bd, f32, fmt, opt):
        m = (ctypes.c_int * 11)()
        b = (ctypes.c_int * 7)()
        kernels.check(slab_march.train_lib("slab_march", fmt, opt)
                      .vt_march_slabs_info(bd, f32, fmt, opt, m),
                      "slab_march")
        kernels.check(slab_march.train_lib("slab_march_bwd", fmt, opt)
                      .vt_march_slabs_bwd_info(bd, f32, fmt, opt, b),
                      "slab_march_bwd")
        # (blocks, local bytes) of M, pass 1 and pass 2
        return ((m[0], m[2]), (b[0], b[2]), (b[4], b[6]))

    for key, blocks in OPT_TRAIN_INFO.items():
        name, pay = key.rsplit("-", 1)
        f32 = int(pay == "f32")
        bd = -1 if name == "RGBA" else int(name.split("-")[0][2:])
        sh = info(max(bd, 1), f32, 1, 0)
        got = info(bd, f32, 0 if bd < 0 else 1, 1)
        assert all(g[0] >= b for g, b in zip(got, blocks)), (key, got)
        assert got[0][1] <= OPT_TRAIN_M_LOCAL, (key, got)
        assert got[1][1] <= sh[1][1], (key, got, sh)
        assert got[2][1] == 0, (key, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["SH1", "SH4", "SH9", "SH16", "SH25",
                                     "RGBA", "SH9-resume", "RGBA-resume"])
def test_train_option_variants_match_plain_on_silhouette_tiles(
        group_geom, variant, dtype):
    """Kernel M's option training variants against their plain versions on
    a two-cube bake at the training stop_thresh, whose rays freeze inside
    the cubes while their neighbours miss them: tiles with frozen and live
    pixels both (SH at every bound with rot, a basis window and a bbox;
    RGBA), where a tile marches on for its live pixels past the slabs at
    which its frozen ones stopped accumulating; the resume cases
    march the two z-segments of the bake in march order, each from the
    state the one before left (acc_init)."""
    from volrend_torch.models.data_format import BasisType
    from volrend_torch.ops import slab_grad
    grid, cams = group_geom
    (perm, flip), cam = sorted(cams.items())[len(variant) % len(cams)]
    fmt = "RGBA" if variant.startswith("RGBA") else "SH"
    nb = -1 if fmt == "RGBA" else int(variant.split("-")[0][2:])
    resume = variant.endswith("-resume")
    D = 4 if fmt == "RGBA" else 3 * nb + 1
    G, gi = grid.G, 40
    dev = grid.data.device
    options = {} if fmt == "RGBA" else dict(
        rot_dirs=(0.3, -0.2, 0.5), render_bbox=(0.1,) * 3 + (0.85,) * 3,
        basis_minmax=(0, max(0, nb - 2)))
    opt = OPT.replace(renormalize=False, **options)
    assert float(opt.stop_thresh) == 1e-2
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, 48, 48, opt, gi)
    cfg = slab_grad.SlabCfg(G=G, gi=gi, D=D, bd=nb, fmt=int(BasisType[fmt]),
                            perm=perm, flip=flip, ids=(), opt=opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    st = slab_grad._kernel_statics(cfg)
    st.pop("flip")
    planar = _view(_two_cubes(G, D, dtype, dev, seed=nb + 7), perm)
    qs = torch.ones(D, device=dev)
    slab_march.march_slabs.train_variants = {}
    n_seg = 2 if resume else 1
    Gl = G // n_seg
    lids = tuple(range(Gl - 1, -1, -1) if flip else range(Gl))
    acc = None
    for i in (range(n_seg - 1, -1, -1) if flip else range(n_seg)):
        seg = slab_grad.zsegment(planar, i, Gl) if resume else planar
        zbase = i * Gl / G if resume else None
        got = slab_march.march_slabs(
            seg, params, qs, zb, G, gi, D, nb, perm, slab_ids=lids,
            flip=flip, dir_win=False, train=True, z_base=zbase,
            acc_init=acc, **st)
        m = slab_march.march_inputs(seg, params, zb, G, gi, lids, 4, None,
                                    zbase)
        ref = slab_march.march_slabs_ref(
            seg, qs, D=D, bd=nb, flip=flip,
            acc_init=None if acc is None else acc.clone(), **st, **m)
        torch.cuda.synchronize()
        _freeze_flip_ok(got, ref)
        acc = got
    T = acc[0, 3]
    frozen = (T < opt.stop_thresh).reshape(gi // 4, 4, gi // 8, 8)
    mixed = frozen.any(3).any(1) & ~frozen.all(3).all(1)
    assert bool(mixed.any()), variant
    name = slab_march.train_variant(
        slab_march.MarchMode(cfg.fmt, None, False, st["rot"],
                             st["bbox_full"], st["basis_lo"],
                             st["basis_hi"]), nb, dtype == torch.float32,
        resume)
    assert slab_march.march_slabs.train_variants.get(name) == 1, (
        name, slab_march.march_slabs.train_variants)


def test_train_variants_refuse_what_is_not_built(card, group_geom):
    """More than 25 lobes raises ValueError, as on the display path; the
    option variant is the only one an SG tree takes (the entry refuses an
    SG launch without it), and only the "_lobes" library holds it."""
    from volrend_torch import kernels
    with pytest.raises(ValueError, match="1..25"):
        _train_variant_case(group_geom, "SG", 26, torch.float32)
    out = (ctypes.c_int * 11)()
    lobes = slab_march.train_lib("slab_march", 2, True)
    assert lobes.vt_march_slabs_info(9, 1, 2, 0, out) != 0
    assert lobes.vt_march_slabs_info(9, 1, 2, 1, out) == 0
    # each library holds its own set: the defaults' refuses an SG variant
    assert kernels.lib("slab_march").vt_march_slabs_info(9, 1, 2, 1,
                                                         out) != 0


@pytest.mark.parametrize("D", [4, 10, 19, 76])
def test_bake_kernel_any_width(card, D):
    """The bake kernel at D = 4 (RGBA and SH1), 10 and 19 (SG3 and SG6,
    run-time widths: 40 and 76 bytes a record) and 76 (SH25, ASG25) equals
    its plain version bit for bit, its live bits equal live_bits_ref and
    its gradient autograd's through the plain version (G = 32)."""
    tree = make_test_tree(max_depth=4, basis_dim=1, seed=D,
                          sigma_scale=60.0)
    tdev = dataclasses.replace(tree.to_device(lut_depth=None, device=card),
                               data_dim=D)
    bmap = _bake_case(tdev, D, grad=True)
    assert bmap.D == D


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("fmt,nb,options", [
    ("SG", 3, {}), ("ASG", 5, {}), ("SG", 25, {}), ("RGBA", -1, {}),
    ("SH", 9, dict(rot_dirs=(0.3, -0.2, 0.5), basis_minmax=(0, 3),
                   render_bbox=(0.2,) * 3 + (0.8,) * 3)),
], ids=["SG3", "ASG5", "SG25", "RGBA", "SH9-options"])
def test_frame_trainer_formats_on_card(card, fmt, nb, options, lean):
    """FrameTrainer on SG, ASG and RGBA trees and an SH tree with rot_dirs,
    a basis window and a render_bbox (G = 16 solid scene, its leaves read
    as the format), default and lean: each step runs one launch of BK, the
    bits mode, and kernels M and M-bwd in the tree's variant (bf16 for the
    lean trainer), and three steps descend."""
    from volrend_torch.models.data_format import BasisType
    from volrend_torch.ops import slab_grad
    from volrend_torch.train import FrameTrainer
    tree = make_solid_tree(max_depth=3, basis_dim=25 if fmt == "SG" else 9,
                           seed=7)
    tdev = tree.to_device(lut_depth=None, device=card)
    bd, D = tdev.basis_dim, tdev.data_dim
    if fmt in ("SG", "ASG"):
        keep = [c * bd + k for c in range(3) for k in range(nb)] + [D - 1]
        tdev = dataclasses.replace(
            tdev, data=tdev.data[:, keep].contiguous(), data_dim=3 * nb + 1,
            basis_dim=nb, fmt=BasisType[fmt],
            extra=torch.as_tensor(_lobes(fmt, nb, 4), device=card))
    elif fmt == "RGBA":
        rows = torch.cat([torch.sigmoid(tdev.data[:, 0:3 * bd:bd].float()),
                          tdev.data[:, D - 1:D].float()], 1)
        tdev = dataclasses.replace(tdev, data=rows.contiguous(), data_dim=4,
                                   basis_dim=-1, fmt=BasisType.RGBA)
    tr = FrameTrainer(tdev, opt=OPT.replace(**options), lr=5e-2, gi=48,
                      lean=lean)
    cam = _cams([(np.cos(0.25), np.sin(0.25), 0.45)], fx=200.0)[0]
    tgt = torch.full((H, W, 4), 0.5, device=card)
    name = (f"{fmt}-{'bf16' if lean else 'f32'}"
            + ("-opt" if fmt == "SH" else ""))
    slab_march.march_slabs.train_variants = {}
    slab_march.march_slabs_bwd.variants = {}
    k0 = slab_grad.bake_from_pyramid.launches
    l0 = slab_march.march_occupancy.launches_live
    losses = [tr.step_frame(cam, tgt) for _ in range(3)]
    assert slab_march.march_slabs.train_variants == {name: 3}
    assert slab_march.march_slabs_bwd.variants == {name: 3}
    assert slab_grad.bake_from_pyramid.launches == k0 + 3
    assert slab_march.march_occupancy.launches_live == l0 + 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# Kernel W's mesh-background mode, kernel M's display knobs (per-slab view
# directions, bf16 SH shading) and the default instantiations they must
# leave as they were; codebook-quantized leaves on the card
# ---------------------------------------------------------------------------

#: kernel W's no-mesh instantiations before the mesh mode was added (commit
#: fb76777, NVIDIA H100 80GB HBM3; read by ``python
#: volrend_torch/probes/display_info.py --root <that checkout>``): per
#: (By, Bx, Wy, Wx, RGBA8), (blocks per SM, registers, spill store bytes)
DEFAULT_W_INFO = {
    (4, 4, 5, 5, 1): (8, 64, 0), (4, 4, 5, 5, 0): (7, 70, 0),
    (2, 2, 4, 4, 1): (10, 44, 0), (2, 2, 4, 4, 0): (10, 44, 0),
    (2, 4, 4, 5, 1): (5, 96, 0), (2, 4, 4, 5, 0): (5, 96, 0),
}

#: kernel M's 76 display instantiations (NVIDIA H100 80GB HBM3; read by
#: ``python volrend_torch/probes/display_info.py``): per instantiation,
#: (blocks per SM, registers, spill bytes, static shared bytes). The SH
#: int8 defaults keep the values they had before the display knobs (and
#: their machine code: probes/display_sass); the SH option and RGBA
#: variants moved by 0-9 registers when depth mode left them for a variant
#: of its own; SG and ASG (one instantiation for every lobe count) spill
#: nothing since their redesign; bf16 shading took a variant of its own
#: without options at both tile heights (``-bf16shade``; the option
#: variant is ``-bf16shade-opt``) and the packed bf16 basis, and it and the
#: bf16 payload's SH defaults take each job's walk once; RGBA without a
#: bbox took a kernel of its own (``rgba_kernel``, 288 threads a block),
#: read at two blocks an SM and, ``-b3``, at three in its 72 KB budget
#: (``display_info.info_smem``): every one within 128 registers, no
#: spills, two blocks an SM or more
DEFAULT_DISPLAY_INFO = {
    "SH1-int8-r1": (2, 100, 0, 144),
    "SH1-int8-r2": (2, 113, 0, 144),
    "SH1-bf16-r1": (2, 124, 0, 144),
    "SH1-bf16-r2": (2, 128, 0, 144),
    "SH4-int8-r1": (2, 110, 0, 192),
    "SH4-int8-r2": (2, 122, 0, 192),
    "SH4-bf16-r1": (2, 126, 0, 176),
    "SH4-bf16-r2": (2, 128, 0, 176),
    "SH9-int8-r1": (2, 117, 0, 240),
    "SH9-int8-r2": (2, 122, 0, 240),
    "SH9-bf16-r1": (2, 126, 0, 240),
    "SH9-bf16-r2": (2, 123, 0, 240),
    "SH16-int8-r1": (2, 124, 0, 336),
    "SH16-int8-r2": (2, 121, 0, 336),
    "SH16-bf16-r1": (2, 126, 0, 320),
    "SH16-bf16-r2": (2, 125, 0, 320),
    "SH25-int8-r1": (2, 126, 0, 432),
    "SH25-int8-r2": (2, 127, 0, 432),
    "SH25-bf16-r1": (2, 126, 0, 432),
    "SH25-bf16-r2": (2, 128, 0, 432),
    "SH1-int8-opt-r1": (2, 102, 0, 192),
    "SH1-bf16-opt-r1": (2, 120, 0, 176),
    "SH4-int8-opt-r1": (2, 114, 0, 224),
    "SH4-bf16-opt-r1": (2, 120, 0, 224),
    "SH9-int8-opt-r1": (2, 114, 0, 288),
    "SH9-bf16-opt-r1": (2, 120, 0, 272),
    "SH16-int8-opt-r1": (2, 121, 0, 368),
    "SH16-bf16-opt-r1": (2, 122, 0, 368),
    "SH25-int8-opt-r1": (2, 121, 0, 480),
    "SH25-bf16-opt-r1": (2, 119, 0, 464),
    "SH1-int8-bf16shade-opt-r1": (2, 102, 0, 208),
    "SH1-bf16-bf16shade-opt-r1": (2, 120, 0, 192),
    "SH4-int8-bf16shade-opt-r1": (2, 114, 0, 272),
    "SH4-bf16-bf16shade-opt-r1": (2, 117, 0, 272),
    "SH9-int8-bf16shade-opt-r1": (2, 115, 0, 400),
    "SH9-bf16-bf16shade-opt-r1": (2, 120, 0, 384),
    "SH16-int8-bf16shade-opt-r1": (2, 108, 0, 560),
    "SH16-bf16-bf16shade-opt-r1": (2, 96, 0, 560),
    "SH25-int8-bf16shade-opt-r1": (2, 107, 0, 784),
    "SH25-bf16-bf16shade-opt-r1": (2, 114, 0, 768),
    "SH1-int8-bf16shade-r1": (2, 118, 0, 176),
    "SH1-int8-bf16shade-r2": (2, 122, 0, 176),
    "SH1-bf16-bf16shade-r1": (2, 124, 0, 160),
    "SH1-bf16-bf16shade-r2": (2, 128, 0, 160),
    "SH4-int8-bf16shade-r1": (2, 123, 0, 240),
    "SH4-int8-bf16shade-r2": (2, 126, 0, 240),
    "SH4-bf16-bf16shade-r1": (2, 128, 0, 240),
    "SH4-bf16-bf16shade-r2": (2, 127, 0, 240),
    "SH9-int8-bf16shade-r1": (2, 119, 0, 368),
    "SH9-int8-bf16shade-r2": (2, 117, 0, 368),
    "SH9-bf16-bf16shade-r1": (2, 127, 0, 352),
    "SH9-bf16-bf16shade-r2": (2, 127, 0, 352),
    "SH16-int8-bf16shade-r1": (2, 110, 0, 528),
    "SH16-int8-bf16shade-r2": (2, 117, 0, 528),
    "SH16-bf16-bf16shade-r1": (2, 120, 0, 528),
    "SH16-bf16-bf16shade-r2": (2, 123, 0, 528),
    "SH25-int8-bf16shade-r1": (2, 116, 0, 752),
    "SH25-int8-bf16shade-r2": (2, 125, 0, 752),
    "SH25-bf16-bf16shade-r1": (2, 116, 0, 736),
    "SH25-bf16-bf16shade-r2": (2, 124, 0, 736),
    "SG-int8-opt-r1": (2, 117, 0, 880),
    "SG-int8-opt-r2": (2, 124, 0, 880),
    "SG-bf16-opt-r1": (2, 124, 0, 880),
    "SG-bf16-opt-r2": (2, 128, 0, 880),
    "ASG-int8-opt-r1": (2, 128, 0, 1680),
    "ASG-int8-opt-r2": (2, 128, 0, 1680),
    "ASG-bf16-opt-r1": (2, 126, 0, 1680),
    "ASG-bf16-opt-r2": (2, 128, 0, 1680),
    "RGBA-int8-opt-r1": (2, 96, 0, 192),
    "RGBA-bf16-opt-r1": (2, 120, 0, 176),
    "RGBA-int8-r1": (2, 95, 0, 720),
    "RGBA-bf16-r1": (2, 96, 0, 784),
    "RGBA-int8-b3-r1": (3, 72, 0, 720),
    "RGBA-bf16-b3-r1": (3, 72, 0, 784),
    "depth-int8-r1": (2, 119, 0, 144),
    "depth-bf16-r1": (2, 124, 0, 128),
}


def _mesh_case(device, P, seed=5):
    """A seeded (P, H, W, 4) f16 mesh background: half the pixels hit,
    the mesh colours in [0, 1]."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(1.0, 3.0, (P, H, W)).astype(np.float32)
    dist[rng.uniform(size=dist.shape) < 0.5] = np.inf
    rgb = rng.uniform(0.0, 1.0, (P, H, W, 3)).astype(np.float32)
    return display_warp.mesh_background(dist, rgb, P, H, W, device)


@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("level", LEVELS + (((2, 4), (4, 5)),))
def test_warp_display_mesh_matches_plain(grids, out_dtype, level):
    """W's mesh mode at both production levels and a generic one, on two
    of three poses in place: against its plain version (uint8 within one
    quantum, f32 within 1e-5), alpha 1 on every hit pixel, counted apart
    from the no-mesh launches, the third pose's slot untouched."""
    _, g = grids
    B, win = level
    _, prm, inter = _warp_case(g)
    mesh = _mesh_case(g.data.device, 3)
    sel = torch.tensor([2, 0], dtype=torch.int32, device=g.data.device)
    fill = 7 if out_dtype == torch.uint8 else -3.0
    out = torch.full((3, H, W, 4), fill, dtype=out_dtype,
                     device=g.data.device)
    wd = display_warp.warp_display
    n0 = (wd.launches, wd.mesh_launches, wd.mesh_poses)
    got = wd(inter, prm, sel, out.clone(), B, win, GI, 1.0, mesh)
    assert (wd.launches, wd.mesh_launches, wd.mesh_poses) == (
        n0[0], n0[1] + 1, n0[2] + 2)
    assert torch.equal(got[1], out[1])
    want = display_warp.warp_display_ref(inter, prm, sel, out.clone(), B,
                                         win, GI, 1.0, mesh)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= (1.0 if out_dtype == torch.uint8 else 1e-5)
    hit = mesh[..., 3] > 0.5
    one = 255 if out_dtype == torch.uint8 else 1.0
    for p in (0, 2):
        assert bool(torch.all(got[p, ..., 3][hit[p]] == one))


def test_warp_display_default_launch_info(card):
    """W's no-mesh instantiations keep the registers and spills they had
    before the mesh mode (DEFAULT_W_INFO), with their blocks per SM; the
    mesh ones do not spill."""
    from volrend_torch import kernels
    assert DEFAULT_W_INFO
    lib = kernels.lib("warp_display")
    for (by, bx, wy, wx, u8), want in DEFAULT_W_INFO.items():
        for mesh in (0, 1):
            out = (ctypes.c_int * 4)()
            kernels.check(lib.vt_warp_display_info(by, bx, wy, wx, u8, mesh,
                                                   out), "warp_display")
            if mesh:
                assert out[0] > 0 and out[2] == 0, list(out)
            else:
                assert tuple(out[:3]) == tuple(want), (by, bx, u8,
                                                       list(out))


def test_default_display_instantiations_keep_their_launch(card):
    """Kernel M's 76 display instantiations keep the blocks per SM,
    registers, spills and static shared memory of DEFAULT_DISPLAY_INFO."""
    from volrend_torch.probes import display_info
    from volrend_torch import kernels
    assert len(DEFAULT_DISPLAY_INFO) == 76
    lib = kernels.lib("slab_march_display")
    rows = {v[0]: v[1:] for v in display_info.M_VARIANTS}
    for key, want in DEFAULT_DISPLAY_INFO.items():
        bd, r, fmt, bf16, opt = rows[key]
        out = (ctypes.c_int * 4)()
        kernels.check(lib.vt_march_display_info(
            bd, r, fmt, bf16, opt, display_info.info_smem(opt), out),
            "slab_march_display")
        assert list(out) == list(want), (key, list(out))


#: the bf16-shading variants against their plain version: the kernel's
#: view directions (f32, then rounded to bf16) differ from the plain
#: version's in the last f32 bit, which can flip a bf16 rounding of a
#: direction, a basis plane or a sum
TOL_BF16_SHADE = 5e-3


@pytest.mark.parametrize("key", [("SH", "int8"), ("SH", "f16"),
                                 ("SG", "int8"), ("ASG", "f16")])
def test_display_dir_slab_matches_plain(format_grids, key):
    """Per-slab view directions (dir_win=False) on both payloads and the
    lobe formats: one-slab windows of the format's own variant (the SH
    default's for SH) against the plain version, named ``-dirslab``."""
    g = format_grids[key]
    _, variant = _variant_vs_plain(g, OPT, dir_win=False)
    assert variant == (f"{key[0]}-{'bf16' if key[1] == 'f16' else 'int8'}"
                       "-dirslab"), variant


@pytest.mark.parametrize("options", ["none", "rot", "window"])
@pytest.mark.parametrize("dt", ["int8", "f16"])
def test_display_bf16_shade_matches_plain(format_grids, dt, options):
    """bf16 SH shading on both payloads, alone and with options, against
    the plain version's bf16 rounding (TOL_BF16_SHADE); with per-slab
    directions too, and an SG tree shades in f32 as without the knob."""
    g = format_grids[("SH", dt)]
    opt = OPT.replace(**_OPTIONS[options])
    _, variant = _variant_vs_plain(g, opt, shade_bf16=True,
                                   tol=TOL_BF16_SHADE)
    assert "-bf16shade" in variant, variant
    _, variant = _variant_vs_plain(g, opt, shade_bf16=True, dir_win=False,
                                   tol=TOL_BF16_SHADE)
    assert variant.endswith("-bf16shade-dirslab"), variant
    _, variant = _variant_vs_plain(format_grids[("SG", dt)], opt,
                                   shade_bf16=True)
    assert "bf16shade" not in variant, variant


def _no_option_launch(g, case, rows, shade_bf16):
    """SH without options, with or without bf16 shading, at ``rows`` pixel
    rows a thread on the display case ``case``: (acc, plain version's)."""
    pay, params, zb, ids, perm, flip, crop = case
    m = slab_march.march_inputs(pay, params, zb, g.G, GI, ids, 4, crop)
    cfg = dict(slab_march.display_config(
        params.shape[0], GI, len(m["wins"]), pay.shape[1], 132,
        esz=pay.element_size()), rows=rows)
    acc = slab_march._display_launch(
        pay, g.qscale, m["params"], m["zb"], m["wins"], m["masks"], g.G, GI,
        g.basis_dim, m["K"], flip, m["y0"], m["x0"], cfg,
        slab_march.MarchMode(bf16_shade=shade_bf16))
    ref = slab_march.march_slabs_ref(pay, g.qscale, D=g.data_dim,
                                     bd=g.basis_dim, flip=flip, dir_win=True,
                                     bf16_shade=shade_bf16, **m)
    torch.cuda.synchronize()
    return acc, ref


@pytest.mark.parametrize("crop", [None, (2, 28, 8, 24)])
@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("dt", ["int8", "f16"])
@pytest.mark.parametrize("shade_bf16", [False, True])
def test_display_no_option_variants_match_plain(format_grids, shade_bf16, dt,
                                                rows, crop):
    """SH without options, with and without bf16 shading, on both payloads
    at both tile heights (past a crop's edges too; the int8 crop's rows
    are staged by element copies) on the steep fx = 80 pose (footprints in
    several pieces), against the plain version (TOL_BF16_SHADE, TOL_M),
    named by display_variant; each instantiation two blocks an SM, no
    spills, at most 128 registers."""
    from volrend_torch import kernels
    g = format_grids[("SH", dt)]
    case = _display_case(g, [(1.0, 0.25, 0.35), (1.0, 0.1, 0.45)], fx=80.0,
                         crop=crop)
    acc, ref = _no_option_launch(g, case, rows, shade_bf16)
    _agree(acc, ref, TOL_BF16_SHADE if shade_bf16 else TOL_M)
    want = f"SH-{'bf16' if dt == 'f16' else 'int8'}" + (
        "-bf16shade" if shade_bf16 else "")
    assert slab_march.march_slabs.display["variant"] == want
    assert slab_march.march_slabs.display["opt"] == (2 if shade_bf16 else 0)
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib("slab_march_display").vt_march_display_info(
        g.basis_dim, rows, 1, int(dt == "f16"), 2 if shade_bf16 else 0,
        slab_march._DISPLAY_SMEM, out), "slab_march_display")
    assert out[0] == 2 and out[2] == 0 and out[1] <= 128, list(out)


@pytest.mark.parametrize("dt", ["int8", "f16"])
@pytest.mark.parametrize("shade_bf16", [False, True])
def test_display_no_option_variants_batch_equals_single_poses(
        format_grids, shade_bf16, dt):
    """A batch of three poses against the same poses launched one at a
    time, within 1e-6, with and without bf16 shading on both payloads."""
    g = format_grids[("SH", dt)]
    backs = [(1.0, 0.25, 0.35), (1.0, 0.1, 0.45), (1.0, 0.3, 0.2)]
    pay, params, zb, ids, perm, flip, _ = _display_case(g, backs)

    def run(prm, z):
        return slab_march.march_slabs(
            pay, prm, g.qscale, z, g.G, GI, g.data_dim, g.basis_dim, perm,
            slab_ids=ids, sig2=g.quantized, flip=flip, bbox_full=True,
            dir_win=True, shade_bf16=shade_bf16)

    whole = run(params, zb)
    for i in range(len(backs)):
        one = run(params[i:i + 1], zb[i:i + 1])
        assert float((one[0] - whole[i]).abs().max()) <= 1e-6


def test_quant_leaves_fetch_rows_card_matches_cpu(card):
    """QuantLeaves.fetch_rows on the card equals the CPU's bit for bit,
    and the host decode's rows."""
    from volrend_torch.compress import compress_tree
    from volrend_torch.models.n3tree import N3Tree
    from volrend_torch.models.quantized import (load_quantized,
                                                to_device_quantized)
    import io
    tree = make_test_tree(max_depth=3, basis_dim=16, seed=5,
                          sigma_scale=60.0)
    buf = io.BytesIO()
    tree.save_npz(buf, compressed=False)
    buf.seek(0)
    with np.load(buf) as f:
        z = compress_tree(dict(f.items()), bits=10)
    host = N3Tree()
    host.load_npz(z)
    qt = load_quantized(z)
    idx = np.random.default_rng(0).integers(0, host.n_cells, 4096)
    rows = []
    for dev in ("cpu", card):
        leaves = to_device_quantized(qt, device=dev).data
        rows.append(leaves.fetch_rows(torch.as_tensor(idx, device=dev))
                    .cpu())
    assert torch.equal(rows[0], rows[1])
    want = host.data.reshape(-1, host.data_dim)[idx]
    assert np.array_equal(rows[0].numpy(), want)


# ---------------------------------------------------------------------------
# z-segments (kernel M's two modes and M-bwd) and the parallel layer
# ---------------------------------------------------------------------------

def test_zsegments_match_plain_and_whole(card):
    """Kernel M's display mode over 2 and 4 z-segments of an int8 grid, and
    its training mode and M-bwd over 2 segments of a bake
    (slab_grad.zsegment; the coarse occupancy the whole one's slice), each
    launch with its z_base and the upstream state (acc_init, which takes
    the resume variants; M-bwd's state_init from the forward's parts)
    against its plain version on the same CUDA tensors; the chained
    segments equal the whole-grid launch, and the segments' cotangent the
    whole grid's (relative L2 < 1e-5)."""
    from volrend_torch import train
    from volrend_torch.ops import slab_grad
    from volrend_torch.parallel import dist as pdist
    tdev = make_test_tree(max_depth=4, basis_dim=4, seed=5,
                          sigma_scale=60.0).to_device(lut_depth=None,
                                                      device=card)
    grid = dense_grid.bake_dense(tdev, dtype="int8")
    cam = Camera.from_vectors(center=(2.4, 0.5, 0.7),
                              v_back=(0.92, 0.2, 0.27), width=W, height=H,
                              fx=200.0)
    opt = RenderOptions(max_steps=512, stop_thresh=0.0, renormalize=False)
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, W, H)
    g = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                              flip, W, H, opt, GI)
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip, opt)
    G, D, bd = grid.G, grid.data_dim, grid.basis_dim
    args = (grid.qscale, zb, G, GI, D, bd, perm)
    kw = dict(sig2=True, flip=flip, bbox_full=True, dir_win=True)
    whole = slab_march.march_slabs(
        slab_render._permuted_grid(grid, perm), params, *args,
        slab_ids=tuple(range(G - 1, -1, -1) if flip else range(G)), **kw)
    for n in (2, 4):
        Gl = G // n
        lids = tuple(range(Gl - 1, -1, -1) if flip else range(Gl))
        acc = None
        for i in (range(n - 1, -1, -1) if flip else range(n)):
            pay = pdist._zsegment(grid, perm, Gl, i)
            a = slab_march.march_slabs(pay, params, *args, slab_ids=lids,
                                       z_base=i * Gl / G, acc_init=acc,
                                       **kw)
            m = slab_march.march_inputs(pay, params, zb, G, GI, lids, 4,
                                        None, i * Gl / G)
            ap = slab_march.march_slabs_ref(
                pay, grid.qscale, D=D, bd=bd, flip=flip, dir_win=True,
                acc_init=None if acc is None else acc.clone(), **m)
            _agree(a, ap)
            acc = a
        assert float((acc - whole).abs().max()) <= TOL_M
    assert slab_march.march_slabs.variants.get("SH-int8-opt-resume")
    tr = train.FrameTrainer(tdev, opt=opt, lr=1e-2, gi=GI)
    with torch.no_grad():
        bake, live = slab_grad.bake_from_pyramid(
            tuple(tr.pyramid), tr.bmap, live_thresh=opt.sigma_thresh)
    perm, flip = tr._group(cam)
    geom = slab_render.FrameGeom(tr.grid, cam.transform, cam.fx, cam.fy,
                                 perm, flip, W, H, tr.opt, GI)
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=D, bd=bd, fmt=int(tr.grid.fmt),
                            perm=perm, flip=flip, ids=(), opt=tr.opt)
    prm = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb1 = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    q = (perm[0], 3, perm[1], perm[2])
    qs = torch.ones(D, device=card)
    st = slab_grad._kernel_statics(cfg)
    st.pop("flip")
    occ = slab_march.march_occupancy(bake.permute(*q), prm.cpu(), qs,
                                     live=live, perm=perm)
    tkw = dict(flip=flip, dir_win=False, train=True, **st)
    wacc = slab_march.march_slabs(
        bake.permute(*q), prm, qs, zb1, G, GI, D, bd, perm,
        slab_ids=tuple(range(G - 1, -1, -1) if flip else range(G)),
        occupancy=occ, **tkw)[0]
    gacc4 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, GI, GI)).astype(np.float32), device=card)
    wg = slab_march.march_slabs_bwd(bake.permute(*q), prm[0], qs, zb1[0],
                                    gacc4, wacc, G, GI, D, bd, perm,
                                    flip=flip, occupancy=occ, **st)
    Gl = G // 2
    order = [1, 0] if flip else [0, 1]
    lids = tuple(range(Gl - 1, -1, -1) if flip else range(Gl))
    acc, parts, segs = None, {}, {}
    for i in order:
        seg = slab_grad.zsegment(bake.permute(*q), i, Gl)
        socc = occ[i * Gl:(i + 1) * Gl]
        a = slab_march.march_slabs(seg, prm, qs, zb1, G, GI, D, bd, perm,
                                   slab_ids=lids, z_base=i * Gl / G,
                                   acc_init=acc, occupancy=socc, **tkw)
        m = slab_march.march_inputs(seg, prm, zb1, G, GI, lids, 4, None,
                                    i * Gl / G)
        ap = slab_march.march_slabs_ref(
            seg, qs, D=D, bd=bd, flip=flip,
            acc_init=None if acc is None else acc.clone(),
            **{k: v for k, v in st.items() if k != "extra"}, **m)
        _agree(a, ap)
        acc = a
        parts[i] = slab_march.march_slabs(
            seg, prm, qs, zb1, G, GI, D, bd, perm, slab_ids=lids,
            z_base=i * Gl / G, occupancy=socc, **tkw)[0]
        segs[i] = (seg, socc)
    assert float((acc[0] - wacc).abs().max()) <= TOL_M
    assert slab_march.march_slabs.train_variants.get("SH-f32-opt-resume")
    states = slab_grad.segment_states(torch.stack([parts[0], parts[1]]),
                                      gacc4, order)
    gs = []
    for i in range(2):
        seg, socc = segs[i]
        gk = slab_march.march_slabs_bwd(
            seg, prm[0], qs, zb1[0], gacc4, wacc, G, GI, D, bd, perm,
            flip=flip, occupancy=socc, z_base=i * Gl / G,
            state_init=states[i], **st)
        bprm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
            prm[0], zb1[0], gacc4, wacc, G, GI, states[i], i * Gl / G)
        gp = slab_march.march_slabs_bwd_ref(seg, qs, bprm, bzb, bgacc, aux,
                                            G, GI, D, bd, flip)
        _bwd_agrees(gk, gp, torch.float32)
        gs.append(gk.permute(0, 2, 3, 1))
    full = torch.cat(gs).double()
    wgs = wg.permute(0, 2, 3, 1).double()
    rel = float((full - wgs).norm() / wgs.norm())
    assert rel < 1e-5, rel


def test_dryrun_multichip_on_card(card):
    """The parallel layer's dry run with two gloo ranks sharing the card:
    the ray-sharded step, the leaf-sharded render and step, a pose-sharded
    frame step, a z-sharded render and a z-sharded training step equal to
    the unsharded one."""
    from volrend_torch.parallel import dryrun
    res = dryrun.dryrun_multichip(2, "cuda", timeout_s=300)
    assert all(np.isfinite(v) for v in res.values()), res
