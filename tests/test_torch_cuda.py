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
