"""The training march's payload in the bake's own layout
(``volrend_torch/ops/slab_march.py``, ``slab_grad._MarchKernel``) on the
CPU: the element strides the wrapper hands the kernels index the bake as
the planar copy it replaces, the plain versions march an f32 view as they
march its bf16 planar copy, and the cotangent comes back in the bake's
layout. Needs neither JAX nor a card."""

import numpy as np
import pytest
import torch

from volrend_torch.models.synthetic import make_test_tree
from volrend_torch.ops import dense_grid, slab_grad, slab_march, slab_render
from volrend_torch.utils.options import RenderOptions

from _torch_perms import group_cams

torch.set_num_threads(1)

PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]
W = H = 24
GI = 20
OPT = RenderOptions(max_steps=512).replace(renormalize=False)


def _bake(G, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(G, G, G, D)).astype(np.float32)
                           ).to(dtype)


def _parent_planar(bake, perm):
    """The bf16 planar copy the training step made before the kernels read
    the bake's own tensor (one copy_ from the permuted view)."""
    view = bake.permute(perm[0], 3, perm[1], perm[2])
    return torch.empty(view.shape, dtype=torch.bfloat16).copy_(view)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("perm", PERMS)
def test_view_strides_index_the_bake_as_the_planar_copy(perm, flip, dtype):
    """The (slab, row, column) element strides the wrappers hand the kernels
    (_record_strides of the render path's view), applied with channel
    stride 1 to the bake's storage through as_strided and walked in the
    kernel's slab order (march_slab_ids), give the parent's bf16 planar
    copy bit for bit (f32 rounded to nearest even, as the kernels'
    __float2bfloat16_rn); each voxel's D values are one contiguous
    record."""
    G, D, K = 6, 13, 2
    bake = _bake(G, D, dtype)
    ss, sr, sc = slab_march._record_strides(
        bake.permute(perm[0], 3, perm[1], perm[2]), bake=True)
    view = torch.as_strided(bake, (G, D, G, G), (ss, 1, sr, sc))
    bake_strides = (G * G * D, G * D, D)
    assert (ss, sr, sc) == tuple(bake_strides[a] for a in perm)
    slabs = tuple(range(G - 1, -1, -1) if flip else range(G))
    wins, masks = slab_march._window_masks(slabs, K)
    ids = slab_march.march_slab_ids(wins, masks, K, flip)
    assert ids == list(slabs)
    planar = _parent_planar(bake, perm)
    idx = torch.tensor(ids)
    assert torch.equal(view[idx].to(torch.bfloat16), planar[idx])
    # the record of voxel (s, r, c): D consecutive elements of the storage
    flat = bake.reshape(-1)
    s, r, c = 4, 1, 3
    off = s * ss + r * sr + c * sc
    assert torch.equal(flat[off:off + D], view[s, :, r, c])


def test_record_strides_refuse_a_planar_payload():
    """The kernels take a view with channel stride 1; a channel-planar
    contiguous payload, or (for the backward) a view that is not a permuted
    bake, is refused before any launch."""
    bake = _bake(4, 13, torch.float32)
    with pytest.raises(ValueError, match="channel stride 1"):
        slab_march._record_strides(_parent_planar(bake, (0, 1, 2)))
    part = bake[:, :2].permute(0, 3, 1, 2)
    slab_march._record_strides(part)
    with pytest.raises(ValueError, match="permuted"):
        slab_march._record_strides(part, bake=True)


@pytest.fixture(scope="module")
def scene():
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5, sigma_scale=60.0)
    grid = dense_grid.bake_dense(tree.to_device(lut_depth=None,
                                                device="cpu"))
    return grid, group_cams(grid, W, H, 30.0)


def _inputs(grid, cam, perm, flip):
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, W, H, OPT, GI)
    ids = tuple(range(grid.G - 1, -1, -1) if flip else range(grid.G))
    cfg = slab_grad.SlabCfg(G=grid.G, gi=GI, D=grid.data_dim,
                            bd=grid.basis_dim, fmt=int(grid.fmt), perm=perm,
                            flip=flip, ids=ids, opt=OPT)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)[0]
    zb = torch.stack([geom.z_lo_pix[0], geom.z_hi_pix[0]])
    return cfg, params, zb


@pytest.mark.parametrize("group", [((0, 1, 2), False), ((2, 1, 0), True),
                                   ((1, 2, 0), False)])
def test_plain_versions_march_the_f32_view_as_its_bf16_copy(scene, group):
    """march_slabs and march_slabs_bwd on the bake's f32 view equal the
    same functions on the parent's bf16 planar copy bit for bit (both round
    to bf16 as they read), and the cotangent takes the view's strides."""
    grid, cams = scene
    perm, flip = group
    cfg, params, zb = _inputs(grid, cams[group], perm, flip)
    bake = grid.data.float()
    view = bake.permute(perm[0], 3, perm[1], perm[2])
    planar = _parent_planar(bake, perm)
    qs = torch.ones(cfg.D)
    kw = dict(slab_ids=cfg.ids, flip=flip, bbox_full=True, dir_win=False,
              train=True)
    accs = [slab_march.march_slabs(p, params[None], qs, zb[None], cfg.G, GI,
                                   cfg.D, cfg.bd, perm, **kw)
            for p in (view, planar)]
    assert torch.equal(accs[0], accs[1])
    assert float(accs[0][0, 3].min()) < 0.9          # the scene was seen
    gacc4 = torch.as_tensor(np.random.default_rng(1).normal(
        size=(4, GI, GI)).astype(np.float32))
    grads = [slab_march.march_slabs_bwd(p, params, qs, zb, gacc4, accs[0][0],
                                        cfg.G, GI, cfg.D, cfg.bd, perm,
                                        flip=flip, bbox_full=True)
             for p in (view, planar)]
    assert grads[0].stride() == view.stride()
    assert grads[1].stride() == planar.stride()
    assert torch.equal(grads[0], grads[1])
    assert float(grads[0].abs().max()) > 0


@pytest.mark.parametrize("grad_bf16", [False, True])
@pytest.mark.parametrize("group", [((0, 2, 1), True), ((1, 0, 2), False)])
def test_march_gradient_has_the_bake_layout(scene, group, grad_bf16):
    """_MarchKernel.backward returns its cotangent through the view's
    strides: the gradient that reaches the bake through the permutation
    back (and, for the lean trainer, the cast to bf16) is contiguous, in
    the primal's dtype, and equals the plain backward's values."""
    grid, cams = scene
    perm, flip = group
    cfg, params, zb = _inputs(grid, cams[group], perm, flip)
    leaf = grid.data.float().clone().requires_grad_(True)
    bake = leaf * 1.0
    seen = []
    bake.register_hook(seen.append)
    pdt = torch.bfloat16 if grad_bf16 else torch.float32
    planar = bake.to(pdt).permute(perm[0], 3, perm[1], perm[2])
    grad_view = []
    planar.register_hook(grad_view.append)
    acc, T = slab_grad._MarchKernel.apply(planar, params, zb, cfg)
    g = torch.as_tensor(np.random.default_rng(2).normal(
        size=(GI, GI, 3)).astype(np.float32))
    (torch.sum(acc * g) + torch.sum(T)).backward()
    (gb,), (gv,) = seen, grad_view
    assert gb.is_contiguous() and gb.dtype == torch.float32
    assert gv.dtype == pdt and gv.stride() == planar.stride()
    acc4 = torch.cat([acc.detach().movedim(-1, 0), T.detach()[None]])
    gacc4 = torch.cat([g.movedim(-1, 0), torch.ones((1, GI, GI))])
    ref = slab_march.march_slabs_bwd(
        _parent_planar(bake.detach().to(pdt), perm), params,
        torch.ones(cfg.D), zb, gacc4, acc4, cfg.G, GI, cfg.D, cfg.bd, perm,
        flip=flip, bbox_full=True, out_dtype=pdt)
    assert torch.equal(gv, ref)
    assert float(gb.abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("perm", [(0, 1, 2), (2, 0, 1), (1, 2, 0)])
def test_occupancy_ref_marks_the_blocks_above_the_threshold(perm, dtype):
    """march_occupancy (its plain version here) against a loop over the
    voxels: bit b of mask (slab, row block, 0) is set exactly when a voxel
    of the 8 x 8 cell block (row block, b) holds sigma above the lowest of
    the poses' thresholds, read as bf16 (G = 20: ragged last blocks)."""
    G, D = 20, 4
    bake = _bake(G, D, dtype, seed=3)
    bake[..., D - 1] = torch.where(bake[..., D - 1] > 2.3,
                                   bake[..., D - 1], -1.0).to(dtype)
    view = bake.permute(perm[0], 3, perm[1], perm[2])
    params = torch.zeros((2, 31))
    params[:, 14] = torch.tensor([2.6, 2.4])
    qs = torch.ones(D)
    occ = slab_march.march_occupancy(view, params, qs)
    assert occ.shape == (G, 3, 1) and occ.dtype == torch.int64
    sig = view[:, D - 1].to(torch.bfloat16).float()
    want = np.zeros((G, 3, 1), np.int64)
    for s, r, c in zip(*np.nonzero((sig > 2.4).numpy())):
        want[s, r // 8, 0] |= 1 << (c // 8)
    assert np.array_equal(occ.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("Gx", [512, 513, 1030])
def test_occupancy_ref_covers_wide_payloads(Gx):
    """Past 512 columns a (slab, row block) takes a 64-bit mask per 64
    column blocks: bit b of word w marks column block 64 w + b, bit 63
    included; the last word is ragged. (The kernels take any width.)"""
    Gz, Gy, D = 2, 9, 4
    pay = torch.full((Gz, Gy, Gx, D), -1.0)
    hits = [(0, 0, 0), (0, 8, 511), (1, 3, 504), (1, 5, Gx - 1),
            (0, 2, min(Gx - 1, 515))]
    for s, r, c in hits:
        pay[s, r, c, D - 1] = 3.0
    view = pay.permute(0, 3, 1, 2)
    params = torch.zeros((1, 31))
    params[0, 14] = 1.0
    occ = slab_march.march_occupancy(view, params, torch.ones(D))
    words = -(-Gx // 512)
    assert occ.shape == (Gz, 2, words)
    want = np.zeros((Gz, 2, words), np.uint64)
    for s, r, c in hits:
        want[s, r // 8, c // 512] |= np.uint64(1) << np.uint64(c // 8 % 64)
    assert np.array_equal(occ.numpy().view(np.uint64), want)
