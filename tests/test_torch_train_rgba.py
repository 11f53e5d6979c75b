"""M-bwd's RGBA variant with an f32 cotangent (csrc/slab_march_bwd.cu,
``direct_flush``) on the CPU. The other variants add each tile's voxel sums
[g_sigma, g_srgb x 3] into a buffer that pass 2 maps once through each
voxel's record; RGBA's map is linear in the sums, with coefficients from
the voxel's own record (g_c sigma qs[c] for the colours, (g_sigma + sum_c
g_c rgb_c) qs[3] for sigma, rgb_c = rec[c] qs[c]), so pass 1 maps each
tile's sums itself and adds them into the cotangent, and pass 2 does not
run. Here that flush is mirrored in plain PyTorch, tile by tile (the
kernel's 4 x 8 pixel tiles, cells under the threshold or outside the bbox
left out), and held against ``march_slabs_bwd_ref``'s cotangent. The
kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.models.synthetic import make_test_tree
from volrend_torch.ops import dense_grid, slab_grad, slab_march, slab_render
from volrend_torch.utils.options import RenderOptions

from _torch_perms import group_cams

torch.set_num_threads(1)

W = H = 24
GI = 20
TY, TX = 4, 8       # the training kernels' tile (tmarch::TY, TX)
OPT = RenderOptions(max_steps=512).replace(renormalize=False)
#: the mirror sums the same products in another order (tile by tile)
REL_L2 = 1e-6


@pytest.fixture(scope="module")
def geometry():
    """A G = 8 grid's geometry (its payload is replaced) and its cameras,
    one a (perm, flip) group."""
    tree = make_test_tree(max_depth=3, basis_dim=1, seed=5, sigma_scale=60.0)
    grid = dense_grid.bake_dense(tree.to_device(lut_depth=None,
                                                device="cpu"))
    return grid, group_cams(grid, W, H, 30.0)


def direct_flush(part, rec, qs, thresh, okb):
    """The kernel's flush of one tile's sums ``part`` (4, G, G) into an
    RGBA cotangent (4, G, G), through the slab's records ``rec`` (4, G, G,
    as the march reads them): zero where no sum reached a cell, its sigma
    is under the threshold or it lies outside the bbox mask ``okb``."""
    sigma = rec[3] * qs[3]
    live = (part != 0).any(0) & (sigma > thresh)
    if okb is not None:
        live = live & okb
    c = rec[:3] * qs[:3, None, None]
    out = torch.cat([part[1:] * sigma * qs[:3, None, None],
                     ((part[0] + torch.sum(part[1:] * c, 0)) * qs[3])[None]])
    return torch.where(live[None], out, 0.0)


def tiled_cotangent(planar, qs, prm, zb, gacc4, aux, G, flip, bbox):
    """M-bwd's RGBA cotangent as pass 1 writes it: the reference's suffix
    algebra slab by slab (as march_slabs_bwd_ref computes it), the
    transposed warp of each tile's pixel cotangents alone, each tile's
    sums flushed (direct_flush) and added up."""
    Gz = planar.shape[0]
    cz, cy, cx = prm[0], prm[1], prm[2]
    u0, du, v0, dv = prm[3], prm[4], prm[5], prm[6]
    sigma_thresh, stop_thresh, zbase = prm[14], prm[15], prm[30]
    cell = torch.arange(G, dtype=torch.float32)
    vc = (cell + 0.5) * (1.0 / G)
    ray = torch.arange(GI, dtype=torch.float32)
    ujG, vkG = (u0 + du * ray) * G, (v0 + dv * ray) * G
    hG = 0.5 / G
    okb = None
    if bbox:
        okb = (((vc + hG > prm[16]) & (vc - hG < prm[17]))[:, None]
               & ((vc + hG > prm[18]) & (vc - hG < prm[19]))[None, :])
    zlo, zhi, dtp = zb[0], zb[1], zb[2]
    g_acc, ctot, gT = gacc4[:3], aux[0], aux[1]
    T, A = aux[2].clone(), aux[3].clone()
    out = torch.zeros((Gz, 4, G, G))
    for sid in (range(Gz - 1, -1, -1) if flip else range(Gz)):
        z = (sid + 0.5) / G + zbase
        s0, s1 = z - hG - cz, z + hG - cz
        rec = slab_march._slab_values(planar[sid])
        sigma = slab_march._slab_sigma(rec, qs, 4, False)
        ok = sigma > sigma_thresh
        if okb is not None:
            ok = ok & okb
        sigma = torch.where(ok, sigma, 0.0)
        chans = torch.cat([sigma[None],
                           sigma[None] * rec[:3] * qs[:3, None, None]])
        m_r = slab_march._overlap_mat(cy * G, ujG, s0, s1, cell, G)
        m_c = slab_march._overlap_mat(cx * G, vkG, s0, s1, cell, G)
        warped = m_r @ chans @ m_c.T
        sig_w, srgb_w = warped[0], warped[1:]
        frac = torch.clamp((torch.clamp(zhi, max=z + hG)
                            - torch.clamp(zlo, min=z - hG)) * G, 0.0, 1.0)
        dt = dtp * frac
        tau = sig_w * dt
        att = torch.exp(-tau)
        sig_inv = 1.0 / torch.clamp(sig_w, min=1e-12)
        m = (T >= stop_thresh) & (tau > 0.0)
        w = torch.where(m, T * (1.0 - att), 0.0)
        G_pix = torch.sum(g_acc * srgb_w * sig_inv, 0)
        A = A + w * G_pix
        g_tau = torch.where(m, T * att * G_pix - (ctot - A) - gT, 0.0)
        sum_term = torch.sum(g_acc * w * srgb_w, 0)
        g_sig_w = g_tau * dt - torch.where(sig_w >= 1e-12,
                                           sum_term * sig_inv * sig_inv, 0.0)
        T = torch.where(m, T * att, T)
        gch = torch.cat([g_sig_w[None], g_acc * (w * sig_inv)[None]])
        for j0 in range(0, GI, TY):
            for k0 in range(0, GI, TX):
                part = (m_r[j0:j0 + TY].T @ gch[:, j0:j0 + TY, k0:k0 + TX]
                        @ m_c[k0:k0 + TX])
                out[sid] += direct_flush(part, rec, qs, sigma_thresh, okb)
    return out


@pytest.mark.parametrize("bbox", [False, True])
@pytest.mark.parametrize("group", [0, 3])
def test_direct_flush_writes_the_plain_versions_cotangent(geometry, group,
                                                          bbox):
    """Pass 1's flush of an RGBA cotangent, mirrored tile by tile, gives
    march_slabs_bwd_ref's cotangent on a G = 8 bake from a numpy seed
    (scales other than one, about a fifth of the voxels under the
    threshold, a z-segment's incoming state; with and without a bbox that
    masks voxels): relative L2 below REL_L2, zeros where the plain version
    has them."""
    grid, cams = geometry
    (perm, flip), cam = sorted(cams.items())[group % len(cams)]
    G = grid.G
    opt = OPT.replace(**(dict(render_bbox=(0.2,) * 3 + (0.8,) * 3)
                         if bbox else {}))
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, W, H, opt, GI)
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=4, bd=-1,
                            fmt=int(BasisType.RGBA), perm=perm, flip=flip,
                            ids=(), opt=opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)[0]
    zb = torch.stack([geom.z_lo_pix[0], geom.z_hi_pix[0]])
    rng = np.random.default_rng(group + 11)
    bake = rng.normal(size=(G, G, G, 4)).astype(np.float32)
    bake[..., 3] = rng.uniform(-10.0, 40.0, (G, G, G))
    planar = torch.as_tensor(bake).permute(perm[0], 3, perm[1], perm[2])
    qs = torch.as_tensor(rng.uniform(0.5, 1.5, 4).astype(np.float32))
    gacc4 = torch.as_tensor(rng.normal(size=(4, GI, GI)).astype(np.float32))
    acc4 = torch.as_tensor(rng.uniform(size=(4, GI, GI)).astype(np.float32))
    state = torch.as_tensor(np.stack([
        rng.uniform(0.3, 1.0, (GI, GI)), rng.normal(0.0, 0.5, (GI, GI))
    ]).astype(np.float32))
    prm, bzb, bgacc, aux = slab_march.march_bwd_inputs(params, zb, gacc4,
                                                       acc4, G, GI, state)
    st = slab_grad._kernel_statics(cfg)
    assert st["bbox_full"] != bbox
    mode = slab_march.MarchMode(cfg.fmt, None, False, None, st["bbox_full"])
    ref = slab_march.march_slabs_bwd_ref(planar, qs, prm, bzb, bgacc, aux,
                                         G, GI, 4, -1, flip, mode=mode)
    got = tiled_cotangent(planar, qs, prm, bzb, bgacc, aux, G, flip, bbox)
    assert float(ref.abs().max()) > 0 and got.shape == ref.shape
    rel = float((got.double() - ref.double()).norm() / ref.double().norm())
    assert rel < REL_L2, rel
    assert bool((got[ref == 0] == 0).all())
