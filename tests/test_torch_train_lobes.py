"""The training pair's SG and ASG shading (kernel M's training mode and
M-bwd, csrc/slab_march.cu and csrc/slab_march_bwd.cu) on the CPU. Both
kernels take the lobes from the table each block folds with the fold the
display mode uses (csrc/slab_common.cuh ``fold_lobe``, evaluated by
``lobe_at``), and stream them one at a time into the colour sums; M-bwd's
shade pass stashes each lobe's value in the voxel's own output row (plane
0's slots) and writes the record's cotangent over it, planes 2 and 1 first
and plane 0 last. Here the fold (mirrored in tests/test_torch_display_lobes.py
operation for operation) is held against the reference's lobes at the
training bounds' edges with the trainer's unit scales, and the shade pass,
mirrored in plain PyTorch, against ``march_slabs_bwd_ref``'s records. The
kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from volrend_torch.models.data_format import BasisType
from volrend_torch.models.synthetic import make_test_tree
from volrend_torch.ops import dense_grid, slab_grad, slab_march, slab_render
from volrend_torch.utils.options import RenderOptions
from volrend_tpu.ops import basis as ref_basis

from _torch_perms import group_cams
from test_torch_display_lobes import ATOL, RTOL, _dirs, _lobes, fold_lobes
from test_torch_display_lobes import lobe_values

torch.set_num_threads(1)

W = H = 24
GI = 20
OPT = RenderOptions(max_steps=512).replace(renormalize=False)
#: the shade pass's mirror against march_slabs_bwd_ref's records: relative
#: L2 over the whole cotangent (the folded lobes against the reference's
#: exp, ~1e-7 of a value; each record value within the fold's rtol)
REL_L2 = 1e-6


@pytest.mark.parametrize("nb", [1, 4, 5, 9, 16, 25])
@pytest.mark.parametrize("fmt", ["SG", "ASG"])
def test_training_fold_matches_the_reference_lobes(fmt, nb):
    """The lobe counts at the edges of the training kernels' lobe bounds
    (4, 9, 16 and 25: counts 1-4, 5-9, 10-16, 17-25 share an
    instantiation), folded with the trainer's scales (ones) and evaluated
    as lobe_at evaluates them, give the reference's lobes at 4096 random
    unit directions and at each lobe's own axis."""
    extra = _lobes(fmt, nb, seed=nb + 50)
    qs = np.ones(3 * nb + 1, np.float32)
    axes = extra[:, 1:4] if fmt == "SG" else extra[:, 8:11]
    dirs = np.concatenate([_dirs(4096, seed=nb + 7), axes.astype(np.float32)])
    ev = ref_basis.eval_sg_basis if fmt == "SG" else ref_basis.eval_asg_basis
    want = torch.as_tensor(ev(dirs.astype(np.float64),
                              extra.astype(np.float64)))
    table = fold_lobes(fmt, torch.as_tensor(extra), torch.as_tensor(qs))
    got = lobe_values(fmt, table, torch.as_tensor(dirs))
    assert got.dtype == torch.float32 and got.shape == (len(dirs), nb)
    atol = 0.0 if fmt == "SG" else ATOL / nb
    err = (got.double() - want).abs()
    bound = RTOL * want.abs() + atol
    assert bool((err <= bound).all()), float((err / bound).max())


# ---- M-bwd's shade pass ----------------------------------------------------

@pytest.fixture(scope="module")
def geometry():
    """A G = 8 grid's geometry (its payload is replaced) and one camera of
    a (perm, flip) group."""
    tree = make_test_tree(max_depth=3, basis_dim=4, seed=5, sigma_scale=60.0)
    grid = dense_grid.bake_dense(tree.to_device(lut_depth=None,
                                                device="cpu"))
    cams = group_cams(grid, W, H, 30.0)
    group = ((2, 0, 1), False) if ((2, 0, 1), False) in cams else min(cams)
    return grid, group, cams[group]


def _bake(G: int, D: int, seed: int) -> torch.Tensor:
    """A (G, G, G, D) f32 bake from a numpy seed: colour values around 0,
    sigma in [-10, 40) (about a fifth of the voxels under the threshold)."""
    rng = np.random.default_rng(seed)
    bake = rng.normal(size=(G, G, G, D)).astype(np.float32)
    bake[..., D - 1] = rng.uniform(-10.0, 40.0, (G, G, G))
    return torch.as_tensor(bake)


def _voxel_cotangents(planar, qs, prm, zb, gacc4, aux, G, D, bd, flip, mode):
    """Pass 1's output, the voxel cotangents [g_sig, g_srgb x 3] (Gz, 4, G,
    G) that M-bwd's shade pass reads from its buffer: the suffix algebra
    and the transposed overlap warp, as march_slabs_bwd_ref computes them
    before its shade adjoint."""
    Gz = planar.shape[0]
    cz, cy, cx = prm[0], prm[1], prm[2]
    u0, du, v0, dv = prm[3], prm[4], prm[5], prm[6]
    sigma_thresh, stop_thresh, zbase = prm[14], prm[15], prm[30]
    cell = torch.arange(G, dtype=torch.float32)
    vc = (cell + 0.5) * (1.0 / G)
    ray = torch.arange(GI, dtype=torch.float32)
    ujG, vkG = (u0 + du * ray) * G, (v0 + dv * ray) * G
    dirp = [prm[21 + 3 * a] * (vc - cy)[:, None]
            + prm[22 + 3 * a] * (vc - cx)[None, :] for a in range(3)]
    hG = 0.5 / G
    zlo, zhi, dtp = zb[0], zb[1], zb[2]
    g_acc, ctot, gT = gacc4[:3], aux[0], aux[1]
    T, A = aux[2].clone(), aux[3].clone()
    out = torch.zeros((Gz, 4, G, G))
    for sid in (range(Gz - 1, -1, -1) if flip else range(Gz)):
        z = (sid + 0.5) / G + zbase
        s0, s1 = z - hG - cz, z + hG - cz
        slab = slab_march._slab_values(planar[sid])
        sigma = slab_march._slab_sigma(slab, qs, D, False)
        sigma = torch.where(sigma > sigma_thresh, sigma, 0.0)
        bk = slab_march._basis_planes(slab_march._dirs(dirp, prm, z - cz),
                                      bd, mode, torch.ones_like(qs)
                                      ).permute(2, 0, 1)
        raw = torch.sum(slab[:3 * bd].reshape(3, bd, G, G)
                        * (bk * qs[:bd, None, None])[None], 1)
        chans = torch.cat([sigma[None], sigma[None] * torch.sigmoid(raw)])
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
        out[sid] = m_r.T @ gch @ m_c
    return out


def shade_pass(planar, gbuf, qs, prm, G, nb, mode, planes=(2, 1, 0)):
    """M-bwd's shade pass for an SG or ASG variant, mirrored: per voxel
    with a nonzero cotangent and sigma above the threshold, the direction
    at its slab's distance, the lobes folded without the scales (the pass
    multiplies them a plane each) and evaluated as lobe_at does, each kept
    lobe's value stashed in the voxel's row o[k] (zero outside the basis
    window) as the sums take it times qs[k]; then the sigma slot, and the
    colour planes in the order ``planes`` written from the stash, o[ch nb
    + k] = graw[ch] o[k] qs[ch nb + k] (the kernel's 2, 1, 0: plane 0
    last, over its own stash). Returns the (Gz, D, G, G) cotangent."""
    fmt = BasisType(mode.fmt).name
    Gz, D = planar.shape[0], 3 * nb + 1
    cell = torch.arange(G, dtype=torch.float32)
    vc = (cell + 0.5) * (1.0 / G)
    dirp = [prm[21 + 3 * a] * (vc - prm[1])[:, None]
            + prm[22 + 3 * a] * (vc - prm[2])[None, :] for a in range(3)]
    table = fold_lobes(fmt, torch.as_tensor(mode.extra), torch.ones(nb))
    klo, khi = max(mode.basis_lo, 0), min(mode.basis_hi, nb - 1)
    out = torch.zeros((Gz, D, G, G))
    for sid in range(Gz):
        z = (sid + 0.5) / G + prm[30]
        vals = slab_march._slab_values(planar[sid]).reshape(D, -1).T
        g = gbuf[sid].reshape(4, -1).T                           # (N, 4)
        sigma = vals[:, D - 1] * qs[D - 1]
        live = (g != 0).any(1) & (sigma > prm[14])
        dirs = slab_march._dirs(dirp, prm, z - prm[0]).reshape(-1, 3)
        o = torch.zeros((vals.shape[0], D))
        b = lobe_values(fmt, table, dirs)                        # (N, nb)
        o[:, klo:khi + 1] = b[:, klo:khi + 1]
        raw = torch.zeros((vals.shape[0], 3))
        for k in range(klo, khi + 1):
            bq = o[:, k] * qs[k]
            for c in range(3):
                raw[:, c] = raw[:, c] + vals[:, c * nb + k] * bq
        rgb = torch.sigmoid(raw)
        o[:, D - 1] = (g[:, 0] + torch.sum(g[:, 1:] * rgb, 1)) * qs[D - 1]
        graw = g[:, 1:] * sigma[:, None] * rgb * (1.0 - rgb)
        for ch in planes:
            o[:, ch * nb:(ch + 1) * nb] = (graw[:, ch:ch + 1] * o[:, :nb]
                                           * qs[ch * nb:(ch + 1) * nb])
        o = torch.where(live[:, None], o, 0.0)
        out[sid] = o.T.reshape(D, G, G)
    return out


def _shade_case(geometry, fmt, nb, window, seed):
    """(mirror's records, march_slabs_bwd_ref's records, inputs) for an
    ``fmt`` bake of ``nb`` lobes with the basis window ``window``."""
    grid, (perm, flip), cam = geometry
    G, D = grid.G, 3 * nb + 1
    opt = OPT.replace(basis_minmax=window)
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, W, H, opt, GI)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=D, bd=nb, fmt=int(BasisType[fmt]),
                            perm=perm, flip=flip, ids=ids, opt=opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)[0]
    zb = torch.stack([geom.z_lo_pix[0], geom.z_hi_pix[0]])
    planar = _bake(G, D, seed).permute(perm[0], 3, perm[1], perm[2])
    rng = np.random.default_rng(seed + 1)
    qs = torch.as_tensor(rng.uniform(0.5, 1.5, D).astype(np.float32))
    gacc4 = torch.as_tensor(rng.normal(size=(4, GI, GI)).astype(np.float32))
    acc4 = torch.cat([torch.as_tensor(rng.uniform(0.0, 1.0, (3, GI, GI))
                                      .astype(np.float32)),
                      torch.full((1, GI, GI), 0.5)])
    mode = slab_march.MarchMode(cfg.fmt, _lobes(fmt, nb, seed), False, None,
                                True, window[0], window[1])
    prm, bzb, bgacc, aux = slab_march.march_bwd_inputs(params, zb, gacc4,
                                                       acc4, G, GI)
    ref = slab_march.march_slabs_bwd_ref(planar, qs, prm, bzb, bgacc, aux,
                                         G, GI, D, nb, flip, mode=mode)
    gbuf = _voxel_cotangents(planar, qs, prm, bzb, bgacc, aux, G, D, nb,
                             flip, mode)
    return gbuf, ref, (planar, qs, prm, G, nb, mode)


@pytest.mark.parametrize("fmt,nb,window", [("SG", 4, (1, 2)),
                                           ("ASG", 5, (0, 3))])
def test_shade_pass_writes_the_plain_versions_records(geometry, fmt, nb,
                                                      window):
    """M-bwd's shade pass, mirrored with its in-place write from the
    stashed lobes, gives march_slabs_bwd_ref's records on a G = 8 bake
    from a numpy seed (scales other than one, a basis window that drops
    lobes at both ends for SG4 and the last for ASG5): relative L2 below
    REL_L2, each value within the fold's tolerance, zeros in the planes
    outside the window and in the masked voxels."""
    gbuf, ref, args = _shade_case(geometry, fmt, nb, window, seed=nb)
    got = shade_pass(args[0], gbuf, *args[1:])
    assert float(ref.abs().max()) > 0 and got.shape == ref.shape
    rel = float((got.double() - ref.double()).norm() / ref.double().norm())
    assert rel < REL_L2, rel
    err = (got.double() - ref.double()).abs()
    assert bool((err <= 1e-5 * ref.double().abs() + 1e-9).all())
    for k in range(nb):
        if not window[0] <= k <= window[1]:
            assert bool((got[:, [k, nb + k, 2 * nb + k]] == 0).all())


def test_shade_pass_writes_plane_zero_last(geometry):
    """The in-place order matters: plane 0 written first overwrites the
    stash the other two planes read, and the records no longer agree."""
    gbuf, ref, args = _shade_case(geometry, "SG", 4, (0, 3), seed=9)
    got = shade_pass(args[0], gbuf, *args[1:], planes=(0, 1, 2))
    rel = float((got.double() - ref.double()).norm() / ref.double().norm())
    assert rel > 1e-2, rel
