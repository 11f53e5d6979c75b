"""The live pixels' footprint, the lever for a silhouette tile's march, on
the CPU. A pixel that cannot accumulate any more (T under stop_thresh, or
its z interval passed) never will, so at each slab only the cells that the
spans of a tile's live pixels meet can change what kernel M writes. The
rule is mirrored here in plain PyTorch: a tile's live footprint is the
tile footprint (``tile_footprint`` in csrc/slab_common.cuh, with its cell
of margin) of the live pixels' bounding sub-rectangle. On a G = 16
two-cube bake from a numpy seed at the training stop_thresh, whose rays
freeze inside the cubes, seen from both sides of a slab axis (flip off
and on) with rot, a basis window and a bbox, and as RGBA, the test marches
the port's plain version (``slab_march.march_slabs_ref``) slab by slab,
each slab from the state the one before left (``acc_init``), and shows
that every live pixel's overlap weights lie inside its tile's live
footprint, that the footprints leave shaded cells out, and that zeroing
the cells outside them changes no bit of the march, which agrees with the
reference's scan march (``volrend_tpu/ops/slab_grad.py:_march_fwd_impl``)
on the same payload. Kernel M itself marches every cell of the whole
tile's footprint: the narrowing, measured on the card, did not pay
(PERF.md §6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from volrend_tpu.ops import render_jax
from volrend_tpu.ops import slab_grad as j_sg
from volrend_tpu.ops import slab_render as j_slab
from volrend_tpu.utils.options import RenderOptions as JOpt
from volrend_torch.models.data_format import BasisType
from volrend_torch.ops import slab_march

from _torch_scenes import make_cam, scene

torch.set_num_threads(1)

W = H = 48
GI = 24
#: kernel M's training tile, pixel rows and columns (tmarch::TY, TX in
#: csrc/slab_common.cuh)
TILE = (4, 8)
#: the training stop threshold (utils/options.py's default)
STOP = 1e-2
JOPT = JOpt(max_steps=512).replace(renormalize=False, render_depth=False)
#: camera directions of a (perm, flip) group with flip off and on
BACKS = {False: (-1.0, -0.25, -0.35), True: (1.0, 0.25, 0.35)}
BBOX = dict(render_bbox=(0.1,) * 3 + (0.8,) * 3)
#: (format, basis functions, render options): kernel M's SH option and
#: RGBA training variants
CASES = {
    "SH1-bbox": ("SH", 1, BBOX),
    "SH4-all": ("SH", 4, dict(rot_dirs=(0.3, -0.2, 0.5),
                              basis_minmax=(1, 2), **BBOX)),
    "RGBA": ("RGBA", -1, {}),
}
#: the march slab by slab against the whole march and the reference's
#: scan march (tests/test_torch_train_formats.py): f32 rounding
TOL_REF = 5e-6


def two_cubes(G, D, seed):
    """A (G, G, G, D) bake with sigma far above the threshold in two cubes
    ([G/8, 3G/8) and [5G/8, 7G/8) on every axis; rays through either
    freeze at stop_thresh) and under it elsewhere, colours everywhere."""
    rng = np.random.default_rng(seed)
    bake = rng.normal(0.0, 0.6, size=(G, G, G, D)).astype(np.float32)
    sig = rng.uniform(-2.0, -0.5, size=(G, G, G)).astype(np.float32)
    for lo in (G // 8, 5 * G // 8):
        hi = lo + G // 4
        sig[lo:hi, lo:hi, lo:hi] = rng.uniform(40.0, 120.0,
                                                size=(hi - lo,) * 3)
    bake[..., D - 1] = sig
    return bake


def _cell_floor(v, G: int) -> int:
    return int(min(max(np.floor(v), 0), G - 1))


def live_footprint(prm, G: int, rows, cols, z):
    """The cells (y_lo, y_hi, x_lo, x_hi) that the spans of the pixels in
    rows [rows[0], rows[1]] and columns [cols[0], cols[1]] can meet at the
    slab of centre ``z``: ``tile_footprint``'s, a cell of margin on each
    side for rounding, clipped to the grid."""
    f32 = np.float32
    cz, cy, cx = (f32(prm[i]) for i in range(3))
    u0, du, v0, dv = (f32(prm[i]) for i in range(3, 7))
    Gf, hG = f32(G), f32(0.5) / f32(G)
    s0, s1 = f32(z) - hG - cz, f32(z) + hG - cz
    ys = [cy * Gf + s * (u0 + du * f32(j)) * Gf for s in (s0, s1)
          for j in rows]
    xs = [cx * Gf + s * (v0 + dv * f32(k)) * Gf for s in (s0, s1)
          for k in cols]
    return (max(_cell_floor(min(ys), G) - 1, 0),
            min(_cell_floor(max(ys), G) + 1, G - 1),
            max(_cell_floor(min(xs), G) - 1, 0),
            min(_cell_floor(max(xs), G) + 1, G - 1))


def live_mask(prm, G: int, gi: int, z, live):
    """(G, G) the cells of the slab of centre ``z`` inside some tile's
    live footprint (the (gi, gi) mask ``live``: the pixels that can still
    accumulate), and {(tile row, tile column): footprint} of the tiles
    with a live pixel."""
    TY, TX = TILE
    keep = torch.zeros((G, G), dtype=torch.bool)
    foot = {}
    for j0 in range(0, gi, TY):
        for k0 in range(0, gi, TX):
            lv = live[j0:j0 + TY, k0:k0 + TX]
            if not bool(lv.any()):
                continue
            js, ks = torch.nonzero(lv, as_tuple=True)
            f = live_footprint(prm, G, (j0 + int(js.min()),
                                        j0 + int(js.max())),
                               (k0 + int(ks.min()), k0 + int(ks.max())), z)
            foot[j0 // TY, k0 // TX] = f
            keep[f[0]:f[1] + 1, f[2]:f[3] + 1] = True
    return keep, foot


def _live(T, zb, z, hG, flip):
    """The pixels that can still accumulate at the slab of centre ``z``
    (kernel M's predicate): T at or above stop_thresh, a z interval, and
    the march not past it."""
    zlo, zhi = zb[0], zb[1]
    ahead = (z + hG >= zlo) if flip else (z - hG <= zhi)
    return (T >= STOP) & (zlo <= zhi) & ahead


@pytest.fixture(scope="module", params=[(c, f) for c in sorted(CASES)
                                        for f in (False, True)],
                ids=lambda p: f"{p[0]}-flip{int(p[1])}")
def case(request):
    """One pose of a case: the bf16-rounded two-cube payload seen through
    the pose group's permutation, its march inputs, the plain version's
    statics, and the reference's scan march on the same payload."""
    name, flip_want = request.param
    fmt, bd, options = CASES[name]
    jg = scene("dense", 4, "f16")[3]
    G = jg.G
    D = 4 if fmt == "RGBA" else 3 * bd + 1
    jopt = JOPT.replace(**options)
    assert float(jopt.stop_thresh) == STOP
    cam = make_cam(BACKS[flip_want], width=W, height=H)
    perm, flip, _ = j_slab.choose_axis(jg, cam.transform, cam.fx, cam.fy,
                                       W, H)
    assert flip == flip_want
    geom = j_slab.FrameGeom(jg, jnp.asarray(cam.transform), cam.fx, cam.fy,
                            perm, flip, W, H, jopt, GI)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = j_sg.SlabCfg(G=G, gi=GI, D=D, bd=bd,
                       fmt=int(BasisType[fmt]), perm=perm, flip=flip,
                       ids=ids, opt=jopt)
    bake = two_cubes(G, D, seed=len(name) + 3 * flip)
    planar = np.transpose(bake, (perm[0], 3, perm[1], perm[2]))
    p16 = np.asarray(jnp.asarray(planar).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    params = j_sg._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    gm = dict(cz=geom.cz, cy=geom.cy, cx=geom.cx, uy=geom.uy, ux=geom.ux,
              z_lo=geom.z_lo_pix, z_hi=geom.z_hi_pix, scale=geom.scale,
              lo=geom.lo, hi=geom.hi, dirM=geom.dirM)
    a, T = jax.jit(lambda pp: j_sg._march_fwd_impl(cfg, pp, jg.extra, gm))(
        jnp.asarray(np.transpose(p16, (0, 2, 3, 1))))
    rotm = render_jax._rodrigues_matrix(jopt.rot_dirs)
    statics = dict(fmt=cfg.fmt, extra=None,
                   rot=(None if rotm is None
                        else tuple(float(v) for v in rotm.reshape(-1))),
                   bbox_full=j_slab._bbox_full(jopt),
                   basis_lo=int(jopt.basis_minmax[0]),
                   basis_hi=int(jopt.basis_minmax[1]))
    zb = torch.tensor(np.stack([np.asarray(geom.z_lo_pix),
                                np.asarray(geom.z_hi_pix)]))[None]
    ref = np.concatenate([np.moveaxis(np.asarray(a), -1, 0),
                          np.asarray(T)[None]])
    return dict(name=name, planar=torch.tensor(p16).to(torch.bfloat16),
                D=D, bd=bd, flip=flip, ids=ids,
                params=torch.tensor(np.asarray(params))[None], zb=zb,
                statics=statics, ref=ref)


def march_by_slab(case, zero_outside: bool):
    """The plain version slab by slab in march order, each slab a z-segment
    marched from the state the one before left. Before each slab: the live
    pixels (_live) and their tiles' footprints (live_mask); with
    ``zero_outside`` the records of the cells outside every footprint are
    zeroed. Returns the accumulator (4, gi, gi) and, by slab, (slab id,
    live pixels, footprints, cells kept, the slab's overlap matrices and
    its cells above the threshold)."""
    planar, D, bd, flip = (case[k] for k in ("planar", "D", "bd", "flip"))
    G = planar.shape[0]
    hG = 0.5 / G
    acc, steps = None, []
    for sid in case["ids"]:
        seg = planar[sid:sid + 1].clone()
        m = slab_march.march_inputs(seg, case["params"], case["zb"], G, GI,
                                    (0,), z_base=sid / G)
        m.pop("gi")
        prm = m["params"][0]
        z = (sid + 0.5) / G
        T = torch.ones((GI, GI)) if acc is None else acc[0, 3]
        live = _live(T, m["zb"][0], z, hG, flip)
        keep, foot = live_mask(prm, G, GI, z, live)
        if zero_outside:
            seg[0, :, ~keep] = 0
        acc = slab_march.march_slabs_ref(
            seg, torch.ones(D), D=D, bd=bd, flip=flip, gi=GI,
            acc_init=acc, **case["statics"], **m)
        sigma = slab_march._slab_sigma(
            slab_march._slab_values(planar[sid]), torch.ones(D), D, False)
        cy, cx, s0, s1 = (float(prm[1]), float(prm[2]),
                          z - hG - float(prm[0]), z + hG - float(prm[0]))
        ray = torch.arange(GI, dtype=torch.float32)
        cell = torch.arange(G, dtype=torch.float32)
        m_r = slab_march._overlap_mat(cy * G, (prm[3] + prm[4] * ray) * G,
                                      s0, s1, cell, G)
        m_c = slab_march._overlap_mat(cx * G, (prm[5] + prm[6] * ray) * G,
                                      s0, s1, cell, G)
        steps.append((sid, live, foot, keep, m_r, m_c,
                      sigma > float(prm[14])))
    return acc[0], steps


@pytest.fixture(scope="module")
def marched(case):
    return march_by_slab(case, False), march_by_slab(case, True)[0]


def _support(w):
    """(first, last) cell of nonzero weight of each row of ``w``."""
    nz = w > 0
    idx = torch.arange(w.shape[1])
    return (torch.where(nz, idx, w.shape[1]).amin(1),
            torch.where(nz, idx, -1).amax(1))


def test_live_footprint_holds_every_live_span(case, marched):
    """At every slab, each live pixel's overlap weights (the plain
    version's, nonzero on the cells its span meets) lie inside its tile's
    live footprint, and the footprints leave out shaded cells that the
    whole tiles' footprints hold (rays froze inside the cubes while their
    tiles march on)."""
    (_, steps), _ = marched
    G = case["planar"].shape[0]
    n_live, left_out = 0, 0
    for sid, live, foot, keep, m_r, m_c, above in steps:
        r_lo, r_hi = _support(m_r)
        c_lo, c_hi = _support(m_c)
        for j, k in torch.nonzero(live).tolist():
            f = foot[j // TILE[0], k // TILE[1]]
            assert (f[0] <= r_lo[j] and r_hi[j] <= f[1]
                    and f[2] <= c_lo[k] and c_hi[k] <= f[3]), (
                case["name"], sid, j, k, f)
            n_live += 1
        tiles = torch.zeros((G, G), dtype=torch.bool)
        prm = case["params"][0]
        for j0 in range(0, GI, TILE[0]):
            for k0 in range(0, GI, TILE[1]):
                f = live_footprint(prm, G, (j0, j0 + TILE[0] - 1),
                                   (k0, k0 + TILE[1] - 1), (sid + 0.5) / G)
                tiles[f[0]:f[1] + 1, f[2]:f[3] + 1] = True
        assert not bool((keep & ~tiles).any()), (case["name"], sid)
        left_out += int((above & tiles & ~keep).sum())
    assert n_live > 0 and left_out > 0, (case["name"], n_live, left_out)


def test_march_unchanged_outside_the_live_footprints(case, marched):
    """Zeroing the records outside the live footprints before each slab
    changes no bit of the march; the march slab by slab agrees with the
    plain version's whole march and the reference's scan march on the same
    bf16-rounded payload, and leaves frozen and live pixels both."""
    (got, _), zeroed = marched
    assert torch.equal(got, zeroed), case["name"]
    m = slab_march.march_inputs(case["planar"], case["params"], case["zb"],
                                case["planar"].shape[0], GI, case["ids"])
    m.pop("gi")
    whole = slab_march.march_slabs_ref(
        case["planar"], torch.ones(case["D"]), D=case["D"], bd=case["bd"],
        flip=case["flip"], gi=GI, **case["statics"], **m)[0]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=TOL_REF,
                               err_msg=case["name"])
    np.testing.assert_allclose(got.numpy(), case["ref"], atol=TOL_REF,
                               err_msg=case["name"])
    frozen = got[3] < STOP
    assert bool(frozen.any()) and bool((~frozen).any()), case["name"]


def test_live_footprint_of_one_pixel_is_its_span():
    """A tile with one live pixel: its live footprint is that pixel's span
    with a cell of margin, inside the whole tile's footprint and narrower
    than it; a tile without live pixels has none."""
    G = 16
    prm = torch.zeros(31)
    prm[0:3] = torch.tensor((-1.5, 0.5, 0.5))            # camera z, y, x
    prm[3:7] = torch.tensor((-0.1, 0.025, -0.1, 0.025))  # u0, du, v0, dv
    z = 0.53
    live = torch.zeros((8, 8), dtype=torch.bool)
    live[0, 0] = True
    keep, foot = live_mask(prm, G, 8, z, live)
    assert set(foot) == {(0, 0)}
    hG = 0.5 / G
    s0, s1 = z - hG - float(prm[0]), z + hG - float(prm[0])
    cell = torch.arange(G, dtype=torch.float32)
    r_lo, r_hi = _support(slab_march._overlap_mat(
        float(prm[1]) * G, prm[3:4] * G, s0, s1, cell, G))
    c_lo, c_hi = _support(slab_march._overlap_mat(
        float(prm[2]) * G, prm[5:6] * G, s0, s1, cell, G))
    f = foot[0, 0]
    assert f == (max(int(r_lo[0]) - 1, 0), min(int(r_hi[0]) + 1, G - 1),
                 max(int(c_lo[0]) - 1, 0), min(int(c_hi[0]) + 1, G - 1))
    whole = live_footprint(prm, G, (0, TILE[0] - 1), (0, TILE[1] - 1), z)
    assert (whole[0] <= f[0] and f[1] <= whole[1] and whole[2] <= f[2]
            and f[3] <= whole[3])
    assert (f[1] - f[0]) + (f[3] - f[2]) < ((whole[1] - whole[0])
                                            + (whole[3] - whole[2]))
    assert int(keep.sum()) == (f[1] - f[0] + 1) * (f[3] - f[2] + 1)
