"""Kernel M's display mode stages each tile's cell footprint in pieces
(the walk of csrc/slab_march_display.cu, mirrored here by ``_footprints``
and ``_pieces``), in the shared memory ``slab_march.display_config``
splits; the same function picks the tile height. The mirror is held
against a brute-force footprint: for every tile and slab of an orbit, a
steep and a cropped pose at the bench's width (G = gi = 256), the cells
each pixel's ray span covers must lie inside its tile's footprint, and the
footprint's pieces must cover it exactly, each piece fitting the stage and
the shaded-cell buffer. The kernel itself is held to the plain march on
the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from volrend_torch.models.synthetic import make_test_tree
from volrend_torch.ops import dense_grid, slab_march, slab_render
from volrend_torch.ops.camera import Camera
from volrend_torch.probes._common import orbit_poses
from volrend_torch.utils.options import RenderOptions

torch.set_num_threads(1)

W = H = 800
G = GI = 256
OPT = RenderOptions(max_steps=1024)
DP = 50       # SH16: 48 colour planes and sigma's two


def _footprints(params, slab_ids, G: int, gi: int, rows: int, crop):
    """Every display tile's cell footprint at each slab of ``slab_ids``, as
    the kernel computes it (slab_common.cuh tile_footprint, here in
    float64): the cells of the tile's corner rays at the slab faces, +-1
    cell of margin, clipped to the crop (y0, Gy, x0, Gx). Returns (y_lo,
    y_hi) of shape (P, S, tile rows) and (x_lo, x_hi) of shape (P, S, tile
    columns), global cells; lo > hi is an empty footprint."""
    p = np.asarray(params, np.float64)
    z = (np.asarray(slab_ids, np.float64)[None] + 0.5) / G + p[:, 30, None]
    s = (z - 0.5 / G - p[:, 0, None], z + 0.5 / G - p[:, 0, None])
    out = []
    for axis, t, (lo, n) in ((0, 8 * rows, crop[:2]),
                             (1, 32, crop[2:])):
        a = np.arange(0, gi, t)
        ends = (a, np.minimum(a + t, gi) - 1)
        slope = [(p[:, 3 + 2 * axis, None] + p[:, 4 + 2 * axis, None] * e)
                 * G for e in ends]                                # (P, T)
        c0 = p[:, 1 + axis, None, None] * G
        v = np.stack([c0 + si[:, :, None] * sl[:, None, :] for si in s
                      for sl in slope], -1)                     # (P, S, T, 4)
        fl = np.clip(np.floor(v), 0, G - 1)
        out.append((np.maximum(fl.min(-1) - 1, lo).astype(np.int64),
                    np.minimum(fl.max(-1) + 1, lo + n - 1).astype(np.int64)))
    return out


def _pieces(f, x0: int, Dp: int, stage_bytes: int, chan_cells: int,
            ch: int = 16):
    """The kernel's pieces of one tile-slab footprint ``f`` = (y_lo, y_hi,
    x_lo, x_hi), in its order (its Walk): columns of up to 240 cells,
    staged from the 16-byte chunk of the payload row (cropped at ``x0``)
    that holds its first cell over the fewest whole chunks that hold it (BX
    cells; ``ch`` cells a chunk: 16 int8, 8 bf16), rows as many as a stage
    and the shaded-cell buffer hold (``Dp`` bytes a cell: the planes times
    the element size). Returns [(py, px, rows, cols, BX)]."""
    y_lo, y_hi, x_lo, x_hi = f
    out = []
    for px in range(x_lo, x_hi + 1, 240):
        cols = min(240, x_hi - px + 1)
        BX = -(-((px - x0) % ch + cols) // ch) * ch
        rp = min(stage_bytes // (Dp * BX), chan_cells // BX)
        for py in range(y_lo, y_hi + 1, rp):
            out.append((py, px, min(rp, y_hi - py + 1), cols, BX))
    return out


@pytest.fixture(scope="module")
def grid():
    """A small grid with the bench scene's bounds: the march's params do
    not depend on the resolution, so the footprints are taken at G=256."""
    tree = make_test_tree(max_depth=2, basis_dim=16, seed=3)
    return dense_grid.bake_dense(tree.to_device(lut_depth=None,
                                                device="cpu"), dtype="int8")


def _steep(grid, lo=3.6, hi=3.95):
    """Orbit pose 0 with the focal narrowed until the boundary slope lies
    in [lo, hi) (chip_smoke.steep_pose)."""
    base = orbit_poses(1)[0]
    f_lo, f_hi = 20.0, float(base.fx)
    for _ in range(60):
        f = 0.5 * (f_lo + f_hi)
        cam = Camera(W, H, f, f, base.transform)
        s = slab_render.choose_axis(grid, cam.transform, f, f, W, H)[2]
        if lo <= s < hi:
            return cam
        f_lo, f_hi = (f, f_hi) if s >= hi else (f_lo, f)
    raise AssertionError("no steep focal")


def _pose(grid, kind):
    """Orbit pose 7 or the steep pose, with the crop of ``kind``."""
    cam = _steep(grid) if kind == "steep" else orbit_poses(200)[7]
    perm, flip, slope = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                                cam.fy, W, H)
    assert slope < slab_render.MAX_SLAB_SLOPE
    geom = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, W, H, OPT, GI)
    params, _ = slab_render._march_frame_fields(grid, geom, perm, flip, OPT)
    params = torch.cat([params, torch.zeros((1, 1))], 1).numpy()
    crop = (40, 128, 64, 128) if kind == "cropped" else (0, G, 0, G)
    ids = np.arange(G)[::-1] if flip else np.arange(G)
    return params, ids, crop, slope


def _pixel_cells(params, ids, axis, crop):
    """Brute force: each pixel's cells along one axis at each slab, (lo,
    hi) of shape (P, S, gi), clipped to the crop (lo > hi: none)."""
    p = params.astype(np.float64)
    z = (ids[None].astype(np.float64) + 0.5) / G + p[:, 30, None]
    s0, s1 = z - 0.5 / G - p[:, 0, None], z + 0.5 / G - p[:, 0, None]
    slope = (p[:, 3 + 2 * axis, None] + p[:, 4 + 2 * axis, None]
             * np.arange(GI)) * G                                   # (P, gi)
    c0 = p[:, 1 + axis, None, None] * G
    a = c0 + s0[:, :, None] * slope[:, None]
    b = c0 + s1[:, :, None] * slope[:, None]
    lo = np.clip(np.floor(np.minimum(a, b)), 0, G - 1)
    hi = np.clip(np.floor(np.maximum(a, b)), 0, G - 1)
    c_lo, c_n = crop[2 * axis], crop[2 * axis + 1]
    return np.maximum(lo, c_lo), np.minimum(hi, c_lo + c_n - 1)


def _check_footprints(params, ids, crop, rows):
    """Each pixel's cells lie inside its tile's footprint (both axes)."""
    fps = _footprints(params, ids, G, GI, rows, crop)
    for axis, tile, (f_lo, f_hi) in ((0, 8 * rows, fps[0]),
                                     (1, 32, fps[1])):
        lo, hi = _pixel_cells(params, ids, axis, crop)
        need = lo <= hi
        owner = np.arange(GI) // tile
        assert np.all(~need | (lo >= f_lo[..., owner])), (rows, axis)
        assert np.all(~need | (hi <= f_hi[..., owner])), (rows, axis)
        # a pixel that needs cells belongs to a tile with a footprint
        assert np.all(~need | (f_lo[..., owner] <= f_hi[..., owner]))
    return fps


@pytest.mark.parametrize("kind", ["orbit", "steep", "cropped"])
def test_tile_footprints_and_pieces_cover_every_pixels_cells(grid, kind):
    """At both tile heights, each pixel's cells lie in its tile's
    footprint, and the pieces of each tile-slab footprint tile it exactly,
    each fitting the stage and the shaded-cell buffer that display_config
    sizes."""
    params, ids, crop, _ = _pose(grid, kind)
    for rows in (1, 2):
        cfg = slab_march.display_config(51 if rows == 2 else 1, GI, G // 4,
                                        DP, 132)
        assert cfg["rows"] == rows
        (y_lo, y_hi), (x_lo, x_hi) = _check_footprints(params, ids, crop,
                                                       rows)
        n_pieces = []
        for si in range(0, len(ids), 5):
            for ty in range(y_lo.shape[2]):
                for tx in range(x_lo.shape[2]):
                    f = (y_lo[0, si, ty], y_hi[0, si, ty], x_lo[0, si, tx],
                         x_hi[0, si, tx])
                    if f[0] > f[1] or f[2] > f[3]:
                        continue
                    cover = np.zeros((f[1] - f[0] + 1, f[3] - f[2] + 1), int)
                    pcs = _pieces(f, crop[2], DP, cfg["stage_bytes"],
                                  cfg["chan_cells"])
                    for py, px, nr, nc, bx in pcs:
                        xoff = (px - crop[2]) % 16
                        assert bx % 16 == 0 and bx <= 256
                        assert xoff + nc <= bx < xoff + nc + 16
                        assert nr * DP * bx <= cfg["stage_bytes"]
                        assert nr * bx <= cfg["chan_cells"]
                        cover[py - f[0]:py - f[0] + nr,
                              px - f[2]:px - f[2] + nc] += 1
                    assert np.all(cover == 1)
                    n_pieces.append(len(pcs))
        assert n_pieces
        if kind != "steep":
            # an orbit footprint mostly fits the one stage
            assert np.mean(np.asarray(n_pieces) == 1) > 0.5


@pytest.mark.parametrize("Dp", [5, 14, 29, 50, 77])
def test_display_config_fits_two_blocks_an_sm(Dp):
    """Every SH degree's launch fits two blocks an SM (2 x (smem + static
    arrays + 1 KB the card reserves) within its 228 KB), with a stage that
    holds a 256-cell row and a shaded-cell buffer as wide."""
    for n_win in (1, 64, 256):
        cfg = slab_march.display_config(51, GI, n_win, Dp, 132)
        assert cfg["smem"] <= slab_march._DISPLAY_SMEM
        assert 2 * (cfg["smem"] + 1024 + 1024) <= 228 * 1024
        assert cfg["stage_bytes"] % 128 == 0
        assert cfg["stage_bytes"] >= Dp * 256
        assert cfg["chan_cells"] >= 256
        assert cfg["smem"] == (cfg["stage_bytes"] + 16 * cfg["chan_cells"]
                               + 12 * n_win)


@pytest.mark.parametrize("P, gi, rows", [
    (1, 256, 1), (4, 256, 1), (6, 256, 1), (7, 256, 2), (51, 256, 2),
    (1, 448, 1), (2, 448, 1), (3, 448, 2), (1, 64, 1), (200, 64, 2)])
def test_display_config_tile_height_follows_the_launch(P, gi, rows):
    """On a 132-SM card: 32x16 tiles when the launch holds at least six of
    them an SM, 32x8 (twice the blocks) below that."""
    assert slab_march.display_config(P, gi, 64, DP, 132)["rows"] == rows


@pytest.mark.parametrize("probe", ["display_tiles", "tma_box"])
def test_display_probes_refuse_to_run_without_a_card(probe, monkeypatch):
    """The display probes measure on the card only: without one they raise
    before building or timing anything."""
    import importlib
    mod = importlib.import_module(f"volrend_torch.probes.{probe}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", [probe])
    with pytest.raises(RuntimeError, match="CUDA device"):
        mod.main()


@pytest.mark.parametrize("Dp, esz", [(5, 1), (50, 1), (77, 1), (49, 2)])
def test_display_config_depth_stages_sigma_alone(Dp, esz):
    """The depth variant's stage counts sigma's bytes alone (2 a cell: the
    int8 hi and lo planes, or the bf16 plane), whatever the payload's
    planes, and its shaded-cell buffer one float a cell; the two hold the
    same cells (to one 128-byte step of stage), ~11x an SH16 int8 launch's
    (whose stage holds 50 bytes a cell and its buffer a float4)."""
    for n_win in (1, 64, 256):
        cfg = slab_march.display_config(1, GI, n_win, Dp, 132, esz=esz,
                                        opt=True, depth=True)
        assert cfg == slab_march.display_config(1, GI, n_win, 3, 132,
                                                opt=True, depth=True)
        assert cfg["rows"] == 1
        assert cfg["smem"] == (cfg["stage_bytes"] + 4 * cfg["chan_cells"]
                               + 12 * n_win)
        assert cfg["smem"] <= slab_march._DISPLAY_SMEM
        assert 2 * (cfg["smem"] + 1024 + 1024) <= 228 * 1024
        assert cfg["stage_bytes"] % 128 == 0
        assert cfg["stage_bytes"] >= 2 * 256 and cfg["chan_cells"] >= 256
        cells = cfg["stage_bytes"] // 2
        assert cells <= cfg["chan_cells"] < cells + 128
        sh16 = slab_march.display_config(1, GI, n_win, DP, 132, opt=True)
        assert cells >= 10 * (sh16["stage_bytes"] // DP)


@pytest.mark.parametrize("kind", ["orbit", "steep", "cropped"])
def test_depth_footprints_stage_whole(grid, kind):
    """In depth mode (32x8 tiles, sigma's two int8 planes staged) every
    tile-slab footprint of an orbit, a steep and a cropped pose goes in
    one piece, where the SH16 stage takes most of them in one and the
    steep pose's in several (test above)."""
    params, ids, crop, _ = _pose(grid, kind)
    cfg = slab_march.display_config(1, GI, G // 4, DP, 132, opt=True,
                                    depth=True)
    (y_lo, y_hi), (x_lo, x_hi) = _footprints(params, ids, G, GI, 1, crop)
    n_pieces = []
    for si in range(0, len(ids), 5):
        for ty in range(y_lo.shape[2]):
            for tx in range(x_lo.shape[2]):
                f = (y_lo[0, si, ty], y_hi[0, si, ty], x_lo[0, si, tx],
                     x_hi[0, si, tx])
                if f[0] <= f[1] and f[2] <= f[3]:
                    n_pieces.append(len(_pieces(f, crop[2], 2,
                                                cfg["stage_bytes"],
                                                cfg["chan_cells"])))
    assert n_pieces and max(n_pieces) == 1


def test_lobe_launches_follow_the_tile_rule():
    """SG and ASG launches with no other option take the tile rule's
    height (32x16 on a 51-pose group, probes/display_tiles); with another
    option, in depth mode or resumed they take 32x8, as RGBA and SH with
    an option do."""
    from volrend_torch.models.data_format import BasisType
    M = slab_march.MarchMode
    for fmt in (BasisType.SG, BasisType.ASG):
        assert M(int(fmt)).tall_tiles(16)
        assert M(int(fmt), dir_slab=True).tall_tiles(16)
        for other in (dict(depth=True), dict(rot=(0.0,) * 9),
                      dict(bbox_full=False), dict(basis_lo=1),
                      dict(basis_hi=9)):
            assert not M(int(fmt), **other).tall_tiles(16), other
    assert M().tall_tiles(16) and not M(depth=True).tall_tiles(16)
    assert not M(int(BasisType.RGBA)).tall_tiles(-1)
    for tall, rows in ((True, 2), (False, 1)):
        cfg = slab_march.display_config(51, GI, 64, 3 * 16 + 2, 132,
                                        opt=not tall)
        assert cfg["rows"] == rows


def test_bf16_shade_launches_follow_the_tile_rule():
    """bf16 SH shading without another option is a variant of its own
    (vt_march_display's opt 2, built at both tile heights): it takes the
    tile rule's height (32x16 on a 51-pose group) and no option variant;
    with rot, a bbox or a basis window, or resumed, it takes the option
    variant (opt 3, 32x8). Both are named ``-bf16shade``."""
    M = slab_march.MarchMode
    rot = (0.0,) * 9
    shade = M(bf16_shade=True)
    assert shade.tall_tiles(16) and not shade.options(16)
    assert M(bf16_shade=True, dir_slab=True).tall_tiles(16)
    for other in (dict(rot=rot), dict(bbox_full=False), dict(basis_lo=1),
                  dict(basis_hi=9)):
        mode = M(bf16_shade=True, **other)
        assert not mode.tall_tiles(16) and mode.options(16), other
        assert slab_march._variant_args(mode, 16, "cpu")[2] == 3, other
    codes = ((M(), False, 0), (shade, False, 2), (M(rot=rot), False, 1),
             (shade, True, 3), (M(), True, 1), (M(depth=True), False, 5))
    for mode, resume, code in codes:
        assert slab_march._variant_args(mode, 16, "cpu", resume)[2] == code
    for bf16 in (False, True):
        name = f"SH-{'bf16' if bf16 else 'int8'}-bf16shade"
        assert slab_march.display_variant(shade, 16, bf16) == name
        assert slab_march.display_variant(M(bf16_shade=True, rot=rot), 16,
                                          bf16) == name
    for esz, Dp in ((1, 50), (2, 49)):
        for tall, rows in ((True, 2), (False, 1)):
            mode = shade if tall else M(bf16_shade=True, bbox_full=False)
            cfg = slab_march.display_config(51, GI, 64, Dp, 132, esz=esz,
                                            opt=not mode.tall_tiles(16))
            assert cfg["rows"] == rows


@pytest.mark.parametrize("kind", ["orbit", "steep", "cropped"])
def test_bf16_pieces_cover_every_footprint(grid, kind):
    """The f16 route's SH variants stage the bf16 payload by the same walk
    (the consumer takes the producer's walk, so the pieces are the
    producer's): 8-cell (16-byte) chunks, a stage sized for 98 bytes a cell
    (SH16: 49 bf16 planes). At both tile heights each footprint's pieces
    tile it exactly within the stage and the shaded-cell buffer; the steep
    pose's footprints go in several pieces (the split the 32x16 stage
    forces), and an orbit footprint mostly in one."""
    params, ids, crop, _ = _pose(grid, kind)
    Dp = 49
    for rows in (1, 2):
        cfg = slab_march.display_config(51 if rows == 2 else 1, GI, G // 4,
                                        Dp, 132, esz=2)
        (y_lo, y_hi), (x_lo, x_hi) = _footprints(params, ids, G, GI, rows,
                                                 crop)
        n_pieces = []
        for si in range(0, len(ids), 5):
            for ty in range(y_lo.shape[2]):
                for tx in range(x_lo.shape[2]):
                    f = (y_lo[0, si, ty], y_hi[0, si, ty], x_lo[0, si, tx],
                         x_hi[0, si, tx])
                    if f[0] > f[1] or f[2] > f[3]:
                        continue
                    cover = np.zeros((f[1] - f[0] + 1, f[3] - f[2] + 1), int)
                    pcs = _pieces(f, crop[2], 2 * Dp, cfg["stage_bytes"],
                                  cfg["chan_cells"], ch=8)
                    for py, px, nr, nc, bx in pcs:
                        xoff = (px - crop[2]) % 8
                        assert bx % 8 == 0 and xoff + nc <= bx < xoff + nc + 8
                        assert nr * 2 * Dp * bx <= cfg["stage_bytes"]
                        assert nr * bx <= cfg["chan_cells"]
                        cover[py - f[0]:py - f[0] + nr,
                              px - f[2]:px - f[2] + nc] += 1
                    assert np.all(cover == 1)
                    n_pieces.append(len(pcs))
        assert n_pieces
        if kind == "steep":
            assert max(n_pieces) > 1
        else:
            assert np.mean(np.asarray(n_pieces) == 1) > 0.5
