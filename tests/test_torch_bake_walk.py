"""The bake kernel's level walk (``csrc/bake_pyramid.cu``) mirrored in
numpy on the CPU, where the wrappers run their plain versions: a voxel's
block index at level j taken as a multiply by the magic number
floor(2^32 / f) + 1 and a shift instead of a division by f = G / B_j,
and the walk, coarse to fine, equal to ``slab_grad.level_map`` (the
plain map the kernel stores none of) at N = 2 and 3; and the inputs
``probes/bake.py --widths`` times the kernel on (the training bench's
levels at D = 4, 19 and 28) and its bound; and the probes' bookkeeping
(display_march's per-block summary, its turns with a parent checkout).
No JAX; the kernel itself is held against the plain chain on the card
(tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from volrend_torch.models.synthetic import make_solid_tree
from volrend_torch.ops import slab_grad

from _torch_trees import tree_n

torch.set_num_threads(1)


def _magic(f: int) -> int:
    """vt_bake_pyramid's Levels.mag for a factor f = G / B_j."""
    return (1 << 32) // f + 1


def _div_by(c: np.ndarray, mag: int) -> np.ndarray:
    """The kernel's div_by: (c * mag) >> 32 in 64-bit unsigned."""
    return ((c.astype(np.uint64) * np.uint64(mag)) >> np.uint64(32)
            ).astype(np.int64)


@pytest.mark.parametrize("N", [2, 3])
def test_magic_division_is_exact_below_2_16(N):
    """Every coordinate below 2^16 divided by every power of N up to 2^16
    (each level's factor at G < 2^16): the magic multiply equals the
    integer division, so the walk finds the plain chain's blocks."""
    c = np.arange(1 << 16, dtype=np.int64)
    f = 1
    while f <= 1 << 16:
        np.testing.assert_array_equal(_div_by(c, _magic(f)), c // f)
        f *= N


def _walk(bmap) -> np.ndarray:
    """The kernel's walk of every voxel over ``slab_grad.walked_levels``
    but the finest, coarse to fine, with the magic division: (G, G, G)
    level indices, the finest where none covers (its mask is not read)."""
    G = bmap.G
    z, y, x = np.meshgrid(*(np.arange(G),) * 3, indexing="ij")
    walk = slab_grad.walked_levels(bmap)
    lev = np.full((G, G, G), walk[-1], np.int64)
    found = np.zeros((G, G, G), bool)
    for j in walk[:-1]:
        m = bmap.masks[j]
        B = m.shape[0]
        mag = _magic(G // B)
        blk = (_div_by(z, mag) * B + _div_by(y, mag)) * B + _div_by(x, mag)
        hit = m.reshape(-1).numpy()[blk] & ~found
        lev[hit] = j
        found |= hit
    return lev


@pytest.mark.parametrize("N, depth", [(2, 4), (3, 2), ("solid", 3)])
def test_walk_with_magic_division_equals_level_map(N, depth):
    """The walk over the levels with leaves finds each voxel's one
    covering level, as level_map does, on trees with leaves at several
    levels (G = 32 at N = 2, 27 at N = 3, whose rows end in a partial bit
    word) and on the training bench's kind of tree, whose coarsest level
    has no leaf and is left out of the walk."""
    tree = (make_solid_tree(max_depth=depth, basis_dim=1, seed=7)
            if N == "solid" else tree_n(N, depth, 4, seed=N + depth))
    bmap = slab_grad.build_bake_map(tree.to_device(
        lut_depth=None, device=torch.device("cpu")))
    want = slab_grad.level_map(bmap).numpy().astype(np.int64)
    assert len(np.unique(want)) > 1
    walk = slab_grad.walked_levels(bmap)
    assert walk[-1] == len(bmap.masks) - 1
    assert all(bmap.sizes[j] for j in walk[:-1])
    if N == "solid":
        assert bmap.sizes[0] == 0 and walk[0] > 0
    np.testing.assert_array_equal(_walk(bmap), want)


def test_probe_widths_share_the_bench_levels():
    """probes/bake.py's widths: the bench tree's leaves read as RGBA (D =
    4) and SG6 (D = 19) on the SH9 tree's bake map (its levels and
    masks), each level's sigma the SH9 rows' sigma, so the kernel walks
    the same levels at every width and the plain chain bakes them."""
    from volrend_torch.probes import bake
    tdev = make_solid_tree(max_depth=3, basis_dim=9, seed=7).to_device(
        lut_depth=None, device=torch.device("cpu"))
    bmap = slab_grad.build_bake_map(tdev)
    pyrs = bake.width_pyramids(tdev, bmap, (4, 19, 28))
    sig28 = slab_grad.bake_from_pyramid_ref(*pyrs[28])[..., -1]
    for D, (pyr, bm) in pyrs.items():
        assert bm == dataclasses.replace(bmap, D=D)
        assert [p.shape for p in pyr] == [m.shape[:3] + (D,)
                                          for m in bmap.masks]
        out = slab_grad.bake_from_pyramid_ref(pyr, bm)
        assert out.shape == (bmap.G,) * 3 + (D,)
        assert torch.equal(out[..., -1], sig28)


def test_probe_bound_counts_the_masks_the_walk_reads():
    """probes/bake.py's bound (chip_smoke.py's too): the bake and its bit
    words written, each level's leaves' records read once, and the masks
    of the walked levels but the finest: neither the leafless coarsest
    level's nor the finest's, which the walk never reads."""
    from volrend_torch.probes import bake
    tdev = make_solid_tree(max_depth=3, basis_dim=9, seed=7).to_device(
        lut_depth=None, device=torch.device("cpu"))
    bmap = slab_grad.build_bake_map(tdev)
    G, D = bmap.G, bmap.D
    sides = [m.shape[0] for m in bmap.masks]
    assert bmap.sizes[0] == 0 and sides[-1] == G
    read = sum(B ** 3 for B in sides[1:-1])
    assert bake.bound_bytes(bmap) == (G ** 3 * D * 4 + G * G * 4
                                      + sum(bmap.sizes) * D * 4 + read)


def test_probe_block_stats_name_the_slowest_tile():
    """probes/display_march's per-block clock summary: the slowest block's
    tile from its block index (tile-major, poses fastest), with the
    means beside it."""
    from volrend_torch.probes import display_march as dm
    n = len(dm.PARTS)
    P, ntx, tiles = 2, 8, 16
    rows = np.ones((P * tiles, len(dm.SLOTS)), np.int64)
    rows[:, n] = 100
    rows[:, n + 1:n + 4] = (4, 4, 1)
    slow = 11 * P + 1   # tile 11 of pose 1: tile row 1, column 3
    rows[slow, n] = 900
    rows[slow, n + 1:n + 4] = (64, 64, 16)
    st = dm.block_stats(rows, P, ntx)
    assert st["loop_max"] == 900 and st["slowest"]["pose"] == 1
    assert st["slowest"]["tile_rows"] == [8, 15]
    assert st["slowest"]["tile_cols"] == [96, 127]
    assert st["slowest"]["slabs"] == 64 and st["slowest"]["windows"] == 16
    assert st["max_over_mean"] == pytest.approx(900 / rows[:, n].mean())


def test_display_march_parent_turns_write_nothing_into_the_parent(
        monkeypatch, tmp_path):
    """probes/display_march --parent: four turns, parent first, each this
    file run in the checkout's root with the root first on PYTHONPATH and
    this checkout's scene caches handed by ``--caches``; no file lands in
    the parent's tree, and the turns' JSON and logs go beside --out."""
    import json
    import subprocess
    import chip_smoke
    from volrend_torch.probes import display_march as dm
    parent = tmp_path / "parent"
    parent.mkdir()
    monkeypatch.setattr(dm.c, "get_tree", lambda: None)
    monkeypatch.setattr(chip_smoke, "ndc_tree", lambda: None)
    runs = []

    def fake_run(cmd, cwd, env, **kw):
        runs.append((cmd, cwd, env["PYTHONPATH"]))
        with open(cmd[cmd.index("--out") + 1], "w") as fh:
            json.dump({"options": {"rot": {"ms": 1.0,
                                           "render_image_ms": 2.0}}}, fh)
        return subprocess.CompletedProcess(cmd, 0, stdout="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    out = tmp_path / "logs" / "dm.json"
    res = dm.parent_turns(str(parent), str(out))
    assert [t["tag"] for t in res["turns"]] == ["parent", "change",
                                                 "change", "parent"]
    assert list(parent.iterdir()) == []
    roots = {"parent": str(parent), "change": dm.c._ROOT}
    for (cmd, cwd, path), tag in zip(runs, ("parent", "change", "change",
                                            "parent")):
        assert cwd == path == roots[tag]
        assert cmd[cmd.index("--caches") + 1].split(",") == [
            dm.c.CACHE, chip_smoke.CACHE_NDC]
        assert cmd[cmd.index("--out") + 1].startswith(str(out.parent))
    assert len(list(out.parent.glob("display_turn*.log"))) == 4
