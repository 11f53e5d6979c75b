"""The training bench's forward bake and coarse occupancy on the card.

On the training bench's pyramid (``make_solid_tree(max_depth=7,
basis_dim=9, seed=7)``, G=256 SH9, f32 levels, as ``FrameTrainer`` holds
them; the scene from the smoke's npz cache), traces the plain forward
bake (``slab_grad.bake_from_pyramid_ref``: the coarse-to-fine expand /
where chain the port ran before the bake kernel) with torch.profiler and
logs its device time by launch. With ``--kernel`` it also traces and
times the bake kernel (``csrc/bake_pyramid.cu``) with and without its
live bits, and the
coarse occupancy in both modes for each of the six view permutations (the
bits mode, ``vt_march_occupancy_live``, equal to the full read of the
bake's sigma, ``vt_march_occupancy``, bit for bit).

``--widths`` takes the kernel at each record width D of the list: 28 is
the bench's SH9, 4 its leaves read as RGBA and 19 as SG6
(``_common.format_trees``, as chip_smoke.py's phase 12b reads them), each
on the same levels and masks. At each width the kernel's bake and live
bits must equal the plain chain's (``bake_from_pyramid_ref``,
``live_bits_ref``) bit for bit, and a probe build of the same source
with ``-DVT_BK_LEVEL_KNOWN`` (each voxel's level read from a stored
(G, G, G) level map, ``slab_grad.level_map``, handed in place of the
finest mask: one coalesced load instead of the walk; bit-equal too)
times the launch without its level walk. ``--parent DIR`` also builds
that checkout's ``bake_pyramid.cu`` (and its level-known build, where
its source has the macro) and times both kernels in turns (parent,
change, change, parent), each held to the plain chain bit for bit. Each
width's bound is chip_smoke.py's (``bound_bytes`` at 3.35 TB/s).

Every time is the card's: CUDA events around back-to-back launches queued
behind a device sleep, median of three runs. Run on a card from the root of
the checkout::

    python -m volrend_torch.probes.bake [--kernel] [--widths 4,19,28]
        [--parent DIR] [--out bake.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import os

import torch

from volrend_torch.probes import _common as c
from volrend_torch.probes.display_tiles import device_ms
from volrend_torch.utils.options import RenderOptions

CACHE_TRAIN = os.path.join(c._ROOT, ".torch_bench_train_cache.npz")
SIGMA_THRESH = RenderOptions().sigma_thresh  # the training bench's
#: the probe build's macro: every voxel's level taken as the finest
LEVEL_KNOWN = "-DVT_BK_LEVEL_KNOWN"
_SRC = os.path.join("volrend_torch", "csrc", "bake_pyramid.cu")


def bound_bytes(bmap) -> int:
    """The bytes the bake of ``bmap`` must move (its bound, chip_smoke.py's
    too): the bake and its live bits written, each level's masked records
    read once, and the masks of the walked levels but the finest (a voxel
    no coarser level covers is the finest's, so its mask decides
    nothing)."""
    from volrend_torch.ops import slab_grad
    G, D = bmap.G, bmap.D
    walk = slab_grad.walked_levels(bmap)
    return (G ** 3 * D * 4 + G * G * -(-G // 32) * 4
            + sum(bmap.sizes) * D * 4
            + sum(bmap.masks[j].numel() for j in walk[:-1]))


def start_lib(root: str, tag: str, flags=()):
    """Start compiling ``root``'s bake_pyramid.cu with the port's nvcc
    flags and ``flags`` into build/volrend_torch/bake_probe/ (keyed by the
    source and the flags) unless it is built (``_common.start_nvcc``)."""
    from volrend_torch import kernels
    src = os.path.join(root, _SRC)
    with open(src, "rb") as fh:
        key = hashlib.sha256(fh.read() + " ".join(flags).encode())
    return c.start_nvcc(kernels.build_dir() / "bake_probe" / (
        f"libbake_{tag}_{key.hexdigest()[:16]}.so"), src, flags)


def load_lib(started):
    """Wait for ``start_lib``'s compile and load the library."""
    return c.typed_lib(c.finish_nvcc(started, "bake: a probe build"),
                       "bake_pyramid")


def width_pyramids(tdev, bmap, widths):
    """{D: (levels, bake map)} of the bench tree's leaves at each width:
    28 its SH9 rows, 4 read as RGBA, 19 as SG6 (_common.format_trees)."""
    from volrend_torch.ops import slab_grad
    trees = {tdev.data_dim: tdev, 4: c.format_trees(tdev)["RGBA"],
             19: c.format_trees(tdev, nb=6)["SG"]}
    out = {}
    for D in widths:
        if D not in trees:
            raise SystemExit(f"bake: no width {D} (4, 19 or 28)")
        bm = dataclasses.replace(bmap, D=D)
        out[D] = (slab_grad.data_to_pyramid(trees[D].data.float(), bm), bm)
    return out


def in_turns(libs: dict, walks: dict, pyr, bmap, reps: int = 5) -> dict:
    """Each library's time in turns, each over its levels ``walks[tag]``:
    the parent (if any), then the change, then back in the reverse
    order."""
    from volrend_torch.ops import slab_grad
    order = [k for k in ("parent", "change") if k in libs]
    out = {k: [] for k in libs}
    for tag in order + order[::-1]:
        out[tag].append(device_ms(lambda: slab_grad._bake_cuda(
            pyr, bmap, SIGMA_THRESH, libs[tag], walks[tag]), reps))
    return out


def run(dev, kernel: bool, widths=(28,), parent=None) -> dict:
    from volrend_torch import kernels
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import slab_grad, slab_march
    started = {}
    if kernel:
        started["known"] = start_lib(c._ROOT, "known", (LEVEL_KNOWN,))
        if parent:
            started["parent"] = start_lib(parent, "parent")
            with open(os.path.join(parent, _SRC)) as fh:
                if "VT_BK_LEVEL_KNOWN" in fh.read():
                    started["parent_known"] = start_lib(
                        parent, "parent_known", (LEVEL_KNOWN,))
    # every kernel library loaded before the first trace (the kernel's
    # trace below saw no device activity without it)
    for name in kernels.SOURCES:
        kernels.lib(name)
    tree = c.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=7, basis_dim=9, seed=7))
    tdev = tree.to_device(lut_depth=None, device=dev)
    bmap = slab_grad.build_bake_map(tdev)
    pyrs = width_pyramids(tdev, bmap, sorted(set(widths) | {bmap.D}))
    del tdev
    G, D = bmap.G, bmap.D
    pyr = pyrs[D][0]
    c.log(f"bake: G={G} D={D}, level sizes {bmap.sizes}")
    prof = c.profile_run(lambda: slab_grad.bake_from_pyramid_ref(pyr, bmap),
                         "forward bake, plain chain", c.log)
    out = {"G": G, "D": D, "sizes": list(bmap.sizes),
           "device": torch.cuda.get_device_name(0),
           "plain_ms": device_ms(
               lambda: slab_grad.bake_from_pyramid_ref(pyr, bmap), 5),
           "plain_by_kernel": {k: v[:2] for k, v in prof.items()}}
    if not kernel:
        c.log(f"bake: {json.dumps(out)}")
        return out
    bake, live = slab_grad.bake_from_pyramid(pyr, bmap, SIGMA_THRESH)
    c.profile_run(lambda: slab_grad.bake_from_pyramid(
        pyr, bmap, SIGMA_THRESH), "forward bake, kernel", c.log)
    out["kernel_ms"] = device_ms(
        lambda: slab_grad.bake_from_pyramid(pyr, bmap), 5)
    out["kernel_live_ms"] = device_ms(
        lambda: slab_grad.bake_from_pyramid(pyr, bmap, SIGMA_THRESH), 5)
    prm = torch.full((1, 15), SIGMA_THRESH, device=dev)
    host = prm.cpu()  # the bits mode checks the threshold on the host
    qs = torch.ones(D, device=dev)
    occ = {}
    for perm in itertools.permutations(range(3)):
        view = bake.permute(perm[0], 3, perm[1], perm[2])
        full = slab_march.march_occupancy(view, prm, qs)
        bits = slab_march.march_occupancy(view, host, qs, live=live,
                                          perm=perm)
        if not torch.equal(full, bits):
            raise SystemExit(f"bake: the bits mode differs from the full "
                             f"read at perm {perm}")
        occ["".join(map(str, perm))] = {
            "full_ms": device_ms(lambda: slab_march.march_occupancy(
                view, prm, qs), 10),
            "bits_ms": device_ms(lambda: slab_march.march_occupancy(
                view, host, qs, live=live, perm=perm), 10)}
    out["occupancy"] = occ
    del bake, live
    libs = {"change": kernels.lib("bake_pyramid")}
    libs.update({k: load_lib(v) for k, v in started.items()})
    known = {k: libs.pop(k) for k in ("known", "parent_known") if k in libs}
    # the parent's kernel walks every level, this checkout's the levels
    # slab_grad.walked_levels keeps (the builds reading a level map take
    # every level: the map's indices)
    every = tuple(range(len(bmap.masks)))
    walks = {"parent": every, "change": None}
    lmap = slab_grad.level_map(bmap).view(torch.bool).unsqueeze(-1)
    out["widths"] = {}
    for Dw in widths:
        pw, bm = pyrs[Dw]
        want = slab_grad.bake_from_pyramid_ref(pw, bm)
        want_bits = slab_grad.live_bits_ref(want, SIGMA_THRESH).bits
        row = {"plain_ms": device_ms(
            lambda: slab_grad.bake_from_pyramid_ref(pw, bm), 3)}
        for tag, lib in libs.items():
            b, bits = slab_grad._bake_cuda(pw, bm, SIGMA_THRESH, lib,
                                           walks[tag])
            row[f"{tag}_bit_equal"] = bool(
                torch.equal(b, want) and torch.equal(bits, want_bits))
            if not row[f"{tag}_bit_equal"]:
                raise SystemExit(f"bake: the {tag} kernel differs from the "
                                 f"plain chain at D = {Dw}")
        del b, bits
        row["ms"] = in_turns(libs, walks, pw, bm)
        # the level map in the finest mask's place (the builds reading it)
        km = dataclasses.replace(bm, masks=bm.masks[:-1] + (lmap,))
        for tag, lib in known.items():
            b, bits = slab_grad._bake_cuda(pw, km, SIGMA_THRESH, lib, every)
            row[f"{tag}_bit_equal"] = bool(
                torch.equal(b, want) and torch.equal(bits, want_bits))
            row[f"{tag}_ms"] = device_ms(lambda: slab_grad._bake_cuda(
                pw, km, SIGMA_THRESH, lib, every), 5)
        row["bound_ms"] = bound_bytes(bm) / 3.35e12 * 1e3
        del want, want_bits
        out["widths"][str(Dw)] = row
        c.log(f"bake D={Dw}: {json.dumps(row)}")
    c.log(f"bake: {json.dumps(out)}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="store_true",
                    help="also time the bake kernel and both occupancy modes")
    ap.add_argument("--widths", default="28",
                    help="the record widths D to time the kernel at, "
                         "comma-separated (4, 19, 28)")
    ap.add_argument("--parent", default=None,
                    help="a parent checkout whose bake kernel is timed in "
                         "turns with this one's")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bake: needs a CUDA device")
    out = run(torch.device("cuda"), args.kernel,
              tuple(int(d) for d in args.widths.split(",")), args.parent)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
