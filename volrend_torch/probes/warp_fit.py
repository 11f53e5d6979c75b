"""Kernel W's fit mode (``vt_warp_fit``) on the card, against a parent's.

On the dense orbit's group 0 (bench.py's scene, G=256, gi=256, 800^2):
the whole group (51 poses), four poses spread over it and orbit pose 0
alone, and the steep pose (``display_tiles.steep_camera``: orbit pose 0
with its focal narrowed to a boundary slope in [3.6, 3.95)). For each,
the parameter rows the display path hands the fit mode
(``display_warp.display_params``) and its levels: the production cascade
(``display_warp._usable_levels``, (4, 4) x (5, 5) and (2, 2) x (4, 4)),
and a level set whose blocks do not nest in 16 pixels (``SPARE_LEVELS``:
the fit mode's other kernel). Each library's counts must equal
``level_fit_counts_ref`` bit for bit. ``--parent DIR`` also builds that
checkout's ``warp_display.cu`` and times both libraries' launches in
turns (parent, change, change, parent); without it the change alone.

Every time is the card's: CUDA events around back-to-back launches
queued behind a device sleep, median of three runs. Run on a card from
the root of the checkout::

    python -m volrend_torch.probes.warp_fit [--parent DIR] [--out fit.json]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os

import numpy as np
import torch

from volrend_torch.probes import _common as c
from volrend_torch.probes.display_tiles import device_ms, steep_camera

GI = 256
N_POSES = 200
REPS = 50
#: a level set the production cascade's nested kernel does not take: the
#: blocks' common super block is 20 x 20 pixels
SPARE_LEVELS = (((4, 4), (5, 5)), ((5, 5), (6, 6)))
_SRC = os.path.join("volrend_torch", "csrc", "warp_display.cu")


def start_lib(root: str, tag: str):
    """Start compiling ``root``'s warp_display.cu with the port's nvcc
    flags into build/volrend_torch/fit_probe/ (keyed by the source)
    unless it is built (``_common.start_nvcc``)."""
    from volrend_torch import kernels
    src = os.path.join(root, _SRC)
    with open(src, "rb") as fh:
        key = hashlib.sha256(fh.read()).hexdigest()[:16]
    return c.start_nvcc(kernels.build_dir() / "fit_probe" / (
        f"libwarp_display_{tag}_{key}.so"), src)


def fit_counts(lib, prm, levels, height: int, width: int) -> torch.Tensor:
    """(L, P) int32 misfit counts from ``lib``'s vt_warp_fit, as
    ``display_warp.level_fit_counts`` launches it."""
    from volrend_torch import kernels
    from volrend_torch.ops.display_warp import _block2d, _win2d
    P = prm.shape[0]
    counts = torch.zeros((len(levels), P), dtype=torch.int32,
                         device=prm.device)
    dims = [d for B, win in levels for d in _block2d(B) + _win2d(win)]
    kernels.check(lib.vt_warp_fit(
        prm.data_ptr(), counts.data_ptr(), P, len(levels),
        (ctypes.c_int * len(dims))(*dims), GI, height, width,
        torch.cuda.current_stream(prm.device).cuda_stream), "warp_display")
    return counts


def cases(dev):
    """{name: (P, 16) parameter rows}: orbit group 0 whole, four poses
    spread over it, orbit pose 0, and the steep pose."""
    from volrend_torch.ops import display_warp, slab_render
    from volrend_torch.utils.options import RenderOptions
    grid = c.dense_grid_on(dev)
    opt = RenderOptions(max_steps=1024)
    cams = c.orbit_poses(N_POSES)
    first = next(iter(c.pose_groups(grid, cams).values()))
    spread = np.unique(np.linspace(0, len(first) - 1, 4).round())
    sets = {"group": [cams[i] for i in first],
            "4 poses": [cams[first[int(i)]] for i in spread],
            "pose 0": cams[:1], "steep": [steep_camera(grid)]}
    out = {}
    for name, sub in sets.items():
        c0 = sub[0]
        perm, flip, _ = slab_render.choose_axis(grid, c0.transform, c0.fx,
                                                c0.fy, c.W, c.H)
        tr = torch.as_tensor(np.stack([x.transform for x in sub]),
                             dtype=torch.float32, device=dev)
        g = slab_render.FrameGeom(grid, tr, c0.fx, c0.fy, perm, flip, c.W,
                                  c.H, opt, GI)
        out[name] = display_warp.display_params(g.R, g.fx, g.fy, g.u0, g.du,
                                                g.v0, g.dv, g.scale, perm)
    del grid
    return out


def run(dev, parent=None) -> dict:
    from volrend_torch import kernels
    from volrend_torch.ops import display_warp
    started = start_lib(parent, "parent") if parent else None
    libs = {"change": kernels.lib("warp_display")}
    prms = cases(dev)
    if started is not None:
        libs["parent"] = c.typed_lib(c.finish_nvcc(
            started, "warp_fit: the parent's build"), "warp_display")
    order = [k for k in ("parent", "change") if k in libs]
    sets = {"production": display_warp._usable_levels(c.W, c.H, GI),
            "spare": SPARE_LEVELS}
    out = {"device": torch.cuda.get_device_name(0), "cases": {}}
    for name, prm in prms.items():
        for lname, levels in sets.items():
            want = display_warp.level_fit_counts_ref(prm, levels, GI, c.H,
                                                     c.W)
            row = {"poses": prm.shape[0], "levels": [list(map(list, lv))
                                                     for lv in levels]}
            for tag, lib in libs.items():
                got = fit_counts(lib, prm, levels, c.H, c.W)
                row[f"{tag}_bit_equal"] = bool(torch.equal(got, want))
                if not row[f"{tag}_bit_equal"]:
                    raise SystemExit(f"warp_fit: the {tag} fit counts "
                                     f"differ from the plain version at "
                                     f"{name}, {lname} levels")
            row["misfits"] = want.sum(1).tolist()
            row["ms"] = {k: [] for k in order}
            for tag in order + order[::-1]:
                row["ms"][tag].append(device_ms(
                    lambda: fit_counts(libs[tag], prm, levels, c.H, c.W),
                    REPS))
            out["cases"][f"{name}, {lname}"] = row
            c.log(f"warp_fit [{name}, {lname}]: {json.dumps(row)}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a parent checkout whose fit mode is timed in "
                         "turns with this one's")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_fit: needs a CUDA device")
    out = run(torch.device("cuda"), args.parent)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
