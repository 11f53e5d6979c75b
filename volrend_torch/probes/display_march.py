"""Kernel M's display mode by part of its job loop: the evidence behind the
design of its f16-route and bf16-shading variants.

Builds ``csrc/slab_march_display.cu`` with ``-DVT_DM_CYCLES`` (thread 0's
clock cycles by part of the job loop, ``DClock``: the block's set-up, the
walk to the next job and its footprint, issuing the next job's copies,
waiting for them, shading, each of the three barriers, the tap sums and
the composite; the jobs, slabs, windows and stages each block walked: a
stage is one round of copies and its end barrier, a job in the display
kernel, a run of pieces in the RGBA kernel) into
``build/volrend_torch/display_march/``, apart from ``kernels.SOURCES``;
the port's ``march_slabs`` runs on that build (it stands in for the
port's library).
On the dense orbit's group 0 (bench.py's scene, G=256 SH16, gi=256; the
int8 and the f16 bake), four poses spread over the group and the whole
group, through SH-int8 (the default), SH-bf16 (the f16 route) and bf16
shading on both payloads. Each launch's time, its parts summed over the
blocks, the loop's cycles summed and the slowest block's (with its parts,
jobs and slabs), the jobs, slabs and windows summed and the most a block
walked, and its largest difference from the port's own build (the same
arithmetic: freeze flips aside, it should be 0).

``--modes package`` times only ``march_slabs`` on the package's own
libraries, and the whole int8 and f16 routes (the 200 orbit poses through
``render_frames``, RGBA8, gi=256, Mrays/s), so the same file times another
checkout of the package: run it by path with that checkout first on
``PYTHONPATH``. Every time is the card's: CUDA events around back-to-back
calls queued behind a device sleep, median of three; the routes also as
chip_smoke.py's main path times them, queued from the host
(``route_mrays``).

``--modes options`` takes the viewer's one-pose launches of kernel M's
display option variants, as chip_smoke.py's phase 12 (c)/(d) builds
them (``OPTION_CASES``: rot_dirs, the basis window (0, 8) and the
render_bbox 0.25-0.75 on the dense int8 grid's pose 0, and bench.py's NDC
pose with the viz options), beside the default variant's one-pose launch
and a 4-pose option launch: each launch's time (``march_slabs`` as the
package makes it) and ``render_image``'s end to end (host clock around
the call and a synchronize, median of REPS_E2E after a warm call); with
``clock`` also its clock build's per-block loop cycles (mean, p99, the
slowest block and its tile), windows, slabs and pieces walked: a launch
of fewer tiles than resident blocks lasts as long as its slowest block.
``--modes rgba`` takes chip_smoke.py phase 12 (b)'s RGBA tree
(``_common.format_trees``: the dense scene's leaves as plain colours) on
its int8 and f16 bakes, and the SH16 default beside it (int8), each on
orbit group 0 whole, four poses spread over it and pose 0 alone
(``RGBA_CASES``): each launch's time and variant, render_image's end to
end for pose 0, and with ``clock`` its clock build's parts summed and
their shares, pieces a slab and the slowest block against the mean.
``--alt "NAME=FLAGS[@BLOCKS];..."`` with ``--modes rgba`` builds the
display source again with each set of flags (the RGBA kernel's
``-DVT_RG_NJ``, pieces a job; no flags: the port's own build) and times
the RGBA launches on each build in turns with the port's, at ``BLOCKS``
blocks an SM where given (2 or 3, ``rgba_blocks``; else the rule's).
``--parent DIR`` runs the options mode (or, with ``--modes rgba``, the
RGBA cases) in turns (parent, change, change, parent), each turn this
file run by path in a process with that checkout's root first on
``PYTHONPATH`` (the package's own launches, no clock), logs beside
``--out``. Every turn reads this checkout's scene caches (``--caches``),
so nothing is written into the parent's tree but its own kernels' build.

Run on a card from the root of the checkout::

    python -m volrend_torch.probes.display_march [--modes probe,package]
        [--modes rgba[,clock]] [--parent DIR] [--out display_march.json]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from volrend_torch import kernels
from volrend_torch.probes import _common as c
from volrend_torch.probes.display_tiles import device_ms

GI = 256
N_POSES = 200
#: the launches' variants: (name, payload, bf16 shading)
VARIANTS = (("SH-int8", "int8", False), ("SH-bf16", "f16", False),
            ("SH-int8-bf16shade", "int8", True),
            ("SH-bf16-bf16shade", "f16", True))
#: the clock's parts (csrc/slab_march_display.cu DPart), then the loop's
#: cycles and the counts a block keeps
PARTS = ("prologue", "walk", "issue", "wait", "shade", "barrier_window",
         "barrier_shade", "barrier_end", "taps", "composite")
SLOTS = PARTS + ("loop", "jobs", "slabs", "windows", "stages")
_NAME = "slab_march_display"
#: the one-pose launches of the option variants (chip_smoke.py phase 12
#: (c)/(d)) and their yardsticks: (name, scene, render options, poses)
OPTION_CASES = (
    ("rot", "dense", dict(rot_dirs=(0.3, -0.2, 0.5)), 1),
    ("window", "dense", dict(basis_minmax=(0, 8)), 1),
    ("bbox", "dense", dict(render_bbox=(0.25,) * 3 + (0.75,) * 3), 1),
    ("ndc-viz", "ndc", dict(rot_dirs=(0.25, -0.15, 0.3),
                            render_bbox=(0.1, 0.1, 0.0, 0.9, 0.9, 1.0),
                            basis_minmax=(0, 2)), 1),
    ("default", "dense", {}, 1),
    ("rot-4poses", "dense", dict(rot_dirs=(0.3, -0.2, 0.5)), 4),
)
#: render_image calls a case's end-to-end time is the median of
REPS_E2E = 30
#: the RGBA launches and the SH16 default's beside them: (name, tree,
#: bake, poses of orbit group 0: the group whole, four spread over it, or
#: orbit pose 0 alone)
RGBA_CASES = tuple(
    (f"{tree}-{dt} {n}", tree, dt, n)
    for tree, dt in (("RGBA", "int8"), ("RGBA", "f16"), ("SH16", "int8"))
    for n in ("group", "4 poses", "pose 0"))


def start_build():
    """Start compiling the probe build (one nvcc, the port's flags and
    -DVT_DM_CYCLES) unless it is built: keyed, as the port's libraries
    are, by the source, the shared headers and the flags. ``load`` waits
    for it."""
    out = kernels.build_dir() / "display_march" / kernels._target(
        _NAME).name.replace(f"lib{_NAME}_", f"lib{_NAME}_cycles_")
    return c.start_nvcc(out, kernels._CSRC / kernels.SOURCES[_NAME][0],
                        ("-DVT_DM_CYCLES",))


def build():
    """The probe build, compiled and loaded (a CDLL)."""
    return load(start_build())


def load(started):
    """Wait for ``start_build``'s compile and load the library (raises with
    the log if the build failed)."""
    lib = c.typed_lib(c.finish_nvcc(
        started, "display_march: the probe build"), _NAME)
    lib.vt_display_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.vt_display_cycles.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def standing_in(lib):
    """The port's display launches take ``lib`` (a probe build) while the
    block runs."""
    saved = kernels._LIBS.get(_NAME)
    kernels._LIBS[_NAME] = lib
    try:
        yield
    finally:
        if saved is None:
            kernels._LIBS.pop(_NAME, None)
        else:
            kernels._LIBS[_NAME] = saved


@contextlib.contextmanager
def rgba_blocks(blocks):
    """RGBA's kernel of its own takes ``blocks`` blocks an SM (2 or 3;
    None: display_config's rule) while the block runs: display_config
    stands in by one that decides its rule for a card of no SMs (every
    launch past one wave: three) or of more SMs than any launch has
    blocks (two)."""
    from volrend_torch.ops import slab_march
    own = slab_march.display_config
    n_sm = {None: None, 2: 1 << 30, 3: 0}[blocks]

    def config(P, gi, n_win, Dp, sm, *a, **k):
        return own(P, gi, n_win, Dp,
                   sm if n_sm is None or not k.get("raw") else n_sm, *a, **k)

    slab_march.display_config = config
    try:
        yield
    finally:
        slab_march.display_config = own


def read_cycles(lib, n_blocks: int) -> np.ndarray:
    """The build's rows of the last launch's ``n_blocks`` blocks (read and
    cleared): (n_blocks, len(SLOTS)) int64."""
    torch.cuda.synchronize()
    out = np.zeros((n_blocks, len(SLOTS)), np.uint64)
    kernels.check(lib.vt_display_cycles(out.ctypes.data, n_blocks), _NAME)
    return out.astype(np.int64)


def summarize(rows: np.ndarray) -> dict:
    """A launch's clock rows as the probe reports them: each part and the
    loop summed over the blocks (thread 0's cycles), each part's share of
    the summed loop, the slowest block's loop and parts, and the jobs,
    slabs and windows summed, a block's mean and most."""
    n = len(PARTS)
    loop = rows[:, n]
    slow = int(np.argmax(loop))
    out = {"blocks": int(len(rows)),
           "cycles": {k: int(v) for k, v in zip(PARTS, rows[:, :n].sum(0))},
           "loop_sum": int(loop.sum()), "loop_max": int(loop[slow])}
    out["share"] = {k: round(v / max(out["loop_sum"], 1), 4)
                    for k, v in out["cycles"].items()}
    out["slowest"] = {k: int(v) for k, v in zip(SLOTS, rows[slow])}
    for i, k in enumerate(("jobs", "slabs", "windows", "stages")):
        col = rows[:, n + 1 + i]
        out[k] = {"sum": int(col.sum()), "mean": float(col.mean()),
                  "max": int(col.max())}
    out["pieces_a_slab"] = out["jobs"]["sum"] / max(out["slabs"]["sum"], 1)
    out["slabs_a_stage"] = (out["slabs"]["sum"]
                            / max(out["stages"]["sum"], 1))
    return out


class Launch:
    """One display launch of ``cams`` on ``grid`` (its payload cached in
    ``pays``), with or without bf16 shading, as the display path makes
    it: with ``opt``'s rot_dirs, basis window and render_bbox, kernel M's
    option variants where they are not the defaults."""

    def __init__(self, name, grid, cams, opt, pays, bf16_shade=False):
        from volrend_torch.ops import slab_render
        from volrend_torch.ops.render_exact import _rodrigues_matrix
        self.name, self.grid, self.cams, self.opt = name, grid, cams, opt
        self.P, self.bf16_shade = len(cams), bf16_shade
        c0 = cams[0]
        perm, flip, _ = slab_render.choose_axis(grid, c0.transform, c0.fx,
                                                c0.fy, c.W, c.H)
        if perm not in pays:
            pays[perm] = slab_render.prepare_payload(grid, perm, opt)
        self.pay, self.perm, self.flip = pays[perm], perm, flip
        self.crop = slab_render.inplane_crop(grid, perm,
                                             float(opt.sigma_thresh))
        tr = torch.as_tensor(np.stack([x.transform for x in cams]),
                             dtype=torch.float32, device=self.pay.device)
        geom = slab_render.FrameGeom(grid, tr, c0.fx, c0.fy, perm, flip,
                                     c.W, c.H, opt, GI)
        self.params, self.zb = slab_render._march_frame_fields(
            grid, geom, perm, flip, opt)
        self.slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)
        rotm = _rodrigues_matrix(opt.rot_dirs)
        self.options = dict(
            rot=(None if rotm is None
                 else tuple(float(v) for v in rotm.reshape(-1))),
            bbox_full=slab_render._bbox_full(opt),
            basis_lo=int(opt.basis_minmax[0]),
            basis_hi=int(opt.basis_minmax[1]))

    def __call__(self):
        from volrend_torch.ops import slab_march
        g = self.grid
        return slab_march.march_slabs(
            self.pay, self.params, g.qscale, self.zb, g.G, GI, g.data_dim,
            g.basis_dim, self.perm, slab_ids=self.slab_ids,
            sig2=g.quantized, fmt=int(g.fmt), extra=g.extra, flip=self.flip,
            dir_win=True, shade_bf16=self.bf16_shade,
            k_per_step=slab_march._K_STEP, crop=self.crop, **self.options)

    def frame(self):
        """render_image of the first camera, as the viewer renders it."""
        from volrend_torch.ops import slab_render
        return slab_render.render_image(self.grid, self.cams[0], self.opt,
                                        gi=GI, out_dtype=torch.uint8)


def scene(dev, opt):
    """The dense scene's int8 and f16 bakes, the orbit's cameras and the
    launches of its group 0 for each variant: {variant: [Launch]}."""
    from volrend_torch.ops import dense_grid
    tdev = c.get_tree().to_device(lut_depth=None, device=dev)
    grids = {dt: dense_grid.bake_dense(tdev, dtype=dt)
             for dt in ("int8", "f16")}
    del tdev
    cams = c.orbit_poses(N_POSES)
    first = next(iter(c.pose_groups(grids["int8"], cams).values()))
    spread = np.unique(np.linspace(0, len(first) - 1, 4).round())
    sets = ((f"{len(first)} poses", [cams[i] for i in first]),
            ("4 poses", [cams[first[int(i)]] for i in spread]))
    pays = {dt: {} for dt in grids}
    out = {}
    for name, dt, bsh in VARIANTS:
        out[name] = [Launch(f"{name} group 0, {tag}", grids[dt], sub, opt,
                            pays[dt], bsh) for tag, sub in sets]
    return grids, cams, out


def route_mrays(grid, cams, opt) -> dict:
    """The display route over ``cams`` (render_frames a (perm, flip) group,
    RGBA8 at gi=256, payloads and transforms prepared once): the card's
    time of all groups queued behind a device sleep and its Mrays/s
    (``ms``, ``mrays``), and as chip_smoke.py's main path times it, CUDA
    events recorded around the run from the host, median of three after a
    warm run (``host_ms``, ``host_mrays``)."""
    from volrend_torch.ops import slab_render
    dev = grid.data.device
    groups = c.pose_groups(grid, cams)
    pays = {perm: slab_render.prepare_payload(grid, perm, opt)
            for perm, _ in groups}
    trs = {k: (c.transforms(cams, v, dev),
               torch.as_tensor(v, dtype=torch.int64, device=dev))
           for k, v in groups.items()}
    out = torch.empty((len(cams), c.H, c.W, 4), dtype=torch.uint8,
                      device=dev)

    def run():
        fx, fy = cams[0].fx, cams[0].fy
        for perm, flip in groups:
            tr, idx = trs[(perm, flip)]
            out[idx] = slab_render.render_frames(
                grid, tr, fx, fy, perm, flip, c.W, c.H, opt, gi=GI,
                payload=pays[perm], out_dtype=torch.uint8)

    ms = device_ms(run, 1)
    run()
    ts = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    host = float(np.median(ts))
    rays = len(cams) * c.W * c.H
    return {"ms": ms, "mrays": rays / ms / 1e3, "host_ms": host,
            "host_mrays": rays / host / 1e3}


def e2e_ms(fn, reps: int = REPS_E2E) -> float:
    """A viewer's wait for ``fn()``: host clock around the call and a
    synchronize, median of ``reps`` after a warm call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ts))


def block_stats(rows: np.ndarray, P: int, ntx: int) -> dict:
    """A launch's per-block clock rows: the loop's cycles (mean, p99, the
    slowest block with its tile, pose and parts), and the windows, slabs
    and pieces (jobs) walked, mean and the slowest block's."""
    n = len(PARTS)
    loop = rows[:, n].astype(np.float64)
    slow = int(np.argmax(loop))
    tile, pose = divmod(slow, P)
    jobs, slabs, wins = (rows[:, n + 1 + i] for i in range(3))
    return {
        "blocks": int(len(rows)), "loop_mean": float(loop.mean()),
        "loop_p99": float(np.percentile(loop, 99)),
        "loop_max": int(loop[slow]),
        "max_over_mean": float(loop[slow] / max(loop.mean(), 1.0)),
        "slowest": {"block": slow, "pose": pose,
                    "tile_rows": [tile // ntx * 8, tile // ntx * 8 + 7],
                    "tile_cols": [tile % ntx * 32, tile % ntx * 32 + 31],
                    "windows": int(wins[slow]), "slabs": int(slabs[slow]),
                    "pieces": int(jobs[slow]),
                    "parts": {k: int(v) for k, v in zip(PARTS, rows[slow])}},
        "windows_mean": float(wins.mean()), "slabs_mean": float(slabs.mean()),
        "pieces_mean": float(jobs.mean())}


def option_scene(dev, opt):
    """The option cases' launches: {name: Launch} on the dense int8
    grid (orbit pose 0, or four poses spread over its group) and the NDC
    tree's int8 grid (bench.py's NDC pose)."""
    import dataclasses
    import chip_smoke
    from volrend_torch.ops import dense_grid
    from volrend_torch.ops.camera import Camera
    tdev = c.get_tree().to_device(lut_depth=None, device=dev)
    dense = dense_grid.bake_dense(tdev, dtype="int8")
    del tdev
    ndev = chip_smoke.ndc_tree().to_device(lut_depth=None, device=dev)
    ndc = dense_grid.bake_dense(ndev, dtype="int8")
    del ndev
    cams = c.orbit_poses(N_POSES)
    first = next(iter(c.pose_groups(dense, cams).values()))
    four = [cams[first[int(i)]] for i in
            np.unique(np.linspace(0, len(first) - 1, 4).round())]
    ncam = chip_smoke.bench_ndc_pose(Camera)
    pays = {"dense": {}, "ndc": {}}
    out = {}
    for name, where, o, P in OPTION_CASES:
        grid = ndc if where == "ndc" else dense
        sub = [ncam] if where == "ndc" else (four if P == 4 else cams[:1])
        out[name] = Launch(name, grid, sub, dataclasses.replace(opt, **o),
                           pays[where])
    return out


def run_options(dev, opt, modes, lib=None) -> dict:
    """The option cases (OPTION_CASES) with the render options ``opt``
    besides each case's: each launch's time and render_image's end to
    end, and with ``clock`` in ``modes`` the clock build's per-block rows
    of each launch."""
    from volrend_torch.ops import slab_march
    launches = option_scene(dev, opt)
    res = {}
    for name, ln in launches.items():
        ln()
        cfg = dict(slab_march.march_slabs.display)
        res[name] = {"variant": cfg["variant"], "poses": ln.P,
                     "ms": device_ms(ln), "render_image_ms": e2e_ms(ln.frame)}
        c.log(f"display_march options {name} {json.dumps(res[name])}")
    if "clock" in modes:
        lib = build() if lib is None else lib
        ntx = -(-GI // 32)
        with standing_in(lib):
            for name, ln in launches.items():
                ln()
                res[name]["clock"] = block_stats(
                    read_cycles(lib, ln.P * ntx * -(-GI // 8)), ln.P, ntx)
                c.log(f"display_march options {name} clock "
                      f"{json.dumps(res[name]['clock'])}")
    return res


def start_alt(flags: str):
    """Start compiling the display source with the port's flags and
    ``flags`` (an alternative build: ``-DVT_RG_*`` macros of the RGBA
    kernel), keyed by the source, headers and flags, unless it is
    built."""
    key = hashlib.sha256(flags.encode()).hexdigest()[:8]
    out = kernels.build_dir() / "display_march" / kernels._target(
        _NAME).name.replace(f"lib{_NAME}_", f"lib{_NAME}_alt{key}_")
    return c.start_nvcc(out, kernels._CSRC / kernels.SOURCES[_NAME][0],
                        tuple(flags.split()))


def parse_alts(spec: str):
    """``--alt``'s builds: "NAME=FLAGS[@BLOCKS];..." -> [(name, flags,
    the RGBA launches' blocks an SM, 2 or 3, or None for the rule)]; empty
    flags: the port's own build."""
    out = []
    for item in filter(None, (x.strip() for x in spec.split(";"))):
        name, rest = item.split("=", 1)
        flags, _, blocks = rest.partition("@")
        out.append((name, flags.strip(), int(blocks) if blocks else None))
    return out


def rgba_scene(dev, opt):
    """The RGBA cases' launches (RGBA_CASES): {name: Launch}."""
    from volrend_torch.ops import dense_grid
    tdev = c.get_tree().to_device(lut_depth=None, device=dev)
    trees = {"SH16": tdev, "RGBA": c.format_trees(tdev)["RGBA"]}
    grids = {}
    for _, tree, dt, _ in RGBA_CASES:
        if (tree, dt) not in grids:
            grids[(tree, dt)] = dense_grid.bake_dense(trees[tree], dtype=dt)
    del tdev, trees
    cams = c.orbit_poses(N_POSES)
    first = next(iter(c.pose_groups(grids[("SH16", "int8")],
                                    cams).values()))
    spread = np.unique(np.linspace(0, len(first) - 1, 4).round())
    sets = {"group": [cams[i] for i in first],
            "4 poses": [cams[first[int(i)]] for i in spread],
            "pose 0": cams[:1]}
    pays = {k: {} for k in grids}
    return {name: Launch(name, grids[(tree, dt)], sets[n], opt,
                         pays[(tree, dt)])
            for name, tree, dt, n in RGBA_CASES}


def run_rgba(dev, opt, modes, lib=None, alts=()) -> dict:
    """The RGBA cases (RGBA_CASES): each launch's variant, tile height and
    time, render_image's end to end for pose 0, and with ``clock`` in
    ``modes`` its clock build's rows summed (``summarize``) with the
    slowest block against the mean and the largest difference from the
    port's own build; ``alts`` (``parse_alts``): each alternative build's
    time of the RGBA launches, in turns with the port's (port, alt, alt,
    port), and its largest difference from the port's output."""
    from volrend_torch.ops import slab_march
    # the probe builds compile while the port's library builds and runs
    started = start_build() if "clock" in modes and lib is None else None
    alt_started = [(n, start_alt(f) if f else None, b) for n, f, b in alts]
    launches = rgba_scene(dev, opt)
    res, own = {}, {}
    for name, ln in launches.items():
        own[name] = ln()
        cfg = dict(slab_march.march_slabs.display)
        res[name] = {"variant": cfg["variant"], "rows": cfg["rows"],
                     "poses": ln.P, "ms": device_ms(ln),
                     "render_image_ms": (e2e_ms(ln.frame) if ln.P == 1
                                         else None)}
        c.log(f"display_march rgba {name} {json.dumps(res[name])}")
    if "clock" in modes:
        lib = load(started) if lib is None else lib
        ntx = -(-GI // 32)
        with standing_in(lib):
            for name, ln in launches.items():
                acc = ln()
                rows = res[name]["rows"]
                cyc = read_cycles(lib, ln.P * ntx * -(-GI // (8 * rows)))
                st = block_stats(cyc, ln.P, ntx)
                res[name]["clock"] = {
                    **summarize(cyc), "loop_mean": st["loop_mean"],
                    "max_over_mean": st["max_over_mean"],
                    "max_abs_diff_own_build": float(
                        (acc - own[name]).abs().max())}
                c.log(f"display_march rgba {name} clock "
                      f"{json.dumps(res[name]['clock'])}")
    for aname, st, blocks in alt_started:
        alib = (kernels.lib(_NAME) if st is None else c.typed_lib(
            c.finish_nvcc(st, f"display_march: alt {aname}"), _NAME))
        for name, ln in launches.items():
            if not name.startswith("RGBA"):
                continue
            ts = {"port": [], aname: []}
            for tag in ("port", aname, aname, "port"):
                if tag == "port":
                    ts[tag].append(device_ms(ln))
                    continue
                with rgba_blocks(blocks), standing_in(alib):
                    ts[tag].append(device_ms(ln))
                    acc = ln()
                    cfg = dict(slab_march.march_slabs.display)
            row = {"ms": ts, "rows": cfg["rows"],
                   "blocks": cfg.get("blocks"), "max_abs_diff_port": float(
                       (acc - own[name]).abs().max())}
            res[name].setdefault("alts", {})[aname] = row
            c.log(f"display_march rgba {name} alt {aname} {json.dumps(row)}")
    return res


def parent_turns(parent: str, out_path, mode: str = "options") -> dict:
    """The options mode (or ``mode`` "rgba", the RGBA cases) in turns:
    parent, change, change, parent, each a process running this file by
    path with the checkout's root first on ``PYTHONPATH``. Every turn
    reads this checkout's scene caches (``--caches``; made here first
    where missing) and writes no bytecode, so the parent's turns write
    nothing into the parent's tree but its kernels' build; the turns'
    JSON and logs go beside ``out_path``."""
    import chip_smoke
    roots = {"parent": os.path.abspath(parent), "change": c._ROOT}
    c.get_tree(), chip_smoke.ndc_tree()  # the caches, made where missing
    caches = f"{c.CACHE},{chip_smoke.CACHE_NDC}"
    log_dir = os.path.dirname(os.path.abspath(out_path or "x.json"))
    os.makedirs(log_dir, exist_ok=True)
    turns = []
    for i, tag in enumerate(("parent", "change", "change", "parent")):
        root = roots[tag]
        jpath = os.path.join(log_dir, f"display_turn{i}_{tag}.json")
        env = dict(os.environ, PYTHONPATH=root,
                   PYTHONDONTWRITEBYTECODE="1")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--modes",
             mode, "--caches", caches, "--out", jpath], cwd=root,
            env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        with open(jpath[:-5] + ".log", "w") as fh:
            fh.write(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"display_march: the {tag} turn failed "
                               f"(exit {proc.returncode}; its log "
                               f"{jpath[:-5]}.log)")
        with open(jpath) as fh:
            opts = json.load(fh)[mode]
        turns.append({"tag": tag, mode: opts})
        c.log(f"display_march turn {i} {tag}: " + "; ".join(
            f"{k} {v['ms']:.4f} ms" + (
                "" if v.get("render_image_ms") is None
                else f", render_image {v['render_image_ms']:.3f}")
            for k, v in opts.items()))
    return {"turns": turns}


def run(dev, modes, lib=None, alts=()) -> dict:
    """The probe's measurements (``modes``: probe, package, options, rgba,
    clock); ``lib``: the probe build, when already built; ``alts``: the
    rgba mode's alternative builds (``parse_alts``)."""
    from volrend_torch.utils.options import RenderOptions
    opt = RenderOptions(max_steps=1024)
    res = {"device": torch.cuda.get_device_name(0), "package": [],
           "probe": []}
    if "options" in modes:
        res["options"] = run_options(dev, opt, modes, lib)
    if "rgba" in modes:
        res["rgba"] = run_rgba(dev, opt, modes, lib, alts)
    if not {"package", "probe"} & set(modes):
        return res
    grids, cams, launches = scene(dev, opt)
    own = {}
    for name, lns in launches.items():
        for ln in lns:
            own[ln.name] = ln()
            if "package" in modes:
                row = {"launch": ln.name, "ms": device_ms(ln)}
                res["package"].append(row)
                c.log(f"display_march package {json.dumps(row)}")
    if "package" in modes:
        res["routes"] = {dt: route_mrays(g, cams, opt)
                         for dt, g in grids.items()}
        c.log(f"display_march routes {json.dumps(res['routes'])}")
    if "probe" in modes:
        from volrend_torch.ops import slab_march
        lib = build() if lib is None else lib
        with standing_in(lib):
            for name, lns in launches.items():
                for ln in lns:
                    acc = ln()
                    cfg = dict(slab_march.march_slabs.display)
                    n_blocks = ln.P * -(-GI // 32) * -(-GI // (
                        8 * cfg["rows"]))
                    cyc = summarize(read_cycles(lib, n_blocks))
                    diff = float((acc - own[ln.name]).abs().max())
                    row = {"launch": ln.name, "variant": cfg["variant"],
                           "rows": cfg["rows"], "ms": device_ms(ln),
                           "max_abs_diff_own_build": diff, **cyc}
                    read_cycles(lib, n_blocks)  # the timed runs' rows
                    res["probe"].append(row)
                    c.log(f"display_march probe {json.dumps(row)}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="probe,package",
                    help="comma-separated: probe (the clock builds), "
                         "package (march_slabs and the routes as built), "
                         "options (the one-pose option launches), rgba "
                         "(the RGBA tree's launches beside SH16's), clock "
                         "(the options' or rgba's clock build)")
    ap.add_argument("--parent", default=None,
                    help="run the options mode (or, with --modes rgba, "
                         "the RGBA cases) in turns with this parent "
                         "checkout")
    ap.add_argument("--alt", default="",
                    help="with --modes rgba: alternative builds of the "
                         "display source timed against the port's, "
                         "\"NAME=FLAGS[@BLOCKS];...\" (e.g. "
                         "\"nj1=-DVT_RG_NJ=1;b2=@2\")")
    ap.add_argument("--caches", default=None,
                    help="the dense and NDC scenes' npz files, "
                         "comma-separated, read in place of the "
                         "checkout's own (the turns of --parent)")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("display_march times kernel M on a CUDA device; "
                           "none is available")
    if args.caches:
        import chip_smoke
        c.CACHE, chip_smoke.CACHE_NDC = args.caches.split(",")
    if args.parent:
        out = parent_turns(args.parent, args.out,
                           "rgba" if "rgba" in args.modes else "options")
    else:
        out = run(torch.device("cuda"), args.modes.split(","),
                  alts=parse_alts(args.alt))
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
