"""Kernel M's display mode by part of its job loop: the evidence behind the
design of its f16-route and bf16-shading variants.

Builds ``csrc/slab_march_display.cu`` with ``-DVT_DM_CYCLES`` (thread 0's
clock cycles by part of the job loop, ``DClock``: the block's set-up, the
walk to the next job and its footprint, issuing the next job's copies,
waiting for them, shading, each of the three barriers, the tap sums and
the composite; the jobs, slabs and windows each block walked) into
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
(``route_mrays``). Run on a card from the root of the checkout::

    python -m volrend_torch.probes.display_march [--modes probe,package]
        [--out display_march.json]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess

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
SLOTS = PARTS + ("loop", "jobs", "slabs", "windows")
_NAME = "slab_march_display"


def start_build():
    """Start compiling the probe build (one nvcc, the port's flags and
    -DVT_DM_CYCLES) unless it is built: keyed, as the port's libraries
    are, by the source, the shared headers and the flags. ``load`` waits
    for it."""
    out_dir = kernels.build_dir() / "display_march"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / kernels._target(_NAME).name.replace(
        f"lib{_NAME}_", f"lib{_NAME}_cycles_")
    if out.exists():
        return out, None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return out, (tmp, subprocess.Popen(
        [kernels._nvcc(), *kernels._NVCC_FLAGS, "-DVT_DM_CYCLES", "-o",
         str(tmp), str(kernels._CSRC / kernels.SOURCES[_NAME][0])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))


def build():
    """The probe build, compiled and loaded (a CDLL)."""
    return load(start_build())


def load(started):
    """Wait for ``start_build``'s compile and load the library (raises with
    the log if the build failed)."""
    out, building = started
    if building is not None:
        tmp, proc = building
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"display_march: the probe build failed:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in kernels.SOURCES[_NAME][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
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
    for i, k in enumerate(("jobs", "slabs", "windows")):
        col = rows[:, n + 1 + i]
        out[k] = {"sum": int(col.sum()), "mean": float(col.mean()),
                  "max": int(col.max())}
    out["pieces_a_slab"] = out["jobs"]["sum"] / max(out["slabs"]["sum"], 1)
    return out


class Launch:
    """One display launch of ``cams`` on ``grid`` (its payload cached in
    ``pays``), with or without bf16 shading, as the display path makes
    it."""

    def __init__(self, name, grid, cams, opt, pays, bf16_shade):
        from volrend_torch.ops import slab_render
        self.name, self.grid, self.P = name, grid, len(cams)
        self.bf16_shade = bf16_shade
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

    def __call__(self):
        from volrend_torch.ops import slab_march
        g = self.grid
        return slab_march.march_slabs(
            self.pay, self.params, g.qscale, self.zb, g.G, GI, g.data_dim,
            g.basis_dim, self.perm, slab_ids=self.slab_ids,
            sig2=g.quantized, flip=self.flip, bbox_full=True, dir_win=True,
            shade_bf16=self.bf16_shade, k_per_step=slab_march._K_STEP,
            crop=self.crop)


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


def run(dev, modes, lib=None) -> dict:
    """The probe's measurements (``modes``: probe, package); ``lib``: the
    probe build, when already built."""
    from volrend_torch.utils.options import RenderOptions
    opt = RenderOptions(max_steps=1024)
    grids, cams, launches = scene(dev, opt)
    res = {"device": torch.cuda.get_device_name(0), "package": [],
           "probe": []}
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
                         "package (march_slabs and the routes as built)")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("display_march times kernel M on a CUDA device; "
                           "none is available")
    out = run(torch.device("cuda"), args.modes.split(","))
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
