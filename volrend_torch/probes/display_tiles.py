"""Kernel M's display launches at both tile heights: the evidence behind
``slab_march.display_config``'s tile rule.

For each launch the display path makes on the bench's scenes, times kernel
M's display mode on the card with 32x8 tiles (one pixel row a thread) and
with 32x16 (two), beside the tile height the rule picks and the launch
through ``march_slabs`` itself:

- the dense orbit (200 poses, gi=256): each (perm, flip) group whole, four
  poses spread over it, its first four, its first pose; the steep pose of
  ``chip_smoke.py`` (orbit pose 0 with the focal narrowed to a boundary
  slope in [3.6, 3.95));
- the probes' protocol (96 poses, gi=448): pose 0's group whole, its
  first pose, and each of its poses alone, one launch after another;
- the sparse orbit (96 poses, gi=256): each group whole (cropped payload,
  culled slabs) and four poses spread over it;
- with ``--formats SG,ASG,RGBA``: the dense scene's leaves read as SG16,
  ASG16 and RGBA trees (``_common.format_trees``, int8, or with
  ``--f16`` the f16 bake): each group whole, four poses spread over it
  and its first pose, through the lobe variants and RGBA's kernel of its
  own (32x8 alone since it took three blocks an SM: 32x16 at two ran
  slower on every launch, PERF.md; its 32x16 column is left empty);
- with ``--bf16-shade``: the SH launches through bf16 shading's variant
  without options; with ``--f16``: the dense scene's launches on its f16
  bake (the f16 route's bf16 payload).

Every time is the card's: CUDA events around back-to-back launches queued
behind a device sleep, median of three runs; each launch includes its
host-side inputs (``march_inputs``) as ``march_slabs`` does. The two tile
heights' outputs are held to each other. ``--modes package`` times only
``march_slabs``, so the same file also times another checkout of the
package (run it by path with that checkout first on ``PYTHONPATH``).

Run on a card from the root of the checkout::

    python -m volrend_torch.probes.display_tiles [--modes package,1,2]
        [--only NAME] [--formats SH,SG,ASG,RGBA] [--bf16-shade] [--f16]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from volrend_torch.probes import _common as c

REPS = 10
SLEEP_CYCLES = 20_000_000       # ~10 ms of device sleep ahead of a run
GI_MAIN = 256
N_DENSE, N_SPARSE = 200, 96
CACHE_SPARSE = os.path.join(c._ROOT, ".torch_bench_sparse_cache.npz")


def device_ms(fn, reps: int = REPS) -> float:
    """The card's time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls queued behind a device sleep; median of three."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return float(np.median(ts))


def steep_camera(grid, lo: float = 3.6, hi: float = 3.95):
    """Orbit pose 0's view with the focal narrowed until the boundary-ray
    slope lies in [lo, hi) (chip_smoke.steep_pose)."""
    from volrend_torch.ops import slab_render
    from volrend_torch.ops.camera import Camera
    base = c.orbit_poses(1)[0]
    f_lo, f_hi = 20.0, float(base.fx)
    for _ in range(60):
        f = 0.5 * (f_lo + f_hi)
        cam = Camera(c.W, c.H, f, f, base.transform)
        s = slab_render.choose_axis(grid, cam.transform, f, f, c.W, c.H)[2]
        if lo <= s < hi:
            return cam
        f_lo, f_hi = (f, f_hi) if s >= hi else (f_lo, f)
    raise RuntimeError("no steep slab-compatible focal found")


class Launch:
    """One display launch: the march's inputs for the cameras ``cams`` on
    ``grid`` (an int8 or f16 bake) at ``gi``, as the display path prepares
    them; ``bf16_shade``: SH shading in bf16 (its variant without
    options)."""

    def __init__(self, name, grid, cams, gi, opt, payloads,
                 bf16_shade=False):
        from volrend_torch.ops import slab_march, slab_render
        self.name, self.grid, self.gi, self.P = name, grid, gi, len(cams)
        self.mode = slab_march.MarchMode(int(grid.fmt), grid.extra,
                                         bf16_shade=bf16_shade)
        c0 = cams[0]
        perm, flip, _ = slab_render.choose_axis(grid, c0.transform, c0.fx,
                                                c0.fy, c.W, c.H)
        if perm not in payloads:
            payloads[perm] = slab_render.prepare_payload(grid, perm, opt)
        self.pay = payloads[perm]
        self.perm, self.flip = perm, flip
        self.crop = slab_render.inplane_crop(grid, perm,
                                             float(opt.sigma_thresh))
        tr = torch.as_tensor(np.stack([x.transform for x in cams]),
                             dtype=torch.float32, device=self.pay.device)
        g = slab_render.FrameGeom(grid, tr, c0.fx, c0.fy, perm, flip, c.W,
                                  c.H, opt, gi)
        self.params, self.zb = slab_render._march_frame_fields(
            grid, g, perm, flip, opt)
        self.slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)

    def package(self):
        """The launch through ``march_slabs`` (the package's own choice)."""
        from volrend_torch.ops import slab_march
        g = self.grid
        return slab_march.march_slabs(
            self.pay, self.params, g.qscale, self.zb, g.G, self.gi,
            g.data_dim, g.basis_dim, self.perm, slab_ids=self.slab_ids,
            sig2=g.quantized, flip=self.flip, bbox_full=True, dir_win=True,
            k_per_step=slab_march._K_STEP, crop=self.crop,
            fmt=self.mode.fmt, extra=self.mode.extra,
            shade_bf16=self.mode.bf16_shade)

    def rows(self, rows=None):
        """The launch with ``rows`` pixel rows a thread (None: the rule's
        choice); returns (acc, configuration)."""
        from volrend_torch.ops import slab_march
        g = self.grid
        m = slab_march.march_inputs(self.pay, self.params, self.zb, g.G,
                                    self.gi, self.slab_ids,
                                    slab_march._K_STEP, self.crop)
        slab_march._check_launch(self.pay, g.qscale, m["params"], m["zb"],
                                 g.G, self.gi)
        cfg = slab_march.display_config(
            self.P, self.gi, len(m["wins"]), self.pay.shape[1],
            slab_march._sm_count(self.pay.device.index),
            esz=self.pay.element_size(),
            opt=not self.mode.tall_tiles(g.basis_dim),
            raw=self.mode.rgba_raw())
        if rows is not None:
            cfg = dict(cfg, rows=rows)
        acc = slab_march._display_launch(
            self.pay, g.qscale, m["params"], m["zb"], m["wins"], m["masks"],
            g.G, self.gi, g.basis_dim, m["K"], self.flip, m["y0"], m["x0"],
            cfg, self.mode)
        return acc, cfg


class Series:
    """Launches of one pose each, made one after another and timed together
    (the probes' one-pose protocol); its times are per launch."""

    def __init__(self, name, launches):
        self.name, self.items = name, launches
        self.P, self.gi, self.n = 1, launches[0].gi, len(launches)

    def package(self):
        return [ln.package() for ln in self.items][-1]

    def rows(self, rows=None):
        return [ln.rows(rows) for ln in self.items][-1]


def lobe_launches(opt, fmt, dtype="int8"):
    """The dense scene read as an SG16, ASG16 or RGBA tree
    (``_common.format_trees``; int8, or ``dtype`` "f16" the f16 bake):
    each group whole, four poses spread over it, its first pose."""
    from volrend_torch.ops import dense_grid
    dev = torch.device("cuda")
    tdev = c.get_tree().to_device(lut_depth=None, device=dev)
    grid = dense_grid.bake_dense(c.format_trees(tdev)[fmt], dtype=dtype)
    tag = fmt if fmt == "RGBA" else f"{fmt}16"
    del tdev
    pays = {}
    cams = c.orbit_poses(N_DENSE)
    for gk, (key, idx) in enumerate(c.pose_groups(grid, cams).items()):
        sel = [cams[i] for i in idx]
        spread = np.unique(np.linspace(0, len(sel) - 1, 4).round())
        for what, sub in ((f"{len(sel)} poses", sel),
                          ("4 spread", [sel[int(i)] for i in spread]),
                          ("1 pose", sel[:1])):
            yield Launch(f"dense {tag} group {gk} {key}: {what}", grid,
                         sub, GI_MAIN, opt, pays)
    del grid, pays
    torch.cuda.empty_cache()


def launches(opt, formats=("SH",), bf16_shade=False, dtype="int8"):
    """The display launches this probe times, scene by scene (a generator,
    so one scene's payloads are freed before the next is built): the SH
    scenes' unless ``formats`` leaves SH out (``bf16_shade``: shaded in
    bf16; ``dtype`` "f16": the dense scene's f16 bake), then the lobe
    trees'."""
    for fmt in formats:
        if fmt != "SH":
            yield from lobe_launches(opt, fmt, dtype)
    if "SH" not in formats:
        return
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import dense_grid
    dev = torch.device("cuda")
    grid = c.dense_grid_on(dev, dtype)
    pays = {}
    cams = c.orbit_poses(N_DENSE)
    for gk, (key, idx) in enumerate(c.pose_groups(grid, cams).items()):
        sel = [cams[i] for i in idx]
        spread = np.unique(np.linspace(0, len(sel) - 1, 4).round())
        for tag, sub in ((f"{len(sel)} poses", sel),
                         ("4 spread", [sel[int(i)] for i in spread]),
                         ("4 first", sel[:4]), ("1 pose", sel[:1])):
            yield Launch(f"dense group {gk} {key}: {tag}", grid, sub,
                         GI_MAIN, opt, pays, bf16_shade)
    yield Launch("dense steep pose", grid, [steep_camera(grid)], GI_MAIN,
                 opt, pays, bf16_shade)
    cams = c.orbit_poses(c.N_ORBIT)
    key, idx = next((k, v) for k, v in c.pose_groups(grid, cams).items()
                    if 0 in v)
    for tag, sub in ((f"{len(idx)} poses", idx), ("1 pose", idx[:1])):
        yield Launch(f"dense gi={c.GI} group {key}: {tag}", grid,
                     [cams[i] for i in sub], c.GI, opt, pays, bf16_shade)
    yield Series(f"dense gi={c.GI} group {key}: each pose alone",
                 [Launch("", grid, [cams[i]], c.GI, opt, pays, bf16_shade)
                  for i in idx])
    del grid, pays
    torch.cuda.empty_cache()
    tree = c.load_tree(CACHE_SPARSE, lambda: make_solid_tree(
        max_depth=7, basis_dim=16, seed=3))
    grid = dense_grid.bake_dense(tree.to_device(lut_depth=None, device=dev),
                                 dtype="int8")
    pays = {}
    cams = c.orbit_poses(N_SPARSE)
    for gk, (key, idx) in enumerate(c.pose_groups(grid, cams).items()):
        sel = [cams[i] for i in idx]
        spread = np.unique(np.linspace(0, len(sel) - 1, 4).round())
        for tag, sub in ((f"{len(sel)} poses", sel),
                         ("4 spread", [sel[int(i)] for i in spread])):
            yield Launch(f"sparse group {gk} {key}: {tag}", grid, sub,
                         GI_MAIN, opt, pays, bf16_shade)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="package,1,2",
                    help="comma-separated: package (march_slabs), 1 (32x8 "
                         "tiles), 2 (32x16 tiles)")
    ap.add_argument("--only", default="",
                    help="time only the launches whose name holds this")
    ap.add_argument("--bf16-shade", action="store_true",
                    help="the SH launches shade in bf16 (the bf16-shading "
                         "variant without options)")
    ap.add_argument("--f16", action="store_true",
                    help="the dense scene's launches on its f16 bake (the "
                         "bf16 payload of the f16 route)")
    ap.add_argument("--formats", default="SH",
                    help="comma-separated: SH (the SH scenes), SG, ASG, "
                         "RGBA (the dense scene's leaves as SG16/ASG16/"
                         "RGBA trees)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("display_tiles times kernel M on a CUDA device; "
                           "none is available")
    from volrend_torch.utils.options import RenderOptions
    modes = args.modes.split(",")
    c.log(f"{torch.cuda.get_device_name(0)}; modes {modes}")
    rows = []
    for ln in launches(RenderOptions(max_steps=1024),
                       args.formats.split(","), args.bf16_shade,
                       "f16" if args.f16 else "int8"):
        if args.only not in ln.name:
            continue
        n = getattr(ln, "n", 1)
        row = {"launch": ln.name, "poses": ln.P, "launches": n, "gi": ln.gi}
        outs = {}
        for mode in modes:
            if mode == "package":
                row["package_ms"] = device_ms(ln.package, max(1, REPS // n)
                                              ) / n
                continue
            if mode == "2" and getattr(ln, "mode", None) is not None \
                    and ln.mode.rgba_raw():
                row["rows2_ms"] = None  # RGBA's kernel takes 32x8 alone
                continue
            acc, cfg = ln.rows(int(mode))
            outs[mode] = acc
            row[f"rows{mode}_ms"] = device_ms(
                lambda r=int(mode): ln.rows(r), max(1, REPS // n)) / n
        if outs:
            row["rule_rows"] = ln.rows()[1]["rows"]
            accs = list(outs.values())
            row["max_abs_diff"] = max(
                [float((a - accs[0]).abs().max()) for a in accs[1:]] + [0.0])
        del outs
        rows.append(row)
        c.log(json.dumps(row))
    print(json.dumps({"display_tiles": rows}))


if __name__ == "__main__":
    main()
