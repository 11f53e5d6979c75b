"""Headless batch renderer — the ``volrend_headless`` equivalent (the
counterpart of ``volrend_tpu/cli/headless.py``).

    python -m volrend_torch.cli.headless tree.npz pose_*.txt -i intrin.txt \
        -o out_dir [--renderer {slab,exact,oracle}] [--device cpu]

Flag-compatible with ``main_headless.cpp:77-235``: reads a 4x4 intrinsics
txt and N pose files (3x4 / 4x4 / 4Nx4 C2W), renders every pose, optionally
writes PNGs, and prints ``ms per frame`` / ``fps`` measured end to end
around the render loop, after a warm-up pass outside the timer. The timed
region ends once the last frame is on the host. PNGs are encoded in writer
threads while later frames render; which encoder wrote them goes to
stderr.

Renderer selection: ``--renderer slab`` (default: the dense-grid slab path,
kernels M and W on the card; poses grouped by slab axis, one
``render_frames`` dispatch per group; world-tree poses past the slab gate
take split-frame passes, NDC poses past it the exact renderer),
``--renderer exact`` (the T2 batched octree march), ``--renderer oracle``
(the T1 NumPy oracle, very slow).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from volrend_torch.cli.opts import (add_common_opts, device_from_args,
                                    render_options_from_args)
from volrend_torch.models.n3tree import N3Tree
from volrend_torch.ops.camera import Camera, poses_from_files, read_intrins
from volrend_torch.utils import png


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="volrend_headless",
        description="PlenOctree batch renderer (PyTorch/CUDA)")
    add_common_opts(p)
    p.add_argument("poses", nargs="*", help="pose txt file(s)")
    p.add_argument("-i", "--intrin", default="",
                   help="intrinsics txt (4x4); overrides --fx/--fy")
    p.add_argument("-o", "--write_images", default="",
                   help="output directory for PNG frames")
    p.add_argument("--scale", type=float, default=1.0,
                   help="image scale factor")
    p.add_argument("--max_imgs", type=int, default=0,
                   help="max images (0 = all)")
    p.add_argument("-r", "--reverse_yz", action="store_true",
                   help="poses are OpenCV convention (flip y/z)")
    p.add_argument("--renderer", choices=("slab", "exact", "oracle"),
                   default="slab")
    p.add_argument("--gi", type=int, default=None,
                   help="slab-renderer intermediate resolution "
                        "(default: grid-matched, slab_render.default_gi)")
    return p


def _slab_runner(args, tdev, cams, width, height, fx, fy, opt, render_one):
    """The slab renderer's pass over every pose: (run(sink) -> frames)."""
    import torch
    from volrend_torch.ops import dense_grid, slab_render
    from volrend_torch.utils.device import to_device

    grid = dense_grid.bake_dense(tdev)
    if args.gi is None:
        args.gi = slab_render.default_gi(grid)
    groups, fallback = {}, []
    for i, cam in enumerate(cams):
        perm, flip, slope = slab_render.choose_axis(
            grid, cam.transform, cam.fx, cam.fy, width, height)
        # the viewer's gate (slab_render.compatible): the box-tap warp is
        # accurate only while per-slab spans stay near one voxel
        if np.isfinite(slope) and slope < slab_render.MAX_SLAB_SLOPE:
            groups.setdefault((perm, flip), []).append(i)
        else:
            fallback.append(i)
    payloads = {}            # the permuted payloads, built in the warm-up
    transforms = {k: to_device(np.stack([cams[i].transform for i in v]),
                               torch.float32, grid.device)
                  for k, v in groups.items()}

    def run(sink=None):
        frames = [None] * len(cams)
        # dispatch every group before downloading any: RGBA8 frames off
        # kernel W (the reference's framebuffer format, volrend.cu:166-172)
        pend = [(idxs, slab_render.render_frames(
            grid, transforms[(perm, flip)], fx, fy, perm, flip, width,
            height, opt, gi=args.gi,
            payload=slab_render._cached_payload(grid, perm, opt, payloads),
            out_dtype=torch.uint8))
            for (perm, flip), idxs in groups.items()]
        for idxs, out_dev in pend:
            out = out_dev.cpu().numpy()
            for j, i in enumerate(idxs):
                frames[i] = out[j]
                if sink is not None:
                    sink(i, out[j])
        for i in fallback:
            # poses past the slab gate: split-frame slab passes for world
            # trees, the exact renderer for NDC trees
            if grid.ndc is None:
                frames[i] = slab_render.render_frame_split(
                    grid, cams[i].transform, fx, fy, width, height, opt,
                    gi=args.gi, payload_cache=payloads).cpu().numpy()
            else:
                frames[i] = render_one(cams[i])
            if sink is not None:
                sink(i, frames[i])
        return frames

    return run


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.poses:
        print("No poses specified", file=sys.stderr)
        return 1
    dev = device_from_args(args)

    from volrend_torch.ops import render_exact

    tree = N3Tree(args.file)
    tdev = tree.to_device(lut_depth=None, device=dev)
    opt = render_options_from_args(args).replace(max_steps=4096)

    trans, basenames = poses_from_files(args.poses, args.reverse_yz)
    if args.max_imgs > 0:
        trans, basenames = trans[:args.max_imgs], basenames[:args.max_imgs]

    width = int(args.width * args.scale)
    height = int(args.height * args.scale)
    fx = args.fx * args.scale
    fy = args.fy * args.scale
    if args.intrin:
        ix, iy = read_intrins(args.intrin)
        fx, fy = ix * args.scale, iy * args.scale

    cams = [Camera(width, height, fx, fy, t) for t in trans]
    if not cams:
        print("No poses in the pose files", file=sys.stderr)
        return 1
    # Camera resolves the -1 defaults (focal 1111.11, fy = fx)
    fx, fy = cams[0].fx, cams[0].fy

    def render_one(cam) -> np.ndarray:
        if args.renderer == "oracle":
            from volrend_torch.ops import oracle
            return oracle.render_image(tree, cam, opt)
        return render_exact.render_image(tdev, cam, opt).cpu().numpy()

    writer = None
    futs = []
    if args.write_images:
        from concurrent.futures import ThreadPoolExecutor
        os.makedirs(args.write_images, exist_ok=True)
        writer = ThreadPoolExecutor(max_workers=8)

    def emit(i, img):
        if writer is not None:
            futs.append(writer.submit(
                png.write_png,
                os.path.join(args.write_images, basenames[i] + ".png"),
                img))

    if args.renderer == "slab":
        run = _slab_runner(args, tdev, cams, width, height, fx, fy, opt,
                           render_one)
        run()                            # warm-up outside the timer
        t0 = time.perf_counter()
        run(sink=emit)
        dt = time.perf_counter() - t0
    else:
        render_one(cams[0])              # warm-up outside the timer
        t0 = time.perf_counter()
        for i, cam in enumerate(cams):
            emit(i, render_one(cam))
        dt = time.perf_counter() - t0

    n = len(cams)
    print(f"{1e3 * dt / n:.10f} ms per frame")
    print(f"{n / dt:.10f} fps")

    if writer is not None:
        tw0 = time.perf_counter()
        encoders = [f.result() for f in futs]
        writer.shutdown()
        used = {e: encoders.count(e) for e in sorted(set(encoders))}
        why = png.native_error()
        print(f"png encoder {used}"
              + (f" (native encoder unavailable: {why})" if why else "")
              + f"; drain {1e3 * (time.perf_counter() - tw0):.1f} ms "
              "(encoded concurrently with rendering)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
