"""Animation renderer — the ``volrend_anim`` equivalent, headless (the
counterpart of ``volrend_tpu/cli/animate.py``).

    python -m volrend_torch.cli.animate tree.npz script.json -o out_dir \
        [--fps 30] [--renderer {slab,exact}] [--gi 512] [--device cpu]

The reference edits keyframes interactively (ImGui, main_anim.cpp:350-925)
and exports PNG frames at fixed fps; this CLI takes the keyframes from a
JSON script (see ``volrend_torch.anim.load_script``) and renders the frame
sequence with the same interpolation semantics. Frames with meshes go
through the exact renderer's mesh composite
(``composite.render_frame_with_meshes``); the others through the int8 bake
and ``slab_render.render_image`` (kernels M and W on the card) where the
pose passes the slab gate (``slab_render.compatible``), and the exact
renderer where it does not. The frame loop is timed with ``FrameTimer``
(PNG writes included) and its report printed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from volrend_torch.anim import frame_times, interpolate, load_script
from volrend_torch.cli.opts import add_common_opts, device_from_args
from volrend_torch.models.n3tree import N3Tree
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.png import write_png
from volrend_torch.utils.profiling import FrameTimer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="volrend_anim",
                                description="keyframe animation renderer")
    add_common_opts(p)
    p.add_argument("script", help="JSON keyframe script")
    p.add_argument("-o", "--output_folder", default="ani_out")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--renderer", choices=("slab", "exact"), default="slab")
    p.add_argument("--gi", type=int, default=512)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = device_from_args(args)

    import torch
    from volrend_torch.models import mesh as mesh_mod
    from volrend_torch.ops import composite, render_exact

    tree = N3Tree(args.file)
    tdev = tree.to_device(lut_depth=None, device=dev)
    keyframes, cfg = load_script(args.script)
    if len(keyframes) < 2:
        print("need at least 2 keyframes", file=sys.stderr)
        return 1
    fps = float(cfg.get("fps", args.fps))
    world_up = np.asarray(cfg.get("world_up", (0.0, 0.0, 1.0)), float)

    meshes = []
    if args.draw:
        if args.draw.endswith(".obj"):
            meshes = [mesh_mod.load_basic_obj(args.draw)]
        else:
            meshes = mesh_mod.open_drawlist(args.draw)

    grid = None
    if args.renderer == "slab" and not meshes:
        from volrend_torch.ops import dense_grid, slab_render
        grid = dense_grid.bake_dense(tdev, dtype="int8")
    payloads: dict = {}

    os.makedirs(args.output_folder, exist_ok=True)
    schedule = frame_times(keyframes, fps)
    timer = FrameTimer(args.width, args.height)
    timer.start()
    for f_idx, (seg, q) in enumerate(schedule):
        center, v_back, fx, fy, opt, mstate = interpolate(
            keyframes[seg], keyframes[seg + 1], q, world_up,
            first_segment=(seg == 0))
        opt = opt.replace(max_steps=4096)
        cam = Camera.from_vectors(
            center=tuple(center), v_back=tuple(v_back),
            v_world_up=tuple(world_up), width=args.width,
            height=args.height, fx=fx, fy=fy)
        if meshes:
            for m in meshes:
                if m.name in mstate:
                    s = mstate[m.name]
                    m.rotation = np.asarray(s.rotation, np.float32)
                    m.translation = np.asarray(s.translation, np.float32)
                    m.scale = s.scale
                    m.visible = s.visible
                else:
                    m.visible = False
            img = composite.render_frame_with_meshes(
                tdev, cam, opt, meshes, host_tree=tree)
        elif grid is not None and slab_render.compatible(
                grid, cam.transform, fx, fy, args.width, args.height):
            img = slab_render.render_image(grid, cam, opt, gi=args.gi,
                                           payload_cache=payloads,
                                           out_dtype=torch.uint8)
        else:
            img = render_exact.render_image(tdev, cam, opt).cpu().numpy()
        write_png(os.path.join(args.output_folder, f"{f_idx:06d}.png"), img)
        timer.frame()
    timer.stop()
    print(timer.report())
    print(f"Wrote {len(schedule)} frames to {args.output_folder}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
