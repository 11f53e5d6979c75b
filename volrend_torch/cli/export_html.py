"""Export a scene to a self-contained offline HTML preview (the counterpart
of ``volrend_tpu/cli/export_html.py``).

The reference's web build runs entirely client-side with no server
(web/main_web.cpp:547-576). A CUDA renderer can't ship in a browser, so the
offline analog is a pre-rendered turntable: render an orbit of poses once,
embed them as base64 PNGs in ONE html file with a drag/scroll scrubber
(mouse, touch, arrow keys, autoplay). The file opens from disk with no
server, no card, no network — `file://` double-click viewing.

    python -m volrend_torch.cli.export_html tree.npz -o scene.html \
        [--frames 36] [--size 512] [--elev 0.45] [--radius 2.8]
        [--renderer slab|exact] [--device cpu]

The slab renderer bakes the tree to int8 and renders every orbit pose by
``slab_render.render_image`` (kernels M and W on the card, RGBA8 frames),
the poses sharing one payload cache. Reference capability replaced:
offline/client-side viewing (web/main_web.cpp + web/js); the interactive
server viewer (volrend-torch-viewer) remains the live surface.
"""

from __future__ import annotations

import argparse
import base64
import io
import os
import sys
import time

import numpy as np

from volrend_torch.cli.opts import (add_common_opts, device_from_args,
                                    render_options_from_args)
from volrend_torch.models.n3tree import N3Tree
from volrend_torch.ops.camera import Camera
from volrend_torch.utils.png import rgba_to_bytes, write_png_bytes

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<title>{title} — volrend-tpu offline preview</title>
<style>
 body {{ margin:0; background:#111; color:#ddd;
        font:14px system-ui, sans-serif; }}
 #wrap {{ display:flex; flex-direction:column; align-items:center;
         padding:16px; }}
 canvas {{ max-width:95vw; border:1px solid #333; cursor:grab;
          touch-action:none; }}
 #bar {{ margin-top:10px; }}
 a {{ color:#8cf; }}
</style></head><body>
<div id="wrap">
 <h3>{title} <small>({n} poses, rendered by volrend-tpu)</small></h3>
 <canvas id="c" width="{w}" height="{h}"></canvas>
 <div id="bar">
   <button id="play">&#9654;</button>
   <input id="slider" type="range" min="0" max="{nm1}" value="0"
          style="width:300px">
   <span id="idx">0</span>
 </div>
 <p>drag / arrow keys / scroll to orbit — self-contained file, no server.</p>
</div>
<script>
const FRAMES = [{frames}];
const cv = document.getElementById('c'), cx = cv.getContext('2d');
const slider = document.getElementById('slider');
const idxEl = document.getElementById('idx');
const imgs = FRAMES.map(src => {{ const im = new Image();
  im.src = 'data:image/png;base64,' + src; return im; }});
let cur = 0, playing = false, dragX = null;
function show(i) {{
  cur = ((i % imgs.length) + imgs.length) % imgs.length;
  const im = imgs[cur];
  const draw = () => {{ cx.clearRect(0, 0, cv.width, cv.height);
    cx.drawImage(im, 0, 0); }};
  if (im.complete) draw(); else im.onload = draw;
  slider.value = cur; idxEl.textContent = cur;
}}
slider.oninput = () => show(+slider.value);
cv.onpointerdown = e => {{ dragX = e.clientX; cv.setPointerCapture(e.pointerId); }};
cv.onpointermove = e => {{ if (dragX === null) return;
  const d = Math.round((e.clientX - dragX) / 8);
  if (d) {{ show(cur + d); dragX = e.clientX; }} }};
cv.onpointerup = () => dragX = null;
cv.onwheel = e => {{ e.preventDefault(); show(cur + (e.deltaY > 0 ? 1 : -1)); }};
document.onkeydown = e => {{
  if (e.key === 'ArrowRight') show(cur + 1);
  if (e.key === 'ArrowLeft') show(cur - 1); }};
document.getElementById('play').onclick = function () {{
  playing = !playing; this.innerHTML = playing ? '&#9646;&#9646;' : '&#9654;';
}};
setInterval(() => {{ if (playing) show(cur + 1); }}, 80);
show(0);
</script></body></html>
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="volrend-export-html",
        description="Export an offline self-contained HTML turntable")
    p.add_argument("-o", "--out", default="",
                   help="output html (default <tree>.preview.html)")
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--elev", type=float, default=0.45)
    p.add_argument("--radius", type=float, default=2.8)
    p.add_argument("--renderer", choices=("slab", "exact"), default="slab")
    add_common_opts(p)
    return p


def _png_b64(img: np.ndarray) -> str:
    buf = io.BytesIO()
    write_png_bytes(buf, rgba_to_bytes(img))
    return base64.b64encode(buf.getvalue()).decode("ascii")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = device_from_args(args)
    opt = render_options_from_args(args)

    t0 = time.perf_counter()
    tree = N3Tree(args.file)
    tdev = tree.to_device(lut_depth=None, device=dev)
    W = H = args.size

    fkw = {"fx": args.fx} if args.fx > 0 else {}
    cams = []
    for i in range(args.frames):
        th = 2 * np.pi * i / args.frames
        back = np.array([np.cos(th) * np.cos(args.elev),
                         np.sin(th) * np.cos(args.elev),
                         np.sin(args.elev)])
        cams.append(Camera.from_vectors(
            center=tuple(args.radius * back), v_back=tuple(back),
            width=W, height=H, **fkw))

    if args.renderer == "slab":
        import torch
        from volrend_torch.ops import dense_grid, slab_render
        grid = dense_grid.bake_dense(tdev, dtype="int8")
        cache: dict = {}
        frames = [slab_render.render_image(grid, c, opt,
                                           payload_cache=cache,
                                           out_dtype=torch.uint8)
                  for c in cams]
    else:
        from volrend_torch.ops import render_exact
        frames = [render_exact.render_image(tdev, c, opt).cpu().numpy()
                  for c in cams]

    b64 = [_png_b64(np.asarray(f)) for f in frames]
    out = args.out or (os.path.splitext(args.file)[0] + ".preview.html")
    title = os.path.basename(args.file)
    html = _PAGE.format(title=title, n=len(b64), w=W, h=H,
                        nm1=len(b64) - 1,
                        frames=",".join(f'"{s}"' for s in b64))
    with open(out, "w") as f:
        f.write(html)
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, "
          f"{len(b64)} frames, {time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
