"""Position errors of kernel W's NDC parameter rows
(``display_warp.display_params_ndc``: world2ndc's slope map folded into
three linear forms in float64, rounded once to float32).

For each pose it evaluates every pixel's slope-grid position three ways
(a position does not depend on the cascade level):

- ``fold``: the rows as kernel W evaluates them, in float32
  (``display_warp._display_positions``, its plain version);
- ``chain``: the float32 per-subpixel world2ndc chain both packages ran
  before the rows (``display_warp._sub_slopes(ndc=...)``);
- ``exact``: world2ndc in float64 from the same float32 rotation, focal
  length, origin and slope grid (``_common.ndc_exact_positions``).

and reports the largest |fold - exact|, |chain - exact| and |fold - chain|
in grid units, over all subpixels and over those in the grid. Scenes: the
reference test's (tests/test_slab_render.py::test_superquad_warp_ndc:
200^2, gi=96, NdcConfig(200, 200, 120)) with its pose and two around it,
and bench.py's NDC configuration (800^2, gi=256, NdcConfig(800, 800,
1111.11), a depth-4 tree of its scene) with its pose and every 10th of
the 51 poses of chip_smoke.py's phase 10b (``_common.ndc_spiral``). These
are float errors, computed wherever it runs::

    python -m volrend_torch.probes.ndc_rows [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

F64 = torch.float64
#: one pixel a block: every pixel's position
ONE = (1, 1)


def errors(grid, cams, gi: int, width: int, height: int) -> dict:
    """{pair: max error in grid units (all pixels, those in the grid)}
    over the poses ``cams`` (one (perm, flip) group of ``grid``)."""
    from volrend_torch.ops import display_warp as dw
    from volrend_torch.ops import slab_render
    from volrend_torch.probes._common import ndc_exact_positions
    from volrend_torch.utils.options import RenderOptions
    c0 = cams[0]
    perm, flip, _ = slab_render.choose_axis(grid, c0.transform, c0.fx,
                                            c0.fy, width, height)
    tr = np.stack([c.transform for c in cams])
    g = slab_render.FrameGeom(grid, tr, c0.fx, c0.fy, perm, flip, width,
                              height, RenderOptions(), gi)
    prm = dw.display_params_ndc(g.R, g.fx, g.fy, g.u0, g.du, g.v0, g.dv,
                                g.scale, perm, grid.ndc, g.origin_w)
    fold = dw._display_positions(prm, ONE, height, width)
    chain = dw._sub_slopes(g.R, g.fx, g.fy, width, height, gi, perm, g.u0,
                           g.du, g.v0, g.dv, g.scale, grid.ndc, g.origin_w,
                           B=ONE)
    exact = ndc_exact_positions(g, perm, grid.ndc, ONE, height, width)
    inside = ((exact[0] >= 0) & (exact[0] <= gi - 1) & (exact[1] >= 0)
              & (exact[1] <= gi - 1))
    out = {}
    for name, a, b in (("fold-exact", fold, exact),
                       ("chain-exact", chain, exact),
                       ("fold-chain", fold, chain)):
        err = torch.maximum((a[0].to(F64) - b[0].to(F64)).abs(),
                            (a[1].to(F64) - b[1].to(F64)).abs())
        out[name] = (float(err.max()), float(err[inside].max()))
    return out


def main() -> None:
    from volrend_torch.models.n3tree import NdcConfig
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops import dense_grid
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes._common import ndc_spiral
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)

    def scene(cfg, **kw):
        tree = make_test_tree(basis_dim=4, **kw)
        tree.use_ndc = True
        tree.ndc = NdcConfig(*cfg)
        return dense_grid.bake_dense(tree.to_device(lut_depth=None,
                                                    device=dev), dtype="int8")

    def cam(center, back, side, f):
        return Camera.from_vectors(center=center, v_back=back,
                                   v_world_up=(0.0, 1.0, 0.0), width=side,
                                   height=side, fx=f)

    test_poses = [((0.0, 0.0, 0.2), (0.05, 0.02, 1.0)),
                  ((0.04, -0.03, 0.28), (-0.06, 0.04, 1.0)),
                  ((-0.05, 0.03, 0.12), (0.09, -0.03, 1.0))]
    grid = scene((200.0, 200.0, 120.0), max_depth=3, seed=11,
                 sigma_scale=40.0)
    report = {}
    for i, (c, b) in enumerate(test_poses):
        report[f"test scene, pose {i}"] = errors(
            grid, [cam(c, b, 200, 120.0)], 96, 200, 200)
    grid = scene((800.0, 800.0, 1111.11), max_depth=4, seed=4, n_blobs=6,
                 sigma_scale=60.0)
    pose = cam((0.0, 0.0, 0.2), (0.05, 0.02, 1.0), 800, 1111.11)
    report["bench NDC, pose"] = errors(grid, [pose], 256, 800, 800)
    for i, (c, b) in enumerate(ndc_spiral(pose.transform, 51)):
        if i % 10 == 0:
            report[f"bench NDC, spiral pose {i}"] = errors(
                grid, [cam(tuple(c), tuple(b), 800, 1111.11)], 256, 800,
                800)
    for k, v in report.items():
        print(f"{k}: {json.dumps(v)}")
    worst = {name: max(v[name][0] for v in report.values())
             for name in ("fold-exact", "chain-exact", "fold-chain")}
    print(json.dumps({"max_grid_units": worst}))


if __name__ == "__main__":
    main()
