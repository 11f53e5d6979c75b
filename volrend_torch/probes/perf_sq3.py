"""The superquad warp with a planar gathered table and its own tent-combine
kernel (the counterpart of ``tools/perf_sq3.py``).

The probe's warp, per pose: subpixel slope positions (``sub_slopes``), the
window corner of each 2x2 screen block from the UNMASKED minimum of its
subpixels' positions, a bf16 quad table built by two shifted concats, the
row gather, a planar transpose to (64, Hh, Wh), the tent-combine kernel
``combine_probe`` (``csrc/probe_combine.cu``) and the (H, W, 4)
interleave. As in the reference, everything but the combine is plain tensor
code (the reference left it to XLA).

``main()`` prints s1, max |probe - production| against the port's
production warp (``slab_render._warp_to_screen(precise=False)``) on one
pose, and s2, ms per frame of the probe (one pose per call, as the
reference's ``lax.map``) and of the production warp (one batched call over
the poses, as the display path runs it) over 24 poses.

    python -m volrend_torch.probes.perf_sq3 [--profile]

``--profile`` adds torch.profiler device-time breakdowns of one probe warp
and of the batched production warp.
"""

from __future__ import annotations

import sys
from typing import Tuple

import torch

from volrend_torch import kernels
from volrend_torch.ops.display_warp import _check

_F32 = torch.float32


def chan(cy: int, cx: int, c: int) -> int:
    """Table channel of window cell (cy, cx), colour c: the order of the
    double-concat quad table (quad block major, then quad cell, colour
    minor)."""
    a, i = cy // 2, cy % 2
    b, j = cx // 2, cx % 2
    return a * 32 + b * 16 + i * 8 + j * 4 + c


def combine_probe(qgp: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor,
                  okm: torch.Tensor, bg: float) -> torch.Tensor:
    """Planar tent-combine: qgp (64, Hh, Wh) bf16 gathered window cells
    (channel ``chan``), ry/rx/okm (4, Hh, Wh) f32 per-subpixel window
    positions and in-grid masks (subpixel s = p*2 + q) -> (16, Hh, Wh) f32
    planes [s*4 + c]: the unclamped tent sum of each colour, composited over
    the background ``bg`` where okm > 0.5, else (bg, bg, bg, 0).

    Launches ``csrc/probe_combine.cu`` on CUDA tensors (counted in
    ``launches``); runs ``combine_probe_ref`` on CPU tensors."""
    Hh, Wh = qgp.shape[1], qgp.shape[2]
    dev = qgp.device
    if dev.type == "cpu":
        return combine_probe_ref(qgp, ry, rx, okm, bg)
    if dev.type != "cuda":
        raise RuntimeError(f"combine_probe: no kernel for device {dev}")
    _check("combine_probe: qgp", qgp, torch.bfloat16, (64, Hh, Wh), dev)
    for name, t in (("ry", ry), ("rx", rx), ("okm", okm)):
        _check(f"combine_probe: {name}", t, _F32, (4, Hh, Wh), dev)
    out = torch.empty((16, Hh, Wh), dtype=_F32, device=dev)
    lib = kernels.lib("probe_combine")
    kernels.check(lib.vt_probe_combine(
        qgp.data_ptr(), ry.data_ptr(), rx.data_ptr(), okm.data_ptr(),
        out.data_ptr(), Hh, Wh, float(bg),
        torch.cuda.current_stream(dev).cuda_stream), "probe_combine")
    combine_probe.launches += 1
    return out


combine_probe.launches = 0


def combine_probe_ref(qgp, ry, rx, okm, bg: float) -> torch.Tensor:
    """Plain PyTorch version of ``combine_probe`` (the reference kernel's
    f32 arithmetic, in its order)."""
    out = []
    for s in range(4):
        wy = [torch.clamp(1.0 - torch.abs(ry[s] - cy), min=0.0)
              for cy in range(4)]
        wx = [torch.clamp(1.0 - torch.abs(rx[s] - cx), min=0.0)
              for cx in range(4)]
        ok = okm[s] > 0.5
        rgba = []
        for c in range(4):
            acc = torch.zeros_like(ry[s])
            for cy in range(4):
                for cx in range(4):
                    acc = acc + (wy[cy] * wx[cx]) * qgp[chan(cy, cx, c)].to(
                        _F32)
            rgba.append(acc)
        alpha = rgba[3]
        for c in range(3):
            out.append(torch.where(ok, rgba[c] + bg * (1.0 - alpha), bg))
        out.append(torch.where(ok, alpha, 0.0))
    return torch.stack(out)


def pose_geom(g, i: int = 0) -> Tuple:
    """Pose ``i`` of a (batched) ``slab_render.FrameGeom``: (R, fx, fy,
    u0, du, v0, dv, scale), the fields the warps read."""
    return (g.R[i], g.fx, g.fy, g.u0[i], g.du[i], g.v0[i], g.dv[i],
            g.scale)


def sub_slopes(geo, perm, p: int, q: int, width: int, height: int,
               gi: int):
    """Subpixel (p, q)'s slope-grid positions, clipped to the grid, and its
    in-grid mask, each (Hh, Wh) (perf_sq3.py:111-126).

    The arithmetic is the reference's as its compiler runs it with the
    pose's geometry as constants: a division by a constant becomes a
    multiply by the f32 reciprocal (as for the bake scales, ROADMAP.md
    §3) and the rotation's three products are summed in order, which
    keeps the positions bit-equal to the reference's."""
    from volrend_torch.ops import slab_render
    from volrend_torch.utils.device import to_device
    R, fx, fy, u0, du, v0, dv, scale = geo
    Hh, Wh = height // 2, width // 2
    dev = R.device

    def recip(v):
        return 1.0 / to_device(v, _F32, dev)

    xs = (torch.arange(Wh, dtype=_F32, device=dev) * 2 + q
          - 0.5 * width) * recip(fx)
    ys = -(torch.arange(Hh, dtype=_F32, device=dev) * 2 + p
           - 0.5 * height) * recip(fy)
    d_tree_s = torch.stack([xs[None, :] * R[k, 0] + ys[:, None] * R[k, 1]
                            - R[k, 2] for k in range(3)], -1) * scale
    us, vs = slab_render._slopes_from_dirs(d_tree_s, perm)
    gy = (us - u0) * recip(du)
    gx = (vs - v0) * recip(dv)
    ok = (gy >= 0) & (gy <= gi - 1) & (gx >= 0) & (gx <= gi - 1)
    return (torch.clamp(gy, 0.0, gi - 1 - 1e-6),
            torch.clamp(gx, 0.0, gi - 1 - 1e-6), ok.to(_F32))


def superquad_inputs(inter: torch.Tensor, geo, perm, width: int,
                     height: int, gi: int):
    """The combine's inputs for one pose: (qgp (64, Hh, Wh) bf16, ry, rx,
    okm (4, Hh, Wh) f32), from the (gi, gi, 4) intermediate image."""
    Ts = (gi - 3) * (gi - 3)
    subs = [sub_slopes(geo, perm, p, q, width, height, gi)
            for p in range(2) for q in range(2)]
    gys = torch.stack([s[0] for s in subs])        # (4, Hh, Wh): [p*2+q]
    gxs = torch.stack([s[1] for s in subs])
    okm = torch.stack([s[2] for s in subs])
    # the window corner from ALL subpixels (the reference probe's unmasked
    # minimum; the production warp takes the in-grid ones only)
    Y0 = torch.clamp(torch.floor(torch.amin(gys, 0)).to(torch.int32), 0,
                     gi - 4)
    X0 = torch.clamp(torch.floor(torch.amin(gxs, 0)).to(torch.int32), 0,
                     gi - 4)
    it16 = inter.to(torch.bfloat16)
    qd = torch.cat([it16[:-1, :-1], it16[:-1, 1:], it16[1:, :-1],
                    it16[1:, 1:]], -1)
    tbl = torch.cat([qd[:-2, :-2], qd[:-2, 2:], qd[2:, :-2], qd[2:, 2:]],
                    -1).reshape(Ts, 64)
    qg = tbl[(Y0 * (gi - 3) + X0).long()]          # (Hh, Wh, 64)
    qgp = qg.permute(2, 0, 1).contiguous()         # planar
    ry = (gys - Y0.to(_F32)[None]).contiguous()
    rx = (gxs - X0.to(_F32)[None]).contiguous()
    return qgp, ry, rx, okm.contiguous()


def interleave(out16: torch.Tensor, width: int, height: int
               ) -> torch.Tensor:
    """(16, Hh, Wh) planes [(p*2 + q)*4 + c] -> (H, W, 4)."""
    Hh, Wh = height // 2, width // 2
    out = out16.reshape(2, 2, 4, Hh, Wh)
    return out.permute(3, 0, 4, 1, 2).reshape(height, width, 4)


def superquad_warp(inter: torch.Tensor, geo, perm, width: int, height: int,
                   gi: int, opt) -> torch.Tensor:
    """The probe's superquad display warp of one pose: the (gi, gi, 4)
    intermediate image -> the (H, W, 4) f32 screen over the background."""
    qgp, ry, rx, okm = superquad_inputs(inter, geo, perm, width, height, gi)
    out16 = combine_probe(qgp, ry, rx, okm,
                          float(opt.background_brightness))
    return interleave(out16, width, height)


def s1(grid, tr, fx, fy, perm, flip, inter, opt, width: int, height: int,
       gi: int) -> float:
    """max |probe - production| on one pose (tr (3, 4))."""
    from volrend_torch.ops import slab_render
    g = slab_render.FrameGeom(grid, tr, fx, fy, perm, flip, width, height,
                              opt, gi)
    ref = slab_render._warp_to_screen(
        inter[None], opt, g.R, g.fx, g.fy, width, height, gi, perm, g.u0,
        g.du, g.v0, g.dv, g.scale, precise=False)[0]
    got = superquad_warp(inter, pose_geom(g), perm, width, height, gi, opt)
    return float((got - ref).abs().max())


def s2(grid, trs, fx, fy, perm, flip, inter, opt, width: int, height: int,
       gi: int) -> Tuple[float, float]:
    """(probe, production) ms per frame over the poses of ``trs``; each
    timed call builds the poses' geometry, as the reference's does."""
    from volrend_torch.ops import slab_render
    from volrend_torch.probes._common import sync_time
    n = trs.shape[0]

    def probe():
        g = slab_render.FrameGeom(grid, trs, fx, fy, perm, flip, width,
                                  height, opt, gi)
        return [superquad_warp(inter, pose_geom(g, i), perm, width, height,
                               gi, opt).sum() for i in range(n)]

    def production():
        g = slab_render.FrameGeom(grid, trs, fx, fy, perm, flip, width,
                                  height, opt, gi)
        return slab_render._warp_to_screen(
            inter[None].expand(n, -1, -1, -1), opt, g.R, g.fx, g.fy, width,
            height, gi, perm, g.u0, g.du, g.v0, g.dv, g.scale,
            precise=False).sum((1, 2, 3))

    return (sync_time(probe) / n * 1e3, sync_time(production) / n * 1e3)


def main():
    import numpy as np
    from volrend_torch.ops import slab_render
    from volrend_torch.probes import _common as c
    from volrend_torch.utils.options import RenderOptions

    dev = torch.device("cuda")
    W, H, gi = c.W, c.H, c.GI
    grid = c.dense_grid_on(dev)
    opt = RenderOptions(max_steps=1024)
    cams = c.orbit_poses(c.N_ORBIT)
    groups = c.pose_groups(grid, cams)
    (perm, flip), idx = next((k, v) for k, v in groups.items() if 0 in v)
    trs = c.transforms(cams, idx[:24], dev)
    fx, fy = cams[0].fx, cams[0].fy
    c.log(f"setup done; {trs.shape[0]} poses; "
          f"{torch.cuda.get_device_name(0)}")
    rng = np.random.RandomState(0)
    inter = torch.as_tensor(rng.rand(gi, gi, 4).astype(np.float32),
                            device=dev)
    err = s1(grid, trs[0], fx, fy, perm, flip, inter, opt, W, H, gi)
    c.log(f"s1 max |superquad - production| = {err:.5f} "
          f"({'OK' if err < 3e-3 else 'MISMATCH'})")
    sq, prod = s2(grid, trs, fx, fy, perm, flip, inter, opt, W, H, gi)
    c.log(f"s2 superquad+probe kernel : {sq:7.3f} ms/frame")
    c.log(f"w2 production (batched)   : {prod:7.3f} ms/frame")
    # the probe warp's three parts, each over the poses on its own
    n = trs.shape[0]
    g = slab_render.FrameGeom(grid, trs, fx, fy, perm, flip, W, H, opt, gi)
    geos = [pose_geom(g, i) for i in range(n)]
    bg = float(opt.background_brightness)
    ins = [superquad_inputs(inter, geo, perm, W, H, gi) for geo in geos]
    outs = [combine_probe(*x, bg) for x in ins]
    parts = {
        "geometry + table + gather + transpose": lambda: [
            superquad_inputs(inter, geo, perm, W, H, gi) for geo in geos],
        "probe kernel": lambda: [combine_probe(*x, bg) for x in ins],
        "interleave": lambda: [interleave(o, W, H).contiguous()
                               for o in outs]}
    for name, fn in parts.items():
        c.log(f"s2 part, {name}: {c.sync_time(fn) / n * 1e3:7.3f} ms/frame")
    if "--profile" in sys.argv[1:]:
        c.profile_run(lambda: superquad_warp(inter, geos[0], perm, W, H, gi,
                                             opt), "probe warp, one pose")
        c.profile_run(lambda: slab_render._warp_to_screen(
            inter[None].expand(n, -1, -1, -1), opt, g.R, g.fx, g.fy, W, H,
            gi, perm, g.u0, g.du, g.v0, g.dv, g.scale, precise=False),
            f"production warp, {n} poses")


if __name__ == "__main__":
    main()
