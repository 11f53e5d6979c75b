"""The cost of the per-pose superquad table build in five layouts (the
counterpart of ``tools/perf_sq4.py``).

Each variant runs in situ on one pose: the intermediate image finalized
from a per-pose accumulator, a table build, and the shared ``tail`` (row
gather, planar transpose, tent-combine, interleave):

  b0  the production reference warp (``slab_render._warp_to_screen_ref``:
      quad table, per-pixel gather, bilinear combine)
  b1  the double-concat build (``perf_sq3``'s table)
  b2  stack + reshape
  b3  the build kernel, interleaved output (``build_probe``)
  b4  the build kernel, planar output, then a transpose

``build_probe`` (``csrc/probe_build.cu``) ports the reference's two Pallas
builds. Their channel orders differ: the interleaved build stacks cells in
(cy*4 + cx)*4 + c order (as b2 does), the planar one writes
``perf_sq3.chan`` order (as b1 does), and ``tail``'s combine reads
``chan``'s. So b2 and b3 time a warp whose numbers are wrong (the
reference's were timing variants); ``main()`` prints each variant's
max |.| against b0, which shows it.

The reference's ``tail`` calls ``display_warp._combine``, which the
reference no longer has; that function was ``perf_sq3.combine_pallas``
without its row blocking, so the port's ``tail`` runs ``perf_sq3``'s
kernel, ``combine_probe``.

    python -m volrend_torch.probes.perf_sq4 [--profile]

``--profile`` adds torch.profiler device-time breakdowns of b0 and b4 on
one pose.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from volrend_torch import kernels
from volrend_torch.probes.perf_sq3 import chan as _chan_idx
from volrend_torch.probes.perf_sq3 import combine_probe, interleave

_F32 = torch.float32
#: rows per block of the reference's build grid
_BH = 16
N_POSES = 24


def table_rows(gi: int) -> Tuple[int, int]:
    """(n, Hp): window rows gi - 3, padded to the reference's 16-row
    blocks."""
    n = gi - 3
    return n, -(-n // _BH) * _BH


def build_probe(it_planar: torch.Tensor, gi: int,
                planar: bool = False) -> torch.Tensor:
    """64-channel 4x4-window table of the (4, gi, gi) bf16 planar image.

    Interleaved: (Hp, gi - 3, 64), channel (cy*4 + cx)*4 + c; planar:
    (64, Hp, gi - 3), channel ``perf_sq3.chan(cy, cx, c)``. Window (Y, X)'s
    cell (cy, cx) colour c is it_planar[c, Y + cy, X + cx]; the padding
    rows Y >= gi - 3 are zero. Launches ``csrc/probe_build.cu`` on CUDA
    tensors (counted in ``launches``, or in ``launches_planar``); runs
    ``build_probe_ref`` on CPU tensors."""
    n, Hp = table_rows(gi)
    dev = it_planar.device
    if dev.type == "cpu":
        return build_probe_ref(it_planar, gi, planar)
    if dev.type != "cuda":
        raise RuntimeError(f"build_probe: no kernel for device {dev}")
    if (it_planar.dtype != torch.bfloat16
            or tuple(it_planar.shape) != (4, gi, gi)
            or not it_planar.is_contiguous()):
        raise ValueError(f"build_probe: it_planar must be a contiguous "
                         f"bfloat16 tensor of shape {(4, gi, gi)}; got "
                         f"{it_planar.dtype} {tuple(it_planar.shape)}")
    shape = (64, Hp, n) if planar else (Hp, n, 64)
    out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    lib = kernels.lib("probe_build")
    kernels.check(lib.vt_probe_build(
        it_planar.data_ptr(), out.data_ptr(), gi, Hp, int(planar),
        torch.cuda.current_stream(dev).cuda_stream), "probe_build")
    if planar:
        build_probe.launches_planar += 1
    else:
        build_probe.launches += 1
    return out


build_probe.launches = 0
build_probe.launches_planar = 0


def build_probe_ref(it_planar: torch.Tensor, gi: int,
                    planar: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``build_probe`` (bit-equal)."""
    n, Hp = table_rows(gi)
    cells = [(cy, cx, c, it_planar[c, cy:cy + n, cx:cx + n])
             for cy in range(4) for cx in range(4) for c in range(4)]
    if planar:
        out = it_planar.new_zeros((64, Hp, n))
        for cy, cx, c, v in cells:
            out[_chan_idx(cy, cx, c), :n] = v
        return out
    out = it_planar.new_zeros((Hp, n, 64))
    out[:n] = torch.stack([v for *_, v in cells], -1)
    return out


@dataclasses.dataclass(frozen=True)
class Setup:
    """What every variant shares: the grid's scale, the pose group's perm,
    the focal lengths (numbers or 0-d tensors), the frame and intermediate
    sizes and the options."""
    scale: torch.Tensor
    perm: Tuple[int, int, int]
    fx: object
    fy: object
    width: int
    height: int
    gi: int
    opt: object


def finalize(a: torch.Tensor, opt) -> torch.Tensor:
    """(4, gi, gi) accumulator [r, g, b, T] -> the (gi, gi, 4) intermediate
    image (perf_sq4.py:134-142, the display path's finalize)."""
    from volrend_torch.ops import slab_render
    return slab_render._finalize_planar(a[None], opt)[0].movedim(0, -1)


def sub_stuff(st: Setup, R, u0, du, v0, dv):
    """Per-subpixel positions, masks and the window corners from the
    IN-GRID subpixels (perf_sq4.py:147-176): (gys, gxs, okm) (4, Hh, Wh),
    (Y0, X0) (Hh, Wh) int32."""
    from volrend_torch.probes.perf_sq3 import sub_slopes
    geo = (R, st.fx, st.fy, u0, du, v0, dv, st.scale)
    subs = [sub_slopes(geo, st.perm, p, q, st.width, st.height, st.gi)
            for p in range(2) for q in range(2)]
    gys = torch.stack([s[0] for s in subs])
    gxs = torch.stack([s[1] for s in subs])
    okm = torch.stack([s[2] for s in subs])
    big = 1e9
    inb = okm > 0.5
    any_in = torch.any(inb, 0)
    ymin = torch.where(any_in, torch.amin(torch.where(inb, gys, big), 0),
                       0.0)
    xmin = torch.where(any_in, torch.amin(torch.where(inb, gxs, big), 0),
                       0.0)
    Y0 = torch.clamp(torch.floor(ymin).to(torch.int32), 0, st.gi - 4)
    X0 = torch.clamp(torch.floor(xmin).to(torch.int32), 0, st.gi - 4)
    return gys, gxs, okm, Y0, X0


def tail(st: Setup, tbl_rows, gys, gxs, okm, Y0, X0, stride: int):
    """Row gather, planar transpose, tent-combine (``combine_probe``, over
    the reference's background 1.0) and interleave -> (H, W, 4)."""
    qg = tbl_rows[(Y0 * stride + X0).long()]
    qgp = qg.permute(2, 0, 1).contiguous()
    ry = (gys - Y0.to(_F32)[None]).contiguous()
    rx = (gxs - X0.to(_F32)[None]).contiguous()
    out16 = combine_probe(qgp, ry, rx, okm.contiguous(), 1.0)
    return interleave(out16, st.width, st.height)


def b0(st: Setup, a, R, u0, du, v0, dv):
    from volrend_torch.ops import slab_render
    inter = finalize(a, st.opt)
    return slab_render._warp_to_screen_ref(
        inter[None], st.opt, R[None], st.fx, st.fy, st.width, st.height,
        st.gi, st.perm, u0[None], du[None], v0[None], dv[None],
        st.scale)[0]


def table_concat(st: Setup, a):
    """b1's table: two shifted concats (perf_sq3's), (n*n, 64) rows."""
    gi = st.gi
    it = finalize(a, st.opt).to(torch.bfloat16)
    qd = torch.cat([it[:-1, :-1], it[:-1, 1:], it[1:, :-1], it[1:, 1:]],
                   -1)
    return torch.cat([qd[:-2, :-2], qd[:-2, 2:], qd[2:, :-2], qd[2:, 2:]],
                     -1).reshape((gi - 3) * (gi - 3), 64)


def table_stack(st: Setup, a):
    """b2's table: the 16 shifted cells stacked, (n*n, 64) rows."""
    n = st.gi - 3
    it = finalize(a, st.opt).to(torch.bfloat16)
    parts = [it[cy:cy + n, cx:cx + n] for cy in range(4) for cx in range(4)]
    return torch.stack(parts, 2).reshape(n * n, 64)    # (n, n, 16, 4)


def _planar_bf16(st: Setup, a):
    inter = finalize(a, st.opt)
    return inter.permute(2, 0, 1).to(torch.bfloat16).contiguous()


def table_probe(st: Setup, a):
    """b3's table: the build kernel, interleaved output."""
    n = st.gi - 3
    tblp = build_probe(_planar_bf16(st, a), st.gi)          # (Hp, n, 64)
    return tblp[:n].reshape(n * n, 64)


def table_probe_planar(st: Setup, a):
    """b4's table: the build kernel, planar output, then a transpose."""
    n = st.gi - 3
    tblp = build_probe(_planar_bf16(st, a), st.gi, planar=True)
    return tblp[:, :n].permute(1, 2, 0).reshape(n * n, 64)


def _with_tail(table: Callable) -> Callable:
    def variant(st: Setup, a, R, u0, du, v0, dv):
        return tail(st, table(st, a), *sub_stuff(st, R, u0, du, v0, dv),
                    st.gi - 3)
    variant.table = table
    return variant


b1 = _with_tail(table_concat)
b2 = _with_tail(table_stack)
b3 = _with_tail(table_probe)
b4 = _with_tail(table_probe_planar)

VARIANTS: Dict[str, Callable] = {"b0 ref quad": b0, "b1 concat": b1,
                                 "b2 stack+T": b2, "b3 probe ilv": b3,
                                 "b4 probe+T": b4}


def run_variants(st: Setup, grid, trs, accs, flip: bool,
                 names: Sequence[str]
                 ) -> Dict[str, Tuple[float, float, Optional[float]]]:
    """{name: (ms per frame, max |variant - b0| over the poses, ms per
    frame of its table build alone or None for b0)} for the variants
    ``names`` over the poses of ``trs`` with accumulators ``accs`` (P, 4,
    gi, gi). Each timed call builds the poses' geometry and runs the
    variant pose after pose (the reference's lax.map)."""
    from volrend_torch.ops import slab_render
    from volrend_torch.probes._common import sync_time
    n = trs.shape[0]

    def frames(fn):
        g = slab_render.FrameGeom(grid, trs, st.fx, st.fy, st.perm, flip,
                                  st.width, st.height, st.opt, st.gi)
        # the focal lengths as device values: a host number would be
        # copied to the card in every call, which waits for the queue
        sg = dataclasses.replace(st, fx=g.fx, fy=g.fy)
        return [fn(sg, accs[i], g.R[i], g.u0[i], g.du[i], g.v0[i],
                   g.dv[i]) for i in range(n)]

    ref = frames(b0)
    out = {}
    for name in names:
        fn = VARIANTS[name]
        err = max(float((x - r).abs().max()) for x, r in zip(frames(fn),
                                                             ref))
        t = sync_time(lambda fn=fn: [x.sum() for x in frames(fn)])
        table = getattr(fn, "table", None)
        tb = None if table is None else sync_time(
            lambda: [table(st, accs[i]) for i in range(n)]) / n * 1e3
        out[name] = (t / n * 1e3, err, tb)
    return out


def main():
    import numpy as np
    from volrend_torch.probes import _common as c
    from volrend_torch.utils.options import RenderOptions

    dev = torch.device("cuda")
    grid = c.dense_grid_on(dev)
    opt = RenderOptions(max_steps=1024)
    cams = c.orbit_poses(c.N_ORBIT)
    groups = c.pose_groups(grid, cams)
    (perm, flip), idx = max(groups.items(), key=lambda kv: len(kv[1]))
    trs = c.transforms(cams, idx[:N_POSES], dev)
    st = Setup(grid.scale, perm, float(cams[0].fx), float(cams[0].fy), c.W,
               c.H, c.GI, opt)
    rng = np.random.default_rng(0)
    accs = torch.as_tensor(rng.uniform(0.1, 0.9, (trs.shape[0], 4, c.GI,
                                                  c.GI)).astype(np.float32),
                           device=dev)
    c.log(f"setup; {trs.shape[0]} poses of group {perm}/{flip}; "
          f"{torch.cuda.get_device_name(0)}")
    for name, (ms, err, tb) in run_variants(st, grid, trs, accs, flip,
                                            list(VARIANTS)).items():
        build = "" if tb is None else f" (table build alone {tb:6.3f})"
        c.log(f"{name}: {ms:6.3f} ms/frame{build}, max |. - b0| {err:.4f}")
    if "--profile" in sys.argv[1:]:
        from volrend_torch.ops import slab_render
        g = slab_render.FrameGeom(grid, trs[:1], st.fx, st.fy, perm, flip,
                                  c.W, c.H, opt, c.GI)
        sg = dataclasses.replace(st, fx=g.fx, fy=g.fy)
        for name in ("b0 ref quad", "b4 probe+T"):
            c.profile_run(lambda fn=VARIANTS[name]: fn(
                sg, accs[0], g.R[0], g.u0[0], g.du[0], g.v0[0], g.dv[0]),
                f"{name}, one pose")


if __name__ == "__main__":
    main()
