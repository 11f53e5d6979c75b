#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``volrend_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version at the display path's full width, drives the display render path
end to end and gates its quality against the exact octree renderer.

    python3 chip_smoke.py [--profile]

``--profile`` adds torch.profiler traces of one dense and one sparse
main-path run, each also with the parent's display warp in place of kernel
W (device time by kernel and by call site, DISPLAY_RANGES; the device's
idle share), and of one training step with the precise warp's switch off
and on (the latter with the device time of the precise warp's calls,
PRECISE_RANGES).

Phases (any failure exits non-zero and prints no result):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, and
   the kernel build (one ``nvcc`` per source, all in parallel);
2. the dense bench scene: the procedural SH16 octree at depth 7, uploaded
   and baked to an int8 256^3 grid on the card;
3. kernel checks on real inputs from orbit pose 0 and a steep but
   slab-compatible pose (slope close to MAX_SLAB_SLOPE): each kernel
   against its plain version on the same CUDA tensors (kernel M's plain
   version, which marches pose after pose, on PLAIN_POSES poses spread over
   the kernel's whole-group launch), with times (CUDA events, median of
   KREPS) beside the least time the card could take for this data (the
   march's bound counts the slabs the rays meet and the voxels above the
   sigma threshold); kernel M's display launch configuration (its tile
   height) with its resident blocks per SM, registers and spills; kernel
   W and its fit mode against their plain versions, W against kernel B's
   and C's composition and the fit decisions against the parent's
   predicates, and the display warp stage's device time in turns against
   the parent's (its PyTorch geometry and fit predicates, B, C and
   copies), which it must beat on every launch checked;
4. the main path: ``render_frames`` over 200 orbit poses grouped by
   (perm, flip), RGBA8 output, gi=256 — launch counts reset just before and
   read just after, so every pose must have gone through kernels M and W
   (and the fit mode), none through kernels B and C or the reference
   warp; median wall time of REPS runs and the peak device memory; then
   every frame against the parent's composition of the same path (the
   PyTorch geometry, B and C; ``parent_warp_to_screen_sq``) on the card,
   within one quantum, and the fit decisions against the parent's;
5. the quality gate: orbit pose 0 against ``render_exact.render_rays`` at
   stride 5 (>= 54 dB);
6. the measurement probes (``volrend_torch/probes/``) on the dense grid at
   their own width (800^2, gi=448, the 96 orbit poses): the tent-combine
   (P7), payload-stream (P8) and table-build (P9, both layouts) kernels
   against their plain versions, with times, bounds and library
   yardsticks; then the probes' own numbers (the stream's GB/s beside
   kernel M's one-pose time, host-synced and, apart, on the card and the
   host's issue; perf_sq3's s1 and s2, perf_sq4's b0, b3 and b4) with the
   probe kernels' launch counts reset just before and read just after;
7. the sparse solid scene: each kernel against its plain version on
   every pose group (cropped payloads, culled slab lists), then 96 orbit
   poses at full width, throughput, the frames against the parent's and a
   gate at stride 8 (>= 47.5 dB);
8. training at the reference's training-bench width (tools/bench_train.py:
   ``make_solid_tree(max_depth=7, basis_dim=9, seed=7)``, G=256 SH9,
   800^2 frames, gi=256, 4 orbit poses of one (perm, flip) group,
   ``FrameTrainer(lr=5e-2)``): the pyramid bake kernel against its plain
   versions (the bake bit for bit, its live bits equal), its time against
   its bound and against the plain chain's (the parent's forward bake);
   kernel M's training mode and the backward
   kernel against their plain versions on pose 0, both on the bake's own
   f32 tensor (the default trainer's) and on its bf16 cast (the lean
   trainer's), seen through the group's permutation, and the coarse
   occupancy they share, in both modes (the full read of the sigma and the
   reduction of the bake's live bits), bit-equal to their plain versions,
   with times, bounds
   (at the tensor's element size), each launch's registers, spills and
   blocks per SM, and the share of slabs skipped as empty;
   then the precise superquad warp's kernels on pose 0 (kernel B's and
   C's f32 table modes, C's precise-level kernel also bit for bit against
   its generic one, the combine adjoint with its table's zero fill and the
   build adjoint) against their plain versions, with times, bounds and
   library yardsticks, and
   the whole precise warp's output and gradient against autograd through
   the reference warp; then timed ``step_frame`` steps (synced and
   ``sync=False``) with the precise warp's switch (``display_warp.
   _PRECISE_SQ``) off and then on, the launch counts reset just before
   and read just after each run — every step must run exactly one launch
   of each kernel of its path (the bake kernel and the occupancy's bits
   mode among them) and no plain version, and with the switch on
   no pose may take the reference warp — and the peak device memory;
   ``--profile`` traces one step and fails if it holds a bf16 copy as long
   as writing the bake in bf16 takes (the planar copy the kernels replaced);
9. the recovery gate at G=128 (examples/train_slab_demo.py): corrupt the
   leaf rows, train 60 steps, PSNR must rise by more than 5 dB;
10. one JSON line with every kernel's numbers, then the result line.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
W = H = 800
GI = 256
DEPTH = 7
BASIS_DIM = 16
N_POSES = 200
N_POSES_SPARSE = 96
FLOOR_ORBIT = 54.0
FLOOR_SPARSE = 47.5
CACHE_SPARSE = os.path.join(HERE, ".torch_bench_sparse_cache.npz")
CACHE_TRAIN = os.path.join(HERE, ".torch_bench_train_cache.npz")
CACHE_DEMO = os.path.join(HERE, ".torch_train_demo_cache.npz")
TRAIN_LR = 5e-2
TRAIN_POSES = 4
TRAIN_WARM = 2          # untimed steps per pose before timing
TRAIN_STEPS = 3         # timed steps per pose (synced, then sync=False)
DEMO_DEPTH = 6          # the recovery demo's G=128 scene
DEMO_GI = 448
DEMO_STEPS = 60
DEMO_GAIN_DB = 5.0
REPS = 3            # main-path repetitions
KREPS = 10          # kernel timing repetitions (back to back)
SLEEP_CYCLES = 20_000_000   # ~10 ms of device sleep ahead of a timed run
PLAIN_POSES = 4     # poses of a display batch the plain march runs on
# tolerances of each kernel against its plain version on the card
TOL_M = 1e-3        # acc4: both f32, they differ only in summation order
# ... except where a ray's transmittance lands within float rounding of the
# stop threshold: one version freezes, the other composites one more slab
# (a discrete decision). Such rays are saturated in both versions, differ
# by at most stop_thresh, and must stay rare.
MAX_FREEZE_FLIPS = 1e-4   # share of rays
# the backward kernel against its plain version: relative L2 and cosine of
# the payload cotangent (f32 both; the kernel adds with atomics in a
# run-dependent order, and a freeze-flipped ray moves its own voxels' terms)
TOL_BWD_REL = 1e-3
TOL_BWD_REL_BF16 = 4e-3   # a bf16 cotangent: the f32 one rounded once
MIN_BWD_COS = 0.9999
TOL_C_F32 = 1e-5    # combine f32 emit
TOL_C_U8 = 1        # combine uint8 emit, in display quanta
# the precise warp's adjoint kernels against their plain versions: f32
# both, another summation order (kernel 6 adds in the same order per
# output, the plain version's slices may not; kernel 5 adds the blocks that
# share a table row with atomics, in a run-dependent order, where the plain
# version's index_add_ has its own)
TOL_ADJ_REL = 1e-6
# the whole precise warp against autograd through the reference warp (the
# reference's test: tests/test_slab_grad.py::
# test_precise_sq_warp_vjp_matches_autodiff)
TOL_PRECISE_OUT = 5e-5
TOL_PRECISE_GRAD_ATOL = 5e-5      # times the largest |gradient|
TOL_PRECISE_GRAD_RTOL = 5e-4
# card peaks for the bounds (NVIDIA data sheet, H100 SXM, dense rates)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# the display path's call sites whose device time ``--profile`` reports
# apart, for kernel W's path and for the parent's warp it replaced
# (parent_warp_to_screen_sq); the main path's frame copy in render_all is
# outside them all
DISPLAY_RANGES = tuple(
    (f"volrend_torch.ops.{mod}", name) for mod, name in (
        ("slab_render", "render_frames"),
        ("slab_render", "FrameGeom.__init__"),
        ("slab_render", "_march_frame_fields"), ("slab_march", "march_slabs"),
        ("slab_render", "_finalize_planar"),
        ("display_warp", "warp_to_screen_sq"),
        ("display_warp", "_pixel_slopes"),
        ("display_warp", "_level_misfits"),
        ("display_warp", "_level_geometry"), ("display_warp", "build_table"),
        ("display_warp", "combine_emit"),
        ("display_warp", "level_fit_counts"),
        ("display_warp", "warp_display")))
# the precise warp's calls whose device time ``--profile`` reports in the
# switch-on training step (the backward's kernel 5 and kernel 6 nested in
# it)
PRECISE_RANGES = tuple(
    ("volrend_torch.ops.display_warp", name) for name in (
        "_level_geometry", "build_table", "combine_emit",
        "_PreciseWarp.backward", "combine_adjoint", "build_adjoint"))

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls queued behind a device sleep (so the host's launch
    overhead stays out of the reading of a short kernel), over ``reps``;
    the median of three such runs."""
    for _ in range(warm):
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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    fp32 operations over the fp32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def tent_taps(torch, ry, rx, okm, win) -> int:
    """The tent terms a superquad warp's data needs: per in-grid subpixel
    (okm), the window cells whose weight is non-zero at its position
    clamped into the window, 1 or 2 a side (2 where it lies between two
    cells). The bounds of kernels C, 5 and W count these, not the whole
    window."""
    ryc = torch.clamp(ry, 0.0, win[0] - 1.0)
    rxc = torch.clamp(rx, 0.0, win[1] - 1.0)
    ny = 1 + (ryc != torch.floor(ryc)).long()
    nx = 1 + (rxc != torch.floor(rxc)).long()
    return int((ny * nx * (okm > 0.5).long()).sum())


def march_work(torch, pay, qs, zb, slab_ids, G: int, bd: int,
               sigma_thresh: float):
    """What this run's data asks of the march, counted from the payload and
    the per-pixel z intervals: a slab is marched for a pose when some
    pixel's interval [zlo, zhi] (zb[p, 0:2]) meets it; a voxel is shaded,
    and its colour planes read, only when its sigma is above the threshold.
    Bytes count the payload's element size (int8 codes; a training
    payload's f32 or bf16 values). Returns (sigma bytes of the slabs
    marched for any pose, colour bytes of their voxels above the
    threshold, per pose: voxels above the
    threshold in its marched slabs, per pose: (pixel, slab) pairs marched).
    The pairs count every slab of a pixel's interval, also those behind the
    point where the ray saturates."""
    D = 3 * bd + 1
    Gy, Gx = pay.shape[2], pay.shape[3]
    sig_planes = 2 if pay.dtype == torch.int8 else 1
    ids = list(slab_ids)
    over = []
    for s in ids:
        sl = pay[s]
        # a training payload's values as the kernels read them (bf16)
        sig = (sl[D - 1].float() * 128.0 + sl[D].float() if sig_planes == 2
               else sl[D - 1].to(torch.bfloat16).float())
        over.append(int((sig * float(qs[D - 1]) > sigma_thresh).sum()))
    over = np.asarray(over, np.int64)
    hG = 0.5 / G
    z = (torch.as_tensor(ids, dtype=torch.float32, device=zb.device)
         + 0.5) / G
    marched = np.zeros(len(ids), bool)
    over_p, pairs_p = [], []
    for p in range(zb.shape[0]):
        zlo, zhi = zb[p, 0], zb[p, 1]
        hit = ((zlo[None] <= z[:, None, None] + hG)
               & (zhi[None] >= z[:, None, None] - hG)
               & (zlo <= zhi)[None])                          # (S, gi, gi)
        live = hit.flatten(1).any(1).cpu().numpy()
        marched |= live
        over_p.append(int(over[live].sum()))
        pairs_p.append(int(hit.sum()))
    elem = pay.element_size()
    sig_bytes = int(marched.sum()) * sig_planes * Gy * Gx * elem
    colour_bytes = int(over[marched].sum()) * 3 * bd * elem
    return sig_bytes, colour_bytes, over_p, pairs_p


def march_bound(torch, pay, qs, zb, slab_ids, G: int, gi: int, bd: int,
                sigma_thresh: float):
    """Kernel M's bound for one launch over the poses of ``zb`` (P, 4, gi,
    gi), from march_work: bytes are the marched slabs' sigma planes and the
    colour planes of their voxels above the threshold, read once, plus, per
    pose, the three z planes read and the accumulator written; operations
    per pose are the shading of its voxels above the threshold (3 MACs per
    SH basis function, the basis polynomials, the direction and three
    sigmoids: ~9*bd + 30 per voxel) and, per marched (pixel, slab) pair,
    the two-axis overlap weights, four channel taps and the composite
    (~60)."""
    sig_b, col_b, over_p, pairs_p = march_work(torch, pay, qs, zb, slab_ids,
                                               G, bd, sigma_thresh)
    P = zb.shape[0]
    nbytes = sig_b + col_b + P * (3 + 4) * gi * gi * 4
    flops = sum(o * (9 * bd + 30) + n * 60 for o, n in zip(over_p, pairs_p))
    return bound(nbytes, flops)


def march_bwd_bound(torch, pay, qs, zb, G: int, gi: int, bd: int,
                    sigma_thresh: float, out_bytes: int = 4):
    """The backward kernel's bound for one pose (zb (1, 4, gi, gi)): bytes
    are what the forward reads (march_bound's payload bytes), the whole
    (Gz, D, G, G) cotangent written once (``out_bytes`` per value: f32, or
    bf16 for the lean trainer) and the per-pixel inputs read (two z planes,
    four upstream cotangents, the four forward outputs); operations are the
    forward recompute (march_bound's) plus the adjoint: per marched (pixel,
    slab) pair the suffix algebra and the transposed taps (~60), per voxel
    above the threshold the shade adjoint (the basis again, sigmoid', 3*bd
    products: ~6*bd + 40)."""
    Gz, D = pay.shape[0], pay.shape[1]
    sig_b, col_b, (over,), (pairs,) = march_work(
        torch, pay, qs, zb, range(Gz), G, bd, sigma_thresh)
    nbytes = (sig_b + col_b + Gz * D * G * G * out_bytes
              + (2 + 4 + 4) * gi * gi * 4)
    flops = over * (9 * bd + 30 + 6 * bd + 40) + pairs * (60 + 60)
    return bound(nbytes, flops)


def freeze_flip_check(torch, tag, acc_k, acc_p, stop):
    """Kernel M's acc against its plain version: max |diff|, and the rays
    past TOL_M (stop-threshold freeze flips, allowed only in saturated rays,
    up to MAX_FREEZE_FLIPS of them, by at most stop + TOL_M). Returns
    (max err, flips, rays)."""
    diff = (acc_k - acc_p).abs().amax(1)                    # (P, gi, gi)
    err = float(diff.max())
    off = diff > TOL_M
    sat = torch.maximum(acc_k[:, 3], acc_p[:, 3]) < stop
    flips = int(off.sum())
    ok = (np.isfinite(err) and err <= stop + TOL_M
          and bool(torch.all(sat[off]))
          and flips <= MAX_FREEZE_FLIPS * off.numel())
    log(f"kernel M [{tag}]: max |acc - plain| {err:.3e}; {flips} of "
        f"{off.numel()} rays past {TOL_M} (stop-threshold freeze flips, "
        f"allowed in saturated rays up to {MAX_FREEZE_FLIPS:.0e} of them, "
        f"by <= {stop + TOL_M})")
    if not ok:
        fail(f"kernel M disagrees with its plain version at {tag}")
    return err, flips, off.numel()


def steep_pose(Camera, slab_render, grid, lo=3.6, hi=3.95):
    """Orbit pose 0's view with the focal narrowed until the boundary-ray
    slope lies in [lo, hi): steep, yet below MAX_SLAB_SLOPE."""
    from volrend_torch.probes._common import orbit_poses
    base = orbit_poses(1)[0]
    f_lo, f_hi = 20.0, float(base.fx)
    for _ in range(60):
        f = 0.5 * (f_lo + f_hi)
        cam = Camera(W, H, f, f, base.transform)
        _, _, s = slab_render.choose_axis(grid, cam.transform, f, f, W, H)
        if lo <= s < hi:
            return cam, s
        if s >= hi:
            f_lo = f
        else:
            f_hi = f
    fail("no steep slab-compatible focal found")


def display_occupancy(kernels, bd: int, cfg: dict) -> dict:
    """What the card makes of a display launch configuration
    (vt_march_display_info): resident blocks per SM, registers a thread,
    spill bytes a thread, static shared memory."""
    import ctypes
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib("slab_march_display").vt_march_display_info(
        bd, cfg["rows"], cfg["smem"], out), "slab_march_display")
    return {"blocks_per_sm": out[0], "regs": out[1], "spill_bytes": out[2],
            "static_smem": out[3]}


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse < 1e-12 else -10.0 * float(np.log10(mse))


def train_orbit(Camera, n=TRAIN_POSES):
    """The training bench's poses (tools/bench_train.py): one (perm, flip)
    group of orbit views at radius 2.6, elevation 0.45."""
    cams = []
    for i in range(n):
        th = 0.25 + 0.1 * i
        back = np.array([np.cos(th), np.sin(th), 0.45])
        back /= np.linalg.norm(back)
        cams.append(Camera.from_vectors(center=tuple(2.6 * back),
                                        v_back=tuple(back), width=W,
                                        height=H))
    return cams


def train_phase(torch, dev, stats):
    """Phases 8 and 9: the training path at the training bench's width,
    then the recovery gate. Fills stats["BK"] (the bake kernel),
    stats["MT"] (kernel M, training mode), stats["MB"] (the backward
    kernel), stats["MO"] (their coarse occupancy) and, through
    precise_checks, the precise warp's kernels; returns a summary dict."""
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import slab_grad, slab_march, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes import _common
    from volrend_torch.utils.options import RenderOptions

    topt = RenderOptions(max_steps=1024)
    t = time.perf_counter()
    tree = _common.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=DEPTH, basis_dim=9, seed=7))
    log(f"train: tree ready in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tdev = tree.to_device(lut_depth=None, device=dev)
    tr = train.FrameTrainer(tdev, opt=topt, lr=TRAIN_LR, gi=GI)
    torch.cuda.synchronize()
    G, D, bd = tr.grid.G, tr.grid.data_dim, tr.grid.basis_dim
    log(f"train: FrameTrainer (f16 bake, bake map, pyramid) G={G} SH{bd} "
        f"in {time.perf_counter() - t:.1f} s; pyramid levels "
        f"{[tuple(p.shape) for p in tr.pyramid]}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    cams = train_orbit(Camera)
    groups = {tr._group(c) for c in cams}
    if len(groups) != 1:
        fail(f"train: the poses span {len(groups)} (perm, flip) groups")
    (perm, flip), = groups
    tgt = torch.full((H, W, 4), 0.5, dtype=torch.float32, device=dev)

    # ---- 8a. the pyramid bake kernel, then the march pair on pose 0 ------
    # both march kernels read the bake's own tensor through the group's
    # permutation: the default trainer's f32 bake (the kernels line's rows)
    # and the lean trainer's bf16 cast of it
    cam = cams[0]
    stats["BK"], bake, live = bake_checks(torch, tr,
                                          float(topt.sigma_thresh))
    geom = slab_render.FrameGeom(tr.grid, cam.transform, cam.fx, cam.fy,
                                 perm, flip, W, H, tr.opt, GI)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=D, bd=bd, fmt=int(tr.grid.fmt),
                            perm=perm, flip=flip, ids=ids, opt=tr.opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    rng = np.random.default_rng(0)
    gacc4 = torch.as_tensor(rng.normal(size=(4, GI, GI)).astype(np.float32),
                            device=dev)
    acc4 = None
    for dt in (torch.float32, torch.bfloat16):
        pay = bake if dt == torch.float32 else bake.to(torch.bfloat16)
        planar = pay.permute(perm[0], 3, perm[1], perm[2])
        res = train_kernel_checks(torch, dev, planar, params, zb, gacc4, ids,
                                  cfg, float(topt.stop_thresh), live)
        log(f"train kernels [{dt}]: M (training mode) "
            f"{json.dumps(res['MT'])}; M-bwd {json.dumps(res['MB'])}; "
            f"coarse occupancy {json.dumps(res['MO'])}")
        if dt == torch.float32:
            stats["MT"], stats["MB"], stats["MO"] = (res["MT"], res["MB"],
                                                     res["MO"])
            acc4 = res["acc4"]
        else:
            stats["train_lean_kernels"] = {k: res[k]
                                           for k in ("MT", "MB", "MO")}
        del pay, planar, res
    del bake, live
    # the training finalize of pose 0's march: (1, gi, gi, 4) rgb, 1 - T
    inter = torch.cat([acc4[:3], 1.0 - acc4[3:]]).movedim(0, -1)[None]
    gargs = (geom.R, geom.fx, geom.fy, W, H, GI, perm, geom.u0, geom.du,
             geom.v0, geom.dv, geom.scale)
    del acc4
    torch.cuda.empty_cache()

    # ---- 8b. the precise superquad warp on pose 0 --------------------------
    precise = precise_checks(torch, dev, inter.contiguous(), gargs, tr,
                             cams[0], perm, stats)
    del inter
    torch.cuda.empty_cache()

    # ---- 8c. timed steps, the precise warp's switch off and on -------------
    from volrend_torch.ops import display_warp
    off = timed_steps(torch, tr, cams, tgt, "train")
    display_warp._PRECISE_SQ = True
    try:
        on = timed_steps(torch, tr, cams, tgt, "train (precise warp)")
    finally:
        display_warp._PRECISE_SQ = False
    n = off["steps"]
    for name, c in (("switch off", off["counts"]),
                    ("switch on", on["counts"])):
        if (c["march"] != n or c["march_bwd"] != n or c["bake"] != n
                or c["occupancy_live"] != n or c["occupancy"]
                or sum(c["plain"].values())):
            fail(f"train ({name}): a step did not run exactly one launch of "
                 f"the bake kernel, of kernels M and M-bwd and of their "
                 f"shared coarse occupancy in its bits mode, and no plain "
                 f"version ({c})")
    c = off["counts"]
    if (c["build_f32"], c["combine_f32"], c["combine_adj"],
            c["build_adj"], c["ref_warp_poses"]) != (0, 0, 0, 0, n):
        fail(f"train (switch off): a step left the reference warp ({c})")
    c = on["counts"]
    if (c["build_f32"], c["combine_f32"], c["combine_adj"],
            c["build_adj"], c["ref_warp_poses"]) != (n, n, n, n, 0):
        fail(f"train (switch on): a step did not run exactly one launch of "
             f"B-f32, C-f32 and kernels 5 and 6, or a pose took the "
             f"reference warp ({c})")
    if "--profile" in sys.argv[1:]:
        prof = _common.profile_run(lambda: tr.step_frame(cams[0], tgt),
                                   "training step", log)
        # the kernels read the bake itself: a bf16 copy as long as writing
        # the bake's values in bf16 takes at the memory's rate would be the
        # planar copy they replaced
        least = G ** 3 * D * 2 / HBM_BYTES_PER_S * 1e3
        copies = {k: v for k, v in prof.items() if "bfloat16_copy" in k}
        big = {k: v for k, v in copies.items() if v[2] >= least}
        log(f"training step: bf16 copies (ms, launches, longest ms) "
            f"{copies}; none may take {least:.4f} ms or more")
        if big:
            fail(f"the training step copies the bake to bf16 ({big})")
        display_warp._PRECISE_SQ = True
        try:
            _common.profile_run(lambda: tr.step_frame(cams[0], tgt),
                                "training step (precise warp)", log,
                                PRECISE_RANGES)
        finally:
            display_warp._PRECISE_SQ = False
    summary = {"train_ms_synced": off["ms_synced"],
               "train_ms_pipelined": off["ms_pipelined"],
               "train_peak_gib": off["peak_gib"], "train_counts": off["counts"],
               "train_G": G, "train_steps": n,
               "train_precise_ms_synced": on["ms_synced"],
               "train_precise_ms_pipelined": on["ms_pipelined"],
               "train_precise_peak_gib": on["peak_gib"],
               "train_precise_counts": on["counts"], **precise}
    del tr, tdev, tree
    torch.cuda.empty_cache()
    summary.update(recovery_gate(torch, dev, topt))
    return summary


def bake_checks(torch, tr, thresh: float):
    """Phase 8a's first part: the pyramid bake kernel on the training
    bench's pyramid against its plain versions (the bake bit for bit, the
    live bits equal), its time (with the live bits, as the step launches
    it) against its bound and against the plain chain's, which is the
    parent's forward bake. Returns (the kernels-line stats, bake, live)."""
    from volrend_torch.ops import slab_grad
    pyr, bmap = tr.pyramid, tr.bmap
    G, D = bmap.G, bmap.D
    tag = f"G={G}, D={D}, {len(pyr)} levels"
    with torch.no_grad():
        def run_k():
            return slab_grad.bake_from_pyramid(pyr, bmap, live_thresh=thresh)

        def run_p():
            return slab_grad.bake_from_pyramid_ref(pyr, bmap)
        bake, live = run_k()
        plain = run_p()
        if not torch.equal(bake, plain):
            fail(f"the bake kernel differs from its plain version ({tag})")
        if not torch.equal(live.bits, slab_grad.live_bits_ref(
                plain, thresh).bits):
            fail(f"the bake kernel's live bits differ from live_bits_ref "
                 f"({tag})")
        del plain
        st = {"max_abs_err": 0.0, "library_ms": None,
              "ms": cuda_ms(torch, run_k, KREPS),
              "plain_ms": cuda_ms(torch, run_p, 3),
              "ms_without_bits": cuda_ms(
                  torch, lambda: slab_grad.bake_from_pyramid(pyr, bmap),
                  KREPS)}
        # bytes: the bake written, each level's masked records and its mask
        # read once, the bits written
        st["bound_ms"], st["bound_by"] = bound(
            G ** 3 * D * 4 + sum(bmap.sizes) * D * 4
            + sum(m.numel() for m in bmap.masks) + live.bits.numel() * 4, 0)
        if "--profile" in sys.argv[1:]:  # the parent's forward by launch
            from volrend_torch.probes import _common
            _common.profile_run(run_p, "forward bake, plain chain", log)
    live_share = float(torch.count_nonzero(live.bits)) / live.bits.numel()
    log(f"bake kernel [{tag}]: bit-equal to its plain version, live bits "
        f"equal; {st['ms']:.4f} ms with the live bits "
        f"({st['ms_without_bits']:.4f} without) against its bound "
        f"{st['bound_ms']:.4f} ms ({st['bound_by']}) and the plain chain "
        f"(the parent's forward bake) {st['plain_ms']:.4f} ms; "
        f"{live_share:.4f} of the bit words non-zero")
    return st, bake, live


def train_occupancy(kernels, bd: int, f32: bool) -> dict:
    """What the card makes of the training kernels' launches
    (vt_march_slabs_info, vt_march_slabs_bwd_info): resident blocks per SM,
    registers a thread, spill bytes a thread and dynamic shared memory of
    kernel M's training mode and of the backward's passes, and the launch
    configuration they were built with."""
    import ctypes
    m = (ctypes.c_int * 11)()
    kernels.check(kernels.lib("slab_march").vt_march_slabs_info(
        bd, int(f32), m), "slab_march")
    b = (ctypes.c_int * 7)()
    kernels.check(kernels.lib("slab_march_bwd").vt_march_slabs_bwd_info(
        bd, int(f32), b), "slab_march_bwd")
    keys = ("blocks_per_sm", "regs", "spill_bytes", "smem")
    return {"M": dict(zip(keys, m[:4])),
            "M-bwd pass 1": dict(zip(keys, b[:4])),
            "M-bwd pass 2": dict(zip(keys[:3], b[4:])),
            "config": dict(zip(("ty", "tx", "nt", "ps", "ring", "dc",
                                "rslots"), m[4:]))}


def train_kernel_checks(torch, dev, planar, params, zb, gacc4, ids, cfg,
                        stop, live):
    """Phase 8a on one payload (the bake's f32 view or its bf16 cast):
    kernel M's training mode and the backward kernel against their plain
    versions on pose 0 (and their shared coarse occupancy in both modes,
    each bit-equal to its plain version and to the other), their times,
    bounds (counted at the payload's element size), launch configuration
    and the share of slabs and jobs skipped as empty (the kernels' counts).
    ``live``: the pyramid bake's live bits. Returns {"MT", "MB", "MO",
    "acc4"}; "MO" is the bits mode the step launches, with the full read's
    numbers under "full_read"."""
    from volrend_torch import kernels
    from volrend_torch.ops import slab_march
    G, D, bd = cfg.G, cfg.D, cfg.bd
    perm, flip = cfg.perm, cfg.flip
    f32 = planar.dtype == torch.float32
    qs = torch.ones(D, device=dev)
    tag = f"pose 0, {G} slabs, {planar.dtype}"

    m = slab_march.march_inputs(planar, params, zb, G, GI, ids)
    sthr = float(m["params"][0, 14])
    # the coarse occupancy both kernels share (built once a step): the full
    # read of every voxel's sigma, and the bits mode the step launches
    occ = slab_march.march_occupancy(planar, m["params"], qs)
    occ_p, full_plain_ms = timed_once(
        torch, lambda: slab_march.march_occupancy_ref(planar, m["params"],
                                                      qs))
    if not torch.equal(occ, occ_p):
        fail(f"the coarse occupancy differs from its plain version ({tag})")
    host = m["params"].cpu()  # the bits mode checks the threshold here

    def run_bits():
        return slab_march.march_occupancy(planar, host, qs, live=live,
                                          perm=perm)
    occ_b = run_bits()
    occ_bp, mo_plain_ms = timed_once(
        torch, lambda: slab_march.march_occupancy_live_ref(live, perm))
    if not (torch.equal(occ_b, occ_bp) and torch.equal(occ_b, occ)):
        fail(f"the coarse occupancy's bits mode differs from its plain "
             f"version or from the full read ({tag})")
    nz = int(torch.count_nonzero(occ)), occ.numel()
    full = {"plain_ms": full_plain_ms,
            "ms": cuda_ms(torch, lambda: slab_march.march_occupancy(
                planar, m["params"], qs), KREPS)}
    # bytes: every voxel's sigma read once, the masks written
    full["bound_ms"], full["bound_by"] = bound(
        planar.shape[0] * planar.shape[2] * planar.shape[3]
        * planar.element_size() + occ.numel() * 8, 0)
    mo = {"max_abs_err": 0.0, "plain_ms": mo_plain_ms, "library_ms": None,
          "ms": cuda_ms(torch, run_bits, KREPS), "full_read": full}
    # bytes: the live bits read once, the masks written
    mo["bound_ms"], mo["bound_by"] = bound(
        live.bits.numel() * 4 + occ.numel() * 8, 0)
    log(f"coarse occupancy [{tag}]: both modes bit-equal to their plain "
        f"versions and to each other; bits mode {mo['ms']:.4f} ms (bound "
        f"{mo['bound_ms']:.4f}), full read {full['ms']:.4f} ms (bound "
        f"{full['bound_ms']:.4f}); {nz[0]} of {nz[1]} (slab, block row) "
        f"masks hold a block above the threshold")
    del occ_p, occ_bp, occ_b

    def run_m():
        return slab_march.march_slabs(
            planar, params, qs, zb, G, GI, D, bd, perm, slab_ids=ids,
            flip=flip, bbox_full=True, dir_win=False, occupancy=occ)
    acc_k = run_m()
    torch.cuda.synchronize()
    acc_p, mt_plain_ms = timed_once(
        torch, lambda: slab_march.march_slabs_ref(planar, qs, D=D, bd=bd,
                                                  flip=flip, **m))
    err, flips, nray = freeze_flip_check(
        torch, f"training mode, {tag}", acc_k, acc_p, stop)
    del acc_p
    mt = {"max_abs_err": err, "plain_ms": mt_plain_ms,
          "ms": cuda_ms(torch, run_m, KREPS), "library_ms": None}
    mt["bound_ms"], mt["bound_by"] = march_bound(
        torch, planar, qs, m["zb"], ids, G, GI, bd, sthr)
    sig_b, col_b, (over,), (pairs,) = march_work(torch, planar, qs, m["zb"],
                                                 ids, G, bd, sthr)
    log(f"train [{tag}]: pose 0's march reads {sig_b} B of sigma and "
        f"{col_b} B of colour ({over} voxels above the sigma threshold) "
        f"and marches {pairs} (pixel, slab) pairs")

    acc4 = acc_k[0]

    def run_b():
        return slab_march.march_slabs_bwd(
            planar, params[0], qs, zb[0], gacc4, acc4, G, GI, D, bd, perm,
            flip=flip, bbox_full=True, out_dtype=planar.dtype,
            occupancy=occ)

    g_k = run_b()
    torch.cuda.synchronize()
    if g_k.stride() != planar.stride():
        fail(f"the backward's cotangent has strides {g_k.stride()}, not the "
             f"payload's {planar.stride()}")
    bprm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
        params[0], zb[0], gacc4, acc4, G, GI)
    g_p, mb_plain_ms = timed_once(
        torch, lambda: slab_march.march_slabs_bwd_ref(
            planar, qs, bprm, bzb, bgacc, aux, G, GI, D, bd, flip))
    # element by element over the (Gz, D, G, G) indices (the kernel's
    # cotangent has the payload's strides, the plain version's is planar)
    gk = g_k.double()
    gp = g_p.double()
    rel = float((gk - gp).norm() / gp.norm())
    cos = float((gk * gp).sum() / (gk.norm() * gp.norm()))
    mx = float((g_k.float() - g_p).abs().max())
    # a bf16 cotangent is the f32 one rounded once (2^-9 relative)
    tol = TOL_BWD_REL if f32 else TOL_BWD_REL_BF16
    log(f"kernel M-bwd [{tag}]: relative L2 {rel:.3e}, cosine {cos:.9f}, "
        f"max |diff| {mx:.3e} (max |plain| {float(gp.abs().max()):.3e}); "
        f"forward freeze flips {flips} of {nray} rays (tolerance: relative "
        f"L2 < {tol}, cosine > {MIN_BWD_COS})")
    if not (np.isfinite(rel) and rel < tol and cos > MIN_BWD_COS):
        fail(f"the backward kernel disagrees with its plain version ({tag})")
    del g_k, g_p, gk, gp
    mb = {"max_abs_err": mx, "rel_l2": rel, "cosine": cos,
          "freeze_flips": flips, "plain_ms": mb_plain_ms,
          "ms": cuda_ms(torch, run_b, KREPS), "library_ms": None}
    mb["bound_ms"], mb["bound_by"] = march_bwd_bound(
        torch, planar, qs, bzb[None], G, GI, bd, sthr,
        out_bytes=planar.element_size())

    # the launch configuration and the share skipped as empty
    occ_info = train_occupancy(kernels, bd, f32)
    tcfg = occ_info["config"]
    cm = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64, device=dev)
    cb = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64, device=dev)
    slab_march._march_train_cuda(planar, qs, D=D, bd=bd, flip=flip,
                                 counts=cm, occ=occ, **m)
    slab_march._march_bwd_cuda(planar, bprm, qs, bzb, bgacc, aux, G, GI, D,
                               bd, flip, planar.dtype, counts=cb, occ=occ)
    torch.cuda.synchronize()
    for name, c, st in (("M", cm, mt), ("M-bwd pass 1", cb, mb)):
        met, shaded, pieces, staged, pshaded = (int(x) for x in c.tolist())
        st["slabs_met"], st["slabs_shaded"] = met, shaded
        st["skipped_share"] = 1.0 - shaded / max(met, 1)
        st["pieces"] = {"met": pieces, "staged": staged, "shaded": pshaded}
        log(f"kernel {name} [{tag}]: config {tcfg}, on the card "
            f"{occ_info[name]}; {met} (tile, slab) pairs met, {shaded} "
            f"shaded: {st['skipped_share']:.4f} skipped as empty; footprint "
            f"pieces {st['pieces']} (staged: a coarse block above the "
            f"threshold)")
    log(f"kernel M-bwd pass 2 [{tag}]: on the card {occ_info['M-bwd pass 2']}")
    mt["config"], mb["config"] = tcfg, tcfg
    mt["occupancy"], mb["occupancy"] = occ_info["M"], {
        k: occ_info[k] for k in ("M-bwd pass 1", "M-bwd pass 2")}
    return {"MT": mt, "MB": mb, "MO": mo, "acc4": acc4}


def timed_steps(torch, tr, cams, tgt, tag):
    """TRAIN_WARM untimed steps per pose, then TRAIN_STEPS synced and
    TRAIN_STEPS ``sync=False`` steps per pose with the launch counts reset
    just before and read just after, and the peak device memory over the
    timed steps."""
    from volrend_torch.ops import (display_warp, slab_grad, slab_march,
                                   slab_render)
    for s in range(TRAIN_WARM * len(cams)):
        tr.step_frame(cams[s % len(cams)], tgt)
    torch.cuda.synchronize()
    plain_calls = count_plain_calls()
    slab_grad.bake_from_pyramid.launches = 0
    slab_march.march_slabs.launches = 0
    slab_march.march_slabs_bwd.launches = 0
    slab_march.march_occupancy.launches = 0
    slab_march.march_occupancy.launches_live = 0
    display_warp.build_table.launches_f32 = 0
    display_warp.combine_emit.launches_f32 = 0
    display_warp.combine_adjoint.launches = 0
    display_warp.build_adjoint.launches = 0
    slab_render._warp_to_screen_ref.precise_poses = 0
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_STEPS * len(cams)
    synced = []
    for s in range(n):
        t0 = time.perf_counter()
        loss = tr.step_frame(cams[s % len(cams)], tgt)
        synced.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss):
            fail(f"{tag}: non-finite loss at step {s}")
    t0 = time.perf_counter()
    for s in range(n):
        loss_t = tr.step_frame(cams[s % len(cams)], tgt, sync=False)
    last = float(loss_t)
    pipelined = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(bake=slab_grad.bake_from_pyramid.launches,
                  march=slab_march.march_slabs.launches,
                  march_bwd=slab_march.march_slabs_bwd.launches,
                  occupancy=slab_march.march_occupancy.launches,
                  occupancy_live=slab_march.march_occupancy.launches_live,
                  build_f32=display_warp.build_table.launches_f32,
                  combine_f32=display_warp.combine_emit.launches_f32,
                  combine_adj=display_warp.combine_adjoint.launches,
                  build_adj=display_warp.build_adjoint.launches,
                  ref_warp_poses=slab_render._warp_to_screen_ref.precise_poses,
                  plain=dict(plain_calls))
    restore_plain()
    if not np.isfinite(last):
        fail(f"{tag}: non-finite loss (sync=False)")
    ms_synced = float(np.median(synced))
    log(f"{tag}: {2 * n} steps, counts {counts}; median {ms_synced:.3f} "
        f"ms/step synced (steps {synced}), {pipelined:.3f} ms/step with "
        f"sync=False; peak {peak:.3f} GiB allocated; last loss {last:.6f}")
    return {"steps": 2 * n, "counts": counts, "ms_synced": ms_synced,
            "ms_pipelined": pipelined, "peak_gib": peak}


def precise_checks(torch, dev, inter, gargs, tr, cam, perm, stats):
    """Phase 8b: the precise superquad warp at full width on pose 0's
    intermediate image ``inter`` (1, gi, gi, 4) and geometry ``gargs``.
    Holds kernel B's and C's f32 modes and kernels 5 and 6 against their
    plain versions and times them (stats "BF", "CF", "K5", "K6"; C's
    constant-size kernel also against its generic one, bit for bit, and
    kernel 5 with the zero fill of its table), then the whole precise warp
    against autograd through the reference warp, and times its backward
    alone."""
    import torch.nn.functional as F
    from volrend_torch.ops import display_warp, slab_grad, slab_render
    bg = float(tr.opt.background_brightness)
    Wn = display_warp._PRECISE_WIN
    By, Bx = display_warp._PRECISE_B
    S, C, ncell = By * Bx, 4 * Wn[0] * Wn[1], Wn[0] * Wn[1]
    H3, W3 = GI - Wn[0] + 1, GI - Wn[1] + 1
    Hh, Wh = H // By, W // Bx

    # kernel B, f32 table from the interleaved intermediate image
    def run_b():
        return display_warp.build_table(inter, Wn, dtype=torch.float32,
                                        planar=False)

    def run_b_plain():
        return display_warp.build_table_ref(inter, Wn, dtype=torch.float32,
                                            planar=False)

    tbl = run_b()
    tbl_p = run_b_plain()
    if not torch.equal(tbl, tbl_p):
        fail("kernel B's f32 table is not bit-equal to its plain version")
    # library yardstick: ONE unfold of the planar image builds the same
    # cells (in unfold's channel order; the planar copy is set-up)
    itp = inter.movedim(-1, 1).contiguous()
    unf = F.unfold(itp, Wn)
    if not torch.equal(unf[0].reshape(4, ncell, H3 * W3).permute(2, 1, 0)
                       .reshape(H3 * W3, C), tbl_p[0]):
        fail("kernel B's library yardstick builds another table")
    stats["BF"] = {"max_abs_err": 0.0, "ms": cuda_ms(torch, run_b, KREPS),
                   "plain_ms": cuda_ms(torch, run_b_plain, KREPS),
                   "library_ms": cuda_ms(torch, lambda: F.unfold(itp, Wn),
                                         KREPS)}
    stats["BF"]["bound_ms"], stats["BF"]["bound_by"] = bound(
        GI * GI * 4 * 4 + H3 * W3 * C * 4, 0)
    del unf, itp, tbl_p

    # kernel C, f32 table (qscale 1, qshift 0) and f32 frame
    gys, gxs, okm, Y0, X0 = display_warp._level_geometry(
        gargs, GI, (By, Bx), Wn)
    ry = (gys - Y0.float()[:, None]).contiguous()
    rx = (gxs - X0.float()[:, None]).contiguous()
    Y0, X0, okm = Y0.contiguous(), X0.contiguous(), okm.contiguous()
    del gys, gxs
    cargs = (tbl, Y0, X0, ry, rx, okm, GI, H, W, (By, Bx), Wn, bg)

    def run_c():
        return display_warp.combine_emit(*cargs, qscale=1.0, qshift=0.0)

    def run_c_plain():
        return display_warp.combine_emit_ref(*cargs, qscale=1.0, qshift=0.0)

    out_c = run_c()
    err = float((out_c - run_c_plain()).abs().max())
    log(f"kernel C [f32 table, pose 0]: max err {err:.3e} (tol {TOL_C_F32})")
    if not (np.isfinite(err) and err <= TOL_C_F32):
        fail("kernel C's f32 mode disagrees with its plain version")

    # the generic kernel at the precise level: the constant-size kernel's
    # frames must equal its bit for bit
    def run_c_generic():
        display_warp._COMBINE_GENERIC = True
        try:
            return display_warp.combine_emit(*cargs, qscale=1.0, qshift=0.0)
        finally:
            display_warp._COMBINE_GENERIC = False

    if not torch.equal(out_c, run_c_generic()):
        fail("kernel C's precise-level kernel differs from its generic one")
    del out_c
    rows_used = int(torch.unique(Y0.long() * W3 + X0.long()).numel())
    taps = tent_taps(torch, ry, rx, okm, Wn)
    stats["CF"] = {"max_abs_err": err, "ms": cuda_ms(torch, run_c, KREPS),
                   "plain_ms": cuda_ms(torch, run_c_plain, KREPS),
                   "generic_ms": cuda_ms(torch, run_c_generic, KREPS),
                   "library_ms": None}
    stats["CF"]["bound_ms"], stats["CF"]["bound_by"] = bound(
        rows_used * C * 4 + 2 * Hh * Wh * 4 + 3 * S * Hh * Wh * 4
        + H * W * 4 * 4, H * W * 30 + taps * 9)

    # kernel 5 on a seeded cotangent of the frame
    g = torch.as_tensor(np.random.default_rng(1).normal(
        size=(1, H, W, 4)).astype(np.float32), device=dev)

    def run_5():
        return display_warp.combine_adjoint(g, ry, rx, okm, Y0, X0, GI, bg)

    def run_5_plain():
        return display_warp.combine_adjoint_ref(g, ry, rx, okm, Y0, X0, GI,
                                                bg)

    dtbl, dtbl_p = run_5(), run_5_plain()
    rel = float((dtbl.double() - dtbl_p.double()).norm()
                / dtbl_p.double().norm())
    mx = float((dtbl - dtbl_p).abs().max())
    log(f"kernel 5 [pose 0]: relative L2 {rel:.3e}, max |diff| {mx:.3e} "
        f"(max |plain| {float(dtbl_p.abs().max()):.3e}; tol {TOL_ADJ_REL})")
    if not (np.isfinite(rel) and rel <= TOL_ADJ_REL):
        fail("kernel 5 disagrees with its plain version")
    del dtbl_p
    # timed with the zero fill of the table it adds into (the wrapper's);
    # the bound reads the cotangent, geometry and corners once and writes
    # the whole table once; logged beside it, the bound of the kernel's
    # own traffic (the rows its blocks touch) and of the fill alone
    in_bytes = H * W * 4 * 4 + 3 * S * Hh * Wh * 4 + 2 * Hh * Wh * 4
    stats["K5"] = {"max_abs_err": mx, "rel_l2": rel,
                   "ms": cuda_ms(torch, run_5, KREPS),
                   "plain_ms": cuda_ms(torch, run_5_plain, KREPS),
                   "fill_ms": cuda_ms(torch, lambda: torch.zeros(
                       (1, H3 * W3, C), dtype=torch.float32, device=dev),
                       KREPS),
                   "rows_bound_ms": bound(in_bytes + rows_used * C * 4,
                                          0)[0],
                   "fill_bound_ms": bound(H3 * W3 * C * 4, 0)[0],
                   "library_ms": None}
    stats["K5"]["bound_ms"], stats["K5"]["bound_by"] = bound(
        in_bytes + H3 * W3 * C * 4, taps * 18)

    # kernel 6 on that table cotangent
    def run_6():
        return display_warp.build_adjoint(dtbl, GI)

    def run_6_plain():
        return display_warp.build_adjoint_ref(dtbl, GI)

    d_k, d_p = run_6(), run_6_plain()
    rel = float((d_k.double() - d_p.double()).norm() / d_p.double().norm())
    mx = float((d_k - d_p).abs().max())
    log(f"kernel 6 [pose 0]: relative L2 {rel:.3e}, max |diff| {mx:.3e} "
        f"(max |plain| {float(d_p.abs().max()):.3e}; tol {TOL_ADJ_REL})")
    if not (np.isfinite(rel) and rel <= TOL_ADJ_REL):
        fail("kernel 6 disagrees with its plain version")
    # library yardstick: ONE fold of the cotangent permuted to fold's
    # channel order (the permute's copy is timed apart)
    def permute():
        return dtbl[0].reshape(H3 * W3, ncell, 4).permute(2, 1, 0).reshape(
            1, C, H3 * W3).contiguous()

    dperm = permute()
    folded = F.fold(dperm, (GI, GI), Wn)
    frel = float((folded[0].movedim(0, -1).double() - d_p[0].double()).norm()
                 / d_p.double().norm())
    if not frel <= TOL_ADJ_REL:
        fail(f"kernel 6's library yardstick computes another function "
             f"(relative L2 {frel:.3e})")
    stats["K6"] = {"max_abs_err": mx, "rel_l2": rel,
                   "ms": cuda_ms(torch, run_6, KREPS),
                   "plain_ms": cuda_ms(torch, run_6_plain, KREPS),
                   "library_ms": cuda_ms(
                       torch, lambda: F.fold(dperm, (GI, GI), Wn), KREPS)}
    stats["K6"]["bound_ms"], stats["K6"]["bound_by"] = bound(
        H3 * W3 * C * 4 + GI * GI * 4 * 4, GI * GI * ncell * 4)
    permute_ms = cuda_ms(torch, permute, KREPS)
    del d_k, d_p, dperm, folded, dtbl, g
    log(f"precise warp kernels [pose 0]: B-f32 {json.dumps(stats['BF'])}; "
        f"C-f32 {json.dumps(stats['CF'])}; 5 {json.dumps(stats['K5'])}; "
        f"6 {json.dumps(stats['K6'])}; kernel 6 yardstick's permute copy "
        f"{permute_ms:.4f} ms")

    # the whole precise warp against autograd through the reference warp
    ct = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, H, W, 4)).astype(np.float32), device=dev)
    res = []
    for fn in (lambda x: display_warp.warp_precise(x, bg, *gargs),
               lambda x: slab_render._warp_to_screen_ref(
                   x, tr.opt, *gargs, precise=True)):
        x = inter.clone().requires_grad_(True)
        out = fn(x)
        if not res:
            # the precise warp's backward alone (kernel 5 with its table's
            # fill, then kernel 6)
            backward_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                out, x, ct, retain_graph=True), KREPS)
        (gx,) = torch.autograd.grad(out, x, ct)
        res.append((out.detach(), gx))
    (out, gx), (ref, gref) = res
    out_err = float((out - ref).abs().max())
    gtol = (TOL_PRECISE_GRAD_ATOL * float(gref.abs().max())
            + TOL_PRECISE_GRAD_RTOL * gref.abs())
    grad_off = int(((gx - gref).abs() > gtol).sum())
    grad_err = float((gx - gref).abs().max())
    log(f"precise warp vs reference warp [pose 0, {W}x{H}, gi={GI}]: "
        f"output max |diff| {out_err:.3e} (atol {TOL_PRECISE_OUT}); "
        f"gradient max |diff| {grad_err:.3e}, {grad_off} of {gx.numel()} "
        f"entries past atol {TOL_PRECISE_GRAD_ATOL} x max|g| "
        f"({float(gref.abs().max()):.3e}) + rtol {TOL_PRECISE_GRAD_RTOL}; "
        f"its backward alone {backward_ms:.4f} ms")
    if not (out_err <= TOL_PRECISE_OUT and grad_off == 0):
        fail("the precise warp disagrees with the reference warp")
    del res, out, gx, ref, gref, ct

    # the routing's fit predicate, computed on the host from the camera:
    # a pose's first visit, then its cached later ones
    ts, tc = [], []
    for _ in range(5):
        slab_grad._fits_from_camera.cache_clear()
        for t in (ts, tc):
            t0 = time.perf_counter()
            fits = slab_grad._precise_fits_host(tr.grid, cam.transform,
                                                cam.fx, cam.fy, perm, W, H,
                                                GI)
            t.append((time.perf_counter() - t0) * 1e3)
    host_ms, cached_ms = float(np.median(ts)), float(np.median(tc))
    log(f"precise warp fit predicate on the host: {bool(fits[0])}; median "
        f"{host_ms:.3f} ms a pose's first visit, {cached_ms:.4f} ms cached "
        f"(host clock, {ts}, {tc})")
    if not bool(fits[0]):
        fail("pose 0 misfits the precise warp's window")
    return {"precise_out_err": out_err, "precise_grad_err": grad_err,
            "precise_fits_host_ms": host_ms,
            "precise_fits_cached_ms": cached_ms,
            "precise_backward_ms": backward_ms,
            "fold_permute_ms": permute_ms}


def probe_phase(torch, dev, grid, opt, stats):
    """Phase 6: the measurement probes (volrend_torch/probes/) on the dense
    grid at their own width (800^2, gi=448, the 96 orbit poses). P7, P8 and
    P9 in both layouts against their plain versions on the same CUDA
    tensors, with times, bounds and library yardsticks (stats "P7", "P8",
    "P9", "P9P"); then the probes' own numbers, each once, with the probe
    kernels' launch counts reset just before and read just after: the
    stream's GB/s, kernel M's one-pose display time beside it (host-synced
    and, apart, on the card and the host's issue), perf_sq3's
    s1 and s2, and perf_sq4's b0, b3 and b4 (b3 drives the interleaved
    build). Returns the numbers and the counts."""
    import torch.nn.functional as F
    from volrend_torch.ops import slab_march, slab_render
    from volrend_torch.probes import _common, perf_overlap, perf_sq3, \
        perf_sq4
    gi = _common.GI
    cams = _common.orbit_poses(_common.N_ORBIT)
    groups = _common.pose_groups(grid, cams)
    (perm, flip), idx = next((k, v) for k, v in groups.items() if 0 in v)
    (perm4, flip4), idx4 = max(groups.items(), key=lambda kv: len(kv[1]))
    fx, fy = cams[0].fx, cams[0].fy
    trs = _common.transforms(cams, idx, dev)

    # ---- P8: the payload stream, every window of pose 0's payload --------
    pay = slab_render._permuted_grid(grid, perm)
    n_win = grid.G // perf_overlap.WIN
    ids = torch.arange(n_win, dtype=torch.int32, device=dev)
    out_k, sums_k = perf_overlap.stream_probe(pay, ids)
    out_p, sums_p = perf_overlap.stream_probe_ref(pay, ids)
    if not (torch.equal(out_k, out_p) and torch.equal(sums_k, sums_p)):
        fail("P8 (probe_stream) is not exact against its plain version")

    def library_stream():
        return pay.view(n_win, -1).sum(1, dtype=torch.int64)

    if not torch.equal(library_stream(), sums_p):
        fail("P8's library yardstick computes another function")
    del out_k, out_p, sums_k, sums_p
    nbytes = perf_overlap.stream_bytes(pay, n_win)
    stats["P8"] = {"max_abs_err": 0.0, "ms": cuda_ms(
        torch, lambda: perf_overlap.stream_probe(pay, ids), KREPS),
        "plain_ms": cuda_ms(
            torch, lambda: perf_overlap.stream_probe_ref(pay, ids), KREPS),
        "library_ms": cuda_ms(torch, library_stream, KREPS)}
    # one integer add per byte, counted at the fp32 rate
    stats["P8"]["bound_ms"], stats["P8"]["bound_by"] = bound(nbytes, nbytes)
    log(f"P8 [payload {tuple(pay.shape)}, {n_win} windows, {nbytes} B]: "
        f"exact; {json.dumps(stats['P8'])}")

    # ---- P7: the planar tent-combine on pose 0 ---------------------------
    inter = torch.as_tensor(np.random.RandomState(0).rand(gi, gi, 4).astype(
        np.float32), device=dev)
    g = slab_render.FrameGeom(grid, trs[:1], fx, fy, perm, flip, W, H, opt,
                              gi)
    cin = perf_sq3.superquad_inputs(inter, perf_sq3.pose_geom(g), perm, W,
                                    H, gi)
    bgv = float(opt.background_brightness)
    err = float((perf_sq3.combine_probe(*cin, bgv)
                 - perf_sq3.combine_probe_ref(*cin, bgv)).abs().max())
    log(f"P7 (probe_combine) [pose 0, {W}x{H}, gi={gi}]: max err "
        f"{err:.3e} (tol {TOL_C_F32})")
    if not (np.isfinite(err) and err <= TOL_C_F32):
        fail("P7 (probe_combine) disagrees with its plain version")
    Hh, Wh = H // 2, W // 2
    stats["P7"] = {"max_abs_err": err, "ms": cuda_ms(
        torch, lambda: perf_sq3.combine_probe(*cin, bgv), KREPS),
        "plain_ms": cuda_ms(
            torch, lambda: perf_sq3.combine_probe_ref(*cin, bgv), KREPS),
        "library_ms": None}
    # 64 bf16 table planes and 3 f32 geometry planes per subpixel read, 16
    # f32 planes written; per half-pixel and subpixel 8 tents (3 ops), 16
    # weight products, 64 multiply-adds and the composite (~8)
    stats["P7"]["bound_ms"], stats["P7"]["bound_by"] = bound(
        Hh * Wh * (64 * 2 + 3 * 4 * 4 + 16 * 4),
        Hh * Wh * 4 * (8 * 3 + 16 + 64 * 2 + 8))
    del cin

    # ---- P9: the window-table build, both layouts ------------------------
    a = torch.as_tensor(np.random.default_rng(0).uniform(
        0.1, 0.9, (4, gi, gi)).astype(np.float32), device=dev)
    itp = perf_sq4.finalize(a, opt).permute(2, 0, 1).to(
        torch.bfloat16).contiguous()
    n, Hp = perf_sq4.table_rows(gi)
    for key, planar in (("P9", False), ("P9P", True)):
        if not torch.equal(perf_sq4.build_probe(itp, gi, planar=planar),
                           perf_sq4.build_probe_ref(itp, gi,
                                                    planar=planar)):
            fail(f"{key} (probe_build, planar={planar}) is not bit-equal to "
                 "its plain version")
        stats[key] = {"max_abs_err": 0.0, "ms": cuda_ms(
            torch, lambda p=planar: perf_sq4.build_probe(itp, gi, planar=p),
            KREPS), "plain_ms": cuda_ms(
            torch, lambda p=planar: perf_sq4.build_probe_ref(
                itp, gi, planar=p), KREPS)}
        stats[key]["bound_ms"], stats[key]["bound_by"] = bound(
            4 * gi * gi * 2 + Hp * n * 64 * 2, 0)
    # library yardstick: ONE unfold of the planar image builds the same
    # cells (in unfold's channel order c*16 + cy*4 + cx)
    ilv = perf_sq4.build_probe_ref(itp, gi)
    unf = F.unfold(itp[None], 4)
    if not torch.equal(unf[0].reshape(4, 16, n, n).permute(2, 3, 1, 0)
                       .reshape(n, n, 64), ilv[:n]):
        fail("P9's library yardstick builds another table")
    lib_ms = cuda_ms(torch, lambda: F.unfold(itp[None], 4), KREPS)
    stats["P9"]["library_ms"] = stats["P9P"]["library_ms"] = lib_ms
    del unf, ilv
    log(f"P7 {json.dumps(stats['P7'])}; P9 [table ({Hp}, {n}, 64)] "
        f"{json.dumps(stats['P9'])}; P9 planar {json.dumps(stats['P9P'])}")
    torch.cuda.empty_cache()

    # ---- the probes' own numbers, counted -------------------------------
    perf_sq3.combine_probe.launches = 0
    perf_overlap.stream_probe.launches = 0
    perf_sq4.build_probe.launches = 0
    perf_sq4.build_probe.launches_planar = 0
    P = len(idx)
    t = _common.sync_time(lambda: [perf_overlap.stream_probe(pay, ids)
                                   for _ in range(P)])
    stream_ms = t / P * 1e3
    gbs = nbytes / stream_ms / 1e6
    gm = slab_render.FrameGeom(grid, trs, fx, fy, perm, flip, W, H, opt, gi)
    params, zb = slab_render._march_frame_fields(grid, gm, perm, flip, opt)
    slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)

    def march_each():
        return [perf_overlap.march_one_pose(
            grid, pay, params[i:i + 1], zb[i:i + 1], perm, flip, gi,
            slab_ids, slab_march._K_STEP) for i in range(P)]

    m_ms = _common.sync_time(march_each) / P * 1e3
    m_dev_ms, m_host_ms = march_apart(torch, march_each, P)
    log(f"perf_overlap: payload stream {stream_ms:.4f} ms per launch, "
        f"{gbs:.1f} GB/s ({gbs / (HBM_BYTES_PER_S / 1e9):.4f} of the data "
        f"sheet's 3.35 TB/s); kernel M, one pose per launch at gi={gi} "
        f"(K={slab_march._K_STEP}): {m_ms:.3f} ms, {m_ms / stream_ms:.2f}x "
        f"the stream ({P} poses of group {perm}/{flip}); apart, "
        f"{m_dev_ms:.3f} ms on the card and {m_host_ms:.3f} ms of the "
        f"host's issue a launch")
    if not gbs * 1e9 < HBM_BYTES_PER_S:
        fail(f"the stream probe reads {gbs:.1f} GB/s, above the card's "
             f"3.35 TB/s: its loads cannot all have run")
    del params, zb, gm
    s1 = perf_sq3.s1(grid, trs[0], fx, fy, perm, flip, inter, opt, W, H, gi)
    sq_ms, prod_ms = perf_sq3.s2(grid, trs[:perf_sq4.N_POSES], fx, fy, perm,
                                 flip, inter, opt, W, H, gi)
    log(f"perf_sq3: s1 max |probe - production| {s1:.5f}; s2 probe warp "
        f"{sq_ms:.3f} ms/frame (one pose per call), production warp "
        f"{prod_ms:.3f} ms/frame (one batched call), over "
        f"{min(P, perf_sq4.N_POSES)} poses")
    if not (np.isfinite(s1) and s1 < 1e-2):
        fail(f"perf_sq3: the probe warp is {s1} from the production warp")
    del inter, pay
    torch.cuda.empty_cache()
    st = perf_sq4.Setup(grid.scale, perm4, float(fx), float(fy), W, H, gi,
                        opt)
    trs4 = _common.transforms(cams, idx4[:perf_sq4.N_POSES], dev)
    accs = torch.as_tensor(np.random.default_rng(0).uniform(
        0.1, 0.9, (trs4.shape[0], 4, gi, gi)).astype(np.float32),
        device=dev)
    sq4 = perf_sq4.run_variants(st, grid, trs4, accs, flip4,
                                ["b0 ref quad", "b3 probe ilv",
                                 "b4 probe+T"])
    counts = dict(combine=perf_sq3.combine_probe.launches,
                  stream=perf_overlap.stream_probe.launches,
                  build=perf_sq4.build_probe.launches,
                  build_planar=perf_sq4.build_probe.launches_planar)
    log(f"perf_sq4 [{trs4.shape[0]} poses of group {perm4}/{flip4}]: "
        + "; ".join(f"{k} {ms:.3f} ms/frame (table build alone {tb}), "
                    f"max |. - b0| {e:.4f}" for k, (ms, e, tb) in sq4.items())
        + f"; probe launch counts {counts}")
    if min(counts.values()) < 1:
        fail(f"a probe kernel never launched on the probes' path ({counts})")
    if not sq4["b4 probe+T"][1] < 1e-2:
        fail("perf_sq4: b4 disagrees with the reference warp b0")
    del accs
    torch.cuda.empty_cache()
    return {"probe_stream_ms": stream_ms, "probe_stream_gbs": gbs,
            "probe_march_one_pose_ms": m_ms,
            "probe_march_one_pose_device_ms": m_dev_ms,
            "probe_march_one_pose_host_ms": m_host_ms, "probe_sq3_s1": s1,
            "probe_sq3_ms": sq_ms, "probe_production_warp_ms": prod_ms,
            "probe_sq4": {k: list(v) for k, v in sq4.items()},
            "probe_counts": counts}


def march_apart(torch, fn, n: int):
    """(device ms, host ms) a launch of ``fn()``'s ``n`` launches: the host
    issues them all behind a long device sleep, so the card's reading holds
    no host gap, and the host's issue time is read on its clock; the least
    of three runs each. Fails when the issue outlasts the sleep."""
    dev, host = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(8 * SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3 / n)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b) / n)
    if min(host) * n > 60.0:
        fail(f"issuing {n} launches took {min(host) * n:.1f} ms, longer "
             f"than the device sleep ahead of them")
    return min(dev), min(host)


def warp_stage_turns(torch, tag, inter, geom, levels, P, B_, Wn, bg):
    """Device time of the display warp stage on one launch's intermediate
    (P, 4, gi, gi) at the level (B_, Wn), in turns (parent, change,
    change, parent): the parent's (the fit predicates' PyTorch passes, its
    geometry, index copies, kernels B and C and the frames' index-put)
    against the change's (the parameter rows, the fit mode and its
    non-blocking copy to the host, kernel W), without the host's reads
    (each CUDA events around KREPS back-to-back stages). Fails if the
    change's stage is not faster."""
    from volrend_torch.ops import display_warp as dw
    from volrend_torch.probes._common import mean_fits, table_warp_level
    dev = inter.device
    _, _, _, w, h, gi = geom[:6]
    sel = torch.arange(P, device=dev)
    sel32 = sel.to(torch.int32)

    def parent():
        mean_fits(geom, levels)
        out = torch.empty((P, h, w, 4), dtype=torch.uint8, device=dev)
        out[sel] = table_warp_level(geom, inter, sel, B_, Wn, bg,
                                    torch.uint8)
        return out

    def change():
        plan = dw.plan_fits(*geom)
        out = torch.empty((P, h, w, 4), dtype=torch.uint8, device=dev)
        return dw.warp_display(inter, plan.prm, sel32, out, B_, Wn, gi, bg)

    ms = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        ms[name].append(cuda_ms(torch, parent if name == "parent"
                                else change, KREPS))
    log(f"warp stage [{tag}, {P} poses]: parent (fit predicates, geometry, "
        f"B, C, copies) {ms['parent']} ms, change (fit mode, W) "
        f"{ms['change']} ms (device time)")
    if not max(ms["change"]) < min(ms["parent"]):
        fail(f"warp stage [{tag}]: the change's stage is not faster than "
             f"the parent's ({ms})")
    return ms


def parent_warp_to_screen_sq(torch, choices, inter, opt, R, fx, fy,
                             width, height, gi, perm, u0, du, v0, dv,
                             scale, block=None, out_dtype=None,
                             planar=False, plan=None):
    """The parent commit's display warp (display_warp.warp_to_screen_sq
    before kernel W): the fit predicates in PyTorch read on the host, then
    per level the PyTorch geometry, kernel B's int8 table, kernel C and an
    index-put of the frames; the misfit poses through the reference warp.
    ``plan`` is not read; each batch's per-pose level goes to
    ``choices``."""
    from volrend_torch.ops import display_warp as dw
    from volrend_torch.ops import slab_render
    from volrend_torch.probes._common import mean_fits, table_warp_level
    dev = inter.device
    P = inter.shape[0]
    itp = inter if planar else inter.movedim(-1, 1)
    itp = itp.to(torch.float32).contiguous()
    fx = torch.as_tensor(fx, dtype=torch.float32, device=dev)
    fy = torch.as_tensor(fy, dtype=torch.float32, device=dev)
    geom_args = (R, fx, fy, width, height, gi, perm, u0, du, v0, dv, scale)
    levels = dw._usable_levels(width, height, gi, block)
    choice = np.full(P, -1)
    if levels:
        fits = mean_fits(geom_args, levels).cpu().numpy()
        for p in range(P):
            hit = np.nonzero(fits[:, p])[0]
            if hit.size:
                choice[p] = int(hit[0])
    choices.append(choice)
    u8 = out_dtype == torch.uint8
    out = torch.empty((P, height, width, 4),
                      dtype=torch.uint8 if u8 else torch.float32, device=dev)
    for li, (B, Wl) in enumerate(levels):
        idx = np.nonzero(choice == li)[0]
        if idx.size == 0:
            continue
        sel = torch.as_tensor(idx, device=dev)
        out[sel] = table_warp_level(geom_args, itp, sel, B, Wl,
                                    float(opt.background_brightness),
                                    out_dtype)
    idx = np.nonzero(choice < 0)[0]
    if idx.size:
        sel = torch.as_tensor(idx, device=dev)
        ref = slab_render._warp_to_screen_ref(
            itp.index_select(0, sel).movedim(1, -1), opt,
            R.index_select(0, sel), fx, fy, width, height, gi, perm,
            u0.index_select(0, sel), du.index_select(0, sel),
            v0.index_select(0, sel), dv.index_select(0, sel), scale)
        out[sel] = dw.to_display_dtype(ref, out_dtype)
    return out


def timed_once(torch, fn):
    """(fn(), its device time in ms): one call between CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


_PLAIN = (("slab_march", "march_slabs_ref"),
          ("slab_march", "march_slabs_bwd_ref"),
          ("slab_march", "march_occupancy_ref"),
          ("slab_march", "march_occupancy_live_ref"),
          ("slab_grad", "bake_from_pyramid_ref"),
          ("slab_grad", "live_bits_ref"),
          ("display_warp", "warp_display_ref"),
          ("display_warp", "level_fit_counts_ref"),
          ("display_warp", "build_table_ref"),
          ("display_warp", "combine_emit_ref"),
          ("display_warp", "combine_adjoint_ref"),
          ("display_warp", "build_adjoint_ref"))


def count_plain_calls():
    """Wrap the kernels' plain versions with call counters (the training
    path must not reach them on the card); returns the live counts."""
    import importlib
    calls = {name: 0 for _, name in _PLAIN}
    for mod, name in _PLAIN:
        m = importlib.import_module(f"volrend_torch.ops.{mod}")
        fn = getattr(m, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        counted.original = fn
        setattr(m, name, counted)
    return calls


def restore_plain():
    import importlib
    for mod, name in _PLAIN:
        m = importlib.import_module(f"volrend_torch.ops.{mod}")
        setattr(m, name, getattr(m, name).original)


def recovery_gate(torch, dev, topt):
    """examples/train_slab_demo.py on the card: the G=128 solid scene, clean
    targets rendered by render_frame_train, the leaf rows corrupted (colour
    coefficients x 0.15, sigma x U(0.6, 1.4), seed 0), DEMO_STEPS steps over
    the poses; PSNR of pose 0 against its target must rise by more than
    DEMO_GAIN_DB."""
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import slab_grad
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes import _common

    t = time.perf_counter()
    tree = _common.load_tree(CACHE_DEMO, lambda: make_solid_tree(
        max_depth=DEMO_DEPTH, basis_dim=9, seed=7))
    tdev = tree.to_device(lut_depth=None, device=dev)
    tr = train.FrameTrainer(tdev, opt=topt, lr=TRAIN_LR, gi=DEMO_GI)
    cams = train_orbit(Camera)
    groups = [tr._group(c) for c in cams]

    def render(i):
        with torch.no_grad():
            perm, flip = groups[i]
            c = cams[i]
            return slab_grad.render_frame_train(
                tr.pyramid, tr.bmap, tr.grid, c.transform, c.fx, c.fy, perm,
                flip, W, H, tr.opt, gi=DEMO_GI)

    def psnr_dev(a, b):
        mse = float(torch.mean((a[..., :3] - b[..., :3]) ** 2))
        return 99.0 if mse < 1e-12 else -10.0 * float(np.log10(mse))

    targets = [render(i) for i in range(len(cams))]
    rng = np.random.default_rng(0)
    data = tr.data
    D = tr.grid.data_dim
    data[:, :D - 1] *= 0.15
    data[:, D - 1] *= torch.as_tensor(
        rng.uniform(0.6, 1.4, data.shape[0]).astype(np.float32), device=dev)
    tr.data = data
    tr.opt_state = tr.optimizer.init(tr.pyramid)
    p_before = psnr_dev(render(0), targets[0])
    losses = []
    t0 = time.perf_counter()
    for s in range(DEMO_STEPS):
        losses.append(tr.step_frame(cams[s % len(cams)],
                                    targets[s % len(cams)]))
    steps_s = time.perf_counter() - t0
    p_after = psnr_dev(render(0), targets[0])
    log(f"recovery (G={tr.grid.G}, gi={DEMO_GI}, {DEMO_STEPS} steps in "
        f"{steps_s:.2f} s, set-up {t0 - t:.1f} s): PSNR {p_before:.3f} -> "
        f"{p_after:.3f} dB; loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    if not (np.all(np.isfinite(losses)) and p_after > p_before + DEMO_GAIN_DB):
        fail(f"recovery: PSNR {p_before:.3f} -> {p_after:.3f} dB, not up by "
             f"more than {DEMO_GAIN_DB} dB")
    return {"recovery_psnr_before_db": p_before,
            "recovery_psnr_after_db": p_after,
            "recovery_loss_first": losses[0],
            "recovery_loss_last": losses[-1]}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, HERE)
    from volrend_torch import kernels
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import (dense_grid, display_warp, render_exact,
                                   slab_march, slab_render)
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes import _common
    from volrend_torch.utils.options import RenderOptions

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    # ---- 1. build -----------------------------------------------------------
    t = time.perf_counter()
    blogs = kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t:.1f} s "
        f"({sorted(blogs)} compiled this run)")
    for name, text in blogs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    opt = RenderOptions(max_steps=1024)
    dev = torch.device("cuda")

    def setup(get_tree, tag):
        t = time.perf_counter()
        tree = get_tree()
        log(f"{tag}: tree ready in {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        tdev = tree.to_device(lut_depth=None, device=dev)
        grid = dense_grid.bake_dense(tdev, dtype="int8")
        torch.cuda.synchronize()
        log(f"{tag}: uploaded + int8 bake G={grid.G} in "
            f"{time.perf_counter() - t:.1f} s")
        return tdev, grid

    def groups_of(grid, cams):
        groups = {}
        for i, c in enumerate(cams):
            perm, flip, slope = slab_render.choose_axis(
                grid, c.transform, c.fx, c.fy, W, H)
            if not (np.isfinite(slope) and slope < slab_render.MAX_SLAB_SLOPE):
                fail(f"orbit pose {i} not slab-renderable (slope {slope})")
            groups.setdefault((perm, flip), []).append(i)
        pays = {}
        for perm, _ in groups:
            if perm not in pays:
                pays[perm] = slab_render.prepare_payload(grid, perm, opt)
        trs = {k: torch.as_tensor(np.stack([cams[i].transform for i in v]),
                                  dtype=torch.float32, device=dev)
               for k, v in groups.items()}
        return groups, pays, trs

    def render_all(grid, cams, groups, pays, trs):
        fx, fy = cams[0].fx, cams[0].fy
        out = torch.empty((len(cams), H, W, 4), dtype=torch.uint8,
                          device=dev)
        for (perm, flip), idx in groups.items():
            out[idx] = slab_render.render_frames(
                grid, trs[(perm, flip)], fx, fy, perm, flip, W, H, opt,
                gi=GI, payload=pays[perm], out_dtype=torch.uint8)
        return out

    def reset_counts():
        slab_march.march_slabs.launches = 0
        slab_march.march_slabs.poses = 0
        display_warp.build_table.launches = 0
        display_warp.combine_emit.launches = 0
        display_warp.combine_emit.poses = 0
        display_warp.warp_display.launches = 0
        display_warp.warp_display.poses = 0
        display_warp.level_fit_counts.launches = 0
        slab_render._warp_to_screen_ref.poses = 0

    def read_counts():
        return dict(
            march=slab_march.march_slabs.launches,
            march_poses=slab_march.march_slabs.poses,
            warp=display_warp.warp_display.launches,
            warp_poses=display_warp.warp_display.poses,
            fit=display_warp.level_fit_counts.launches,
            build=display_warp.build_table.launches,
            combine=display_warp.combine_emit.launches,
            combine_poses=display_warp.combine_emit.poses,
            ref_warp_poses=slab_render._warp_to_screen_ref.poses)

    def main_path(tag, grid, cams, groups, pays, trs):
        """One counted run, then REPS timed runs; returns (counts, frames,
        median ms, peak GiB of device memory over the timed runs)."""
        reset_counts()
        frames = render_all(grid, cams, groups, pays, trs)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"{tag}: counts {counts}")
        n = len(cams)
        if counts["ref_warp_poses"] != 0:
            fail(f"{tag}: {counts['ref_warp_poses']} poses fell back to "
                 "the reference warp")
        if counts["march_poses"] != n or counts["warp_poses"] != n:
            fail(f"{tag}: not every pose went through kernels M and W "
                 f"({counts})")
        if min(counts["march"], counts["warp"], counts["fit"]) < 1:
            fail(f"{tag}: a kernel of the path never launched ({counts})")
        if counts["build"] or counts["combine"]:
            fail(f"{tag}: kernels B or C ran on the display path ({counts})")
        if tuple(frames.shape) != (n, H, W, 4):
            fail(f"{tag}: frames of shape {tuple(frames.shape)}")
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            render_all(grid, cams, groups, pays, trs)
            b.record()
            b.synchronize()
            ts.append((a.elapsed_time(b), time.perf_counter() - t0))
        ms = float(np.median([x[0] for x in ts]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{tag}: {n} poses, median {ms:.1f} ms "
            f"({n * W * H / ms / 1e3:.1f} Mrays/s); reps (ms, host s) {ts}; "
            f"peak {peak:.3f} GiB allocated")
        return counts, frames, ms, peak

    @contextlib.contextmanager
    def parent_warp(choices):
        """The main path with the parent's display warp
        (parent_warp_to_screen_sq) in place of kernel W; each batch's
        per-pose levels go to ``choices``."""
        real = display_warp.warp_to_screen_sq

        def parent(*a, **kw):
            return parent_warp_to_screen_sq(torch, choices, *a, **kw)

        display_warp.warp_to_screen_sq = parent
        try:
            yield
        finally:
            display_warp.warp_to_screen_sq = real

    def against_parent(tag, grid, cams, groups, pays, trs, frames):
        """The main path's frames against the parent's composition of the
        same path on the card, and the fit decisions against the parent's:
        within one quantum, the differing pixels counted."""
        choices, plans = [], []
        real_plan = display_warp.plan_fits

        def plan_fits(*a, **kw):
            plans.append(real_plan(*a, **kw))
            return plans[-1]

        display_warp.plan_fits = plan_fits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            render_all(grid, cams, groups, pays, trs)
        finally:
            display_warp.plan_fits = real_plan
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        with parent_warp(choices):
            old = render_all(grid, cams, groups, pays, trs)
        torch.cuda.synchronize()
        peak_old = torch.cuda.max_memory_allocated() / 2**30
        same = all(np.array_equal(p.choice(), c)
                   for p, c in zip(plans, choices))
        diff = (frames.int() - old.int()).abs()
        err = int(diff.max())
        n_pix = int((diff > 0).any(-1).sum())
        n_val = int((diff > 0).sum())
        log(f"{tag}: frames against the parent's composition (geometry + "
            f"B + C): max {err} quanta, {n_pix} of {diff[..., 0].numel()} "
            f"pixels ({n_val} values) differ; fit decisions "
            f"{'identical' if same else 'DIFFERENT'} for all "
            f"{len(cams)} poses ({len(plans)} batches); peak "
            f"{peak:.3f} GiB allocated, the parent's warp {peak_old:.3f}")
        if not (same and len(plans) == len(choices) == len(groups)):
            fail(f"{tag}: the fit decisions differ from the parent's")
        if err > TOL_C_U8:
            fail(f"{tag}: frames more than {TOL_C_U8} quantum from the "
                 "parent's")
        return {"max_quanta": err, "pixels_differ": n_pix,
                "values_differ": n_val, "peak_gib": peak,
                "parent_peak_gib": peak_old}

    def gate(tag, tdev, cam, frame, stride, floor):
        ys = np.arange(0, H, stride)
        xs = np.arange(0, W, stride)
        origins, dirs = cam.pixel_rays(xp=np)
        sel = (ys[:, None] * W + xs[None, :]).reshape(-1)
        t = time.perf_counter()
        exact = render_exact.render_rays(
            tdev, torch.as_tensor(np.ascontiguousarray(origins[sel])),
            torch.as_tensor(np.ascontiguousarray(dirs[sel])),
            opt).cpu().numpy()
        got = frame.reshape(-1, 4)[torch.as_tensor(sel, device=dev)]
        got = got.cpu().numpy().astype(np.float64)
        got /= 255.0
        if not np.all(np.isfinite(exact)):
            fail(f"{tag}: non-finite exact rays")
        p = psnr(got[:, :3], exact[:, :3])
        log(f"{tag}: PSNR {p:.3f} dB vs exact rays at stride {stride} "
            f"(floor {floor}; exact rays in {time.perf_counter() - t:.1f} s)")
        if not p >= floor:
            fail(f"{tag}: PSNR {p:.3f} dB < {floor}")
        return p

    # ---- 2. dense scene -----------------------------------------------------
    tdev, grid = setup(_common.get_tree, "dense")
    cams = _common.orbit_poses(N_POSES)
    groups, pays, trs = groups_of(grid, cams)
    log(f"dense: {len(groups)} pose groups "
        f"{[(k, len(v)) for k, v in groups.items()]}")

    # ---- 3. kernel checks on real inputs ------------------------------------
    bgv = float(opt.background_brightness)
    B_, Wn = (4, 4), (5, 5)          # the cascade level all orbit poses take
    H3, W3 = GI - Wn[0] + 1, GI - Wn[1] + 1
    C = 4 * Wn[0] * Wn[1]
    stats = {k: {"max_abs_err": 0.0} for k in ("M", "B", "C", "W", "WF")}

    def check_kernels(tag, grid, pays, sel_cams, time_it):
        """Each kernel against its plain version on one pose batch of the
        main path's shapes (``grid`` and its per-perm payloads ``pays``);
        with ``time_it``, their times and bounds."""
        D, bd, G = grid.data_dim, grid.basis_dim, grid.G
        c0 = sel_cams[0]
        perm, flip, _ = slab_render.choose_axis(
            grid, c0.transform, c0.fx, c0.fy, W, H)
        P = len(sel_cams)
        crop = slab_render.inplane_crop(grid, perm, float(opt.sigma_thresh))
        pay = pays[perm] if perm in pays else slab_render.prepare_payload(
            grid, perm, opt)
        tr = torch.as_tensor(np.stack([c.transform for c in sel_cams]),
                             device=dev)
        g = slab_render.FrameGeom(grid, tr, c0.fx, c0.fy, perm, flip, W, H,
                                  opt, GI)
        params, zb = slab_render._march_frame_fields(grid, g, perm, flip,
                                                     opt)
        slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)
        m = slab_march.march_inputs(pay, params, zb, G, GI, slab_ids,
                                    slab_march._K_STEP, crop)
        sthr = float(m["params"][0, 14])

        def run_m(prm=params, z=zb):
            return slab_march.march_slabs(
                pay, prm, grid.qscale, z, G, GI, D, bd, perm,
                slab_ids=slab_ids, sig2=True, flip=flip, bbox_full=True,
                dir_win=True, k_per_step=slab_march._K_STEP, crop=crop)

        # the plain version marches pose after pose (~0.35 s a pose at full
        # width): it is held to the kernel's whole-batch output on up to
        # PLAIN_POSES poses spread over the batch
        sub = np.unique(np.linspace(0, P - 1, min(P, PLAIN_POSES)).round()
                        ).astype(np.int64).tolist()
        m_sub = dict(m, params=m["params"][sub], zb=m["zb"][sub])
        acc_k = run_m()
        torch.cuda.synchronize()
        acc_p, m_plain_ms = timed_once(
            torch, lambda: slab_march.march_slabs_ref(
                pay, grid.qscale, D=D, bd=bd, flip=flip, **m_sub))
        err, _, _ = freeze_flip_check(
            torch, f"{tag}, {P} poses (plain version on poses {sub}), crop "
            f"{crop}, {len(slab_ids)} slabs", acc_k[sub], acc_p,
            float(opt.stop_thresh))
        stats["M"]["max_abs_err"] = max(stats["M"]["max_abs_err"], err)
        cfg = dict(slab_march.march_slabs.display)
        occ = display_occupancy(kernels, bd, cfg)
        log(f"kernel M [{tag}]: display launch {cfg}, on the card {occ}")
        del acc_p

        inter = slab_render._finalize_planar(acc_k, opt).contiguous()
        tbl_k = display_warp.build_table(inter, Wn)
        tbl_p = display_warp.build_table_ref(inter, Wn)
        if not torch.equal(tbl_k, tbl_p):
            fail(f"kernel B is not bit-equal to its plain version at {tag}")
        log(f"kernel B [{tag}]: table {tuple(tbl_k.shape)} bit-equal")

        geom = (g.R, g.fx, g.fy, W, H, GI, perm, g.u0, g.du, g.v0, g.dv,
                g.scale)
        gys, gxs, okm, Y0, X0 = display_warp._level_geometry(geom, GI, B_,
                                                             Wn)
        ry = (gys - Y0.float()[:, None]).contiguous()
        rx = (gxs - X0.float()[:, None]).contiguous()
        Y0, X0, okm = Y0.contiguous(), X0.contiguous(), okm.contiguous()
        del gys, gxs
        cargs = (tbl_k, Y0, X0, ry, rx, okm, GI, H, W, B_, Wn, bgv)
        for od, tol in ((torch.uint8, TOL_C_U8), (None, TOL_C_F32)):
            out_k = display_warp.combine_emit(*cargs, out_dtype=od)
            out_p = display_warp.combine_emit_ref(*cargs, out_dtype=od)
            torch.cuda.synchronize()
            err = float((out_k.float() - out_p.float()).abs().max())
            log(f"kernel C [{tag}] {od}: max err {err:.3e} (tol {tol})")
            if not (np.isfinite(err) and err <= tol):
                fail(f"kernel C disagrees with its plain version at {tag}")
            if od is None:
                stats["C"]["max_abs_err"] = max(stats["C"]["max_abs_err"],
                                                err)
            del out_k, out_p
        # kernel W and its fit mode on the same intermediate: the fit
        # counts bit-equal to their plain version and deciding as the
        # parent's predicates; W (at the level C ran at) against its plain
        # version and against the parent's composition, kernel C's output
        levels = display_warp._usable_levels(W, H, GI)
        prm = display_warp.display_params(g.R, g.fx, g.fy, g.u0, g.du, g.v0,
                                          g.dv, g.scale, perm)
        cnt = display_warp.level_fit_counts(prm, levels, GI, H, W)
        if not torch.equal(cnt, display_warp.level_fit_counts_ref(
                prm, levels, GI, H, W)):
            fail(f"kernel W's fit counts differ from its plain version at "
                 f"{tag}")
        old_fits = _common.mean_fits(geom, levels).cpu().numpy()
        new_fits = display_warp._fits_from_counts(cnt.cpu(), levels, H,
                                                  W).numpy()
        if not np.array_equal(old_fits, new_fits):
            fail(f"the fit decisions differ from the parent's at {tag}")
        sel = torch.arange(P, dtype=torch.int32, device=dev)

        def run_w(od=torch.uint8):
            out = torch.empty((P, H, W, 4), dtype=od, device=dev)
            return display_warp.warp_display(inter, prm, sel, out, B_, Wn,
                                             GI, bgv)

        def run_w_plain(od=torch.uint8):
            out = torch.empty((P, H, W, 4), dtype=od, device=dev)
            return display_warp.warp_display_ref(inter, prm, sel, out, B_,
                                                 Wn, GI, bgv)

        for od, tol in ((torch.uint8, TOL_C_U8), (torch.float32, TOL_C_F32)):
            out_w, out_p = run_w(od), run_w_plain(od)
            out_c = display_warp.combine_emit(
                *cargs, out_dtype=od if od == torch.uint8 else None)
            torch.cuda.synchronize()
            err = float((out_w.float() - out_p.float()).abs().max())
            n_p = int((out_w != out_p).any(-1).sum())
            err_c = float((out_w.float() - out_c.float()).abs().max())
            n_c = int((out_w != out_c).any(-1).sum())
            log(f"kernel W [{tag}] {od}: max err {err:.3e} against its plain "
                f"version (tol {tol}; {n_p} of {P * H * W} pixels differ: "
                f"its einsum sums the window in another order), {err_c:.3e} "
                f"against B + C ({n_c} pixels differ); misfit blocks per "
                f"level {cnt.sum(1).tolist()}, every pose fits each level: "
                f"{new_fits.all(1).tolist()}")
            if not (np.isfinite(err) and err <= tol and err_c <= tol):
                fail(f"kernel W disagrees at {tag}")
            if od == torch.float32:
                stats["W"]["max_abs_err"] = max(stats["W"]["max_abs_err"],
                                                err)
            del out_w, out_p, out_c
        stage = warp_stage_turns(torch, tag, inter, geom, levels, P, B_, Wn,
                                 bgv)
        stats.setdefault("warp_stage", {})[tag] = stage

        one = march_bound(torch, pay, grid.qscale, m["zb"], slab_ids, G, GI,
                          bd, sthr)
        whole_ms = cuda_ms(torch, run_m, KREPS)
        log(f"kernel M [{tag}, {P} poses]: {whole_ms:.3f} ms per launch, "
            f"bound {one[0]:.3f} ms ({one[1]})")
        stats.setdefault("M_launches", {})[tag] = {
            "poses": P, "ms": whole_ms, "bound_ms": one[0], **occ,
            "rows": cfg["rows"]}
        if not time_it:
            return

        # kernel M's row: one launch over the poses its plain version ran;
        # the main path's launch of the whole group is kept beside it
        stats["M_group"] = {"poses": P, "ms": whole_ms, "bound_ms": one[0],
                            "bound_by": one[1]}
        stats["M"]["poses"] = len(sub)
        # the poses' inputs are taken out of the timed calls: indexing with
        # a host list copies the index from pageable memory, which waits
        # for the card and would put the host's work in the reading
        p_sub, z_sub = params[sub], zb[sub]
        stats["M"]["ms"] = cuda_ms(torch, lambda: run_m(p_sub, z_sub), KREPS)
        stats["M"]["plain_ms"] = m_plain_ms
        stats["M"]["bound_ms"], stats["M"]["bound_by"] = march_bound(
            torch, pay, grid.qscale, m_sub["zb"], slab_ids, G, GI, bd, sthr)
        stats["M"]["library_ms"] = None

        stats["B"]["ms"] = cuda_ms(
            torch, lambda: display_warp.build_table(inter, Wn), KREPS)
        stats["B"]["plain_ms"] = cuda_ms(
            torch, lambda: display_warp.build_table_ref(inter, Wn), KREPS)
        stats["B"]["bound_ms"], stats["B"]["bound_by"] = bound(
            P * (4 * GI * GI * 4 + H3 * W3 * C), P * 4 * GI * GI * 5)
        # library yardstick: ONE torch.take gathering the same table from
        # the int8 planes (the quantize pass is outside the timed call)
        q = display_warp._quantize_affine(inter)
        rr = torch.arange(H3 * W3, device=dev)
        cc = torch.arange(C, device=dev)
        cy, cx, ch = cc // (4 * Wn[1]), (cc // 4) % Wn[1], cc % 4
        idx = (ch[None] * GI * GI + (rr // W3)[:, None] * GI
               + cy[None] * GI + (rr % W3)[:, None] + cx[None])
        idx = (torch.arange(P, device=dev)[:, None, None] * 4 * GI * GI
               + idx[None])
        if not torch.equal(torch.take(q, idx), tbl_p):
            fail("kernel B's library yardstick builds another table")
        stats["B"]["library_ms"] = cuda_ms(
            torch, lambda: torch.take(q, idx), KREPS)
        del q, idx, tbl_p

        stats["C"]["ms"] = cuda_ms(
            torch, lambda: display_warp.combine_emit(
                *cargs, out_dtype=torch.uint8), KREPS)
        stats["C"]["plain_ms"] = cuda_ms(
            torch, lambda: display_warp.combine_emit_ref(
                *cargs, out_dtype=torch.uint8), KREPS)
        S = B_[0] * B_[1]
        Hh, Wh = H // B_[0], W // B_[1]
        rows = int(torch.unique(
            (torch.arange(P, device=dev)[:, None, None] * H3 * W3
             + Y0.long() * W3 + X0.long())).numel())
        cbytes = (rows * C + P * (2 * Hh * Wh * 4 + 3 * S * Hh * Wh * 4
                                  + H * W * 4))
        # per pixel the dequant and composite, per non-zero tent term its
        # weight and 4 multiply-adds
        taps = tent_taps(torch, ry, rx, okm, Wn)
        cflops = P * H * W * 30 + taps * 9
        stats["C"]["bound_ms"], stats["C"]["bound_by"] = bound(cbytes,
                                                               cflops)
        stats["C"]["library_ms"] = None
        stats["W"]["ms"] = cuda_ms(torch, run_w, KREPS)
        stats["W"]["plain_ms"] = cuda_ms(torch, run_w_plain, KREPS)
        stats["W"]["bound_ms"], stats["W"]["bound_by"] = bound(
            P * (4 * GI * GI * 4 + H * W * 4 + 16 * 4 + 4),
            P * H * W * (30 + 20) + taps * 9)
        stats["W"]["library_ms"] = None
        stats["WF"]["ms"] = cuda_ms(torch, lambda: display_warp.
                                    level_fit_counts(prm, levels, GI, H, W),
                                    KREPS)
        stats["WF"]["plain_ms"] = cuda_ms(
            torch, lambda: display_warp.level_fit_counts_ref(
                prm, levels, GI, H, W), KREPS)
        # per pixel its homography (~20; a pixel's position does not depend
        # on the level) and per level its extents (~6)
        stats["WF"]["bound_ms"], stats["WF"]["bound_by"] = bound(
            P * 16 * 4 + len(levels) * P * 4,
            P * H * W * (20 + 6 * len(levels)))
        stats["WF"]["library_ms"] = None
        stats["poses_per_launch"] = P
        log(f"kernel times [{tag}, {P} poses per launch]: "
            f"{json.dumps(stats)}")

    # the pose group holding orbit pose 0, as the main path launches it
    first = next(iter(groups.values()))
    check_kernels("orbit group 0", grid, pays, [cams[i] for i in first],
                  True)
    check_kernels("orbit pose 0", grid, pays, [cams[0]], False)
    scam, sslope = steep_pose(Camera, slab_render, grid)
    log(f"steep pose: fx {scam.fx:.2f}, slope {sslope:.3f}")
    check_kernels("steep", grid, pays, [scam], False)
    torch.cuda.empty_cache()

    # ---- 4. main path -------------------------------------------------------
    counts, frames, ms, peak = main_path("dense", grid, cams, groups, pays,
                                         trs)
    mrays = N_POSES * W * H / ms / 1e3
    dense_diff = against_parent("dense", grid, cams, groups, pays, trs,
                                frames)
    if "--profile" in sys.argv[1:]:
        _common.profile_run(
            lambda: render_all(grid, cams, groups, pays, trs),
            "dense main path", log, DISPLAY_RANGES)
        with parent_warp([]):
            _common.profile_run(
                lambda: render_all(grid, cams, groups, pays, trs),
                "dense main path, the parent's warp", log, DISPLAY_RANGES)

    # ---- 5. quality gate ----------------------------------------------------
    p_orbit = gate("dense orbit0", tdev, cams[0], frames[0], 5, FLOOR_ORBIT)
    del frames, pays, trs
    torch.cuda.empty_cache()

    # ---- 6. the measurement probes, on the dense grid ----------------------
    probe = probe_phase(torch, dev, grid, opt, stats)
    del grid, tdev
    torch.cuda.empty_cache()

    # ---- 7. sparse scene ----------------------------------------------------
    sdev, sgrid = setup(lambda: _common.load_tree(
        CACHE_SPARSE, lambda: make_solid_tree(
            max_depth=DEPTH, basis_dim=BASIS_DIM, seed=3)), "sparse")
    scams = _common.orbit_poses(N_POSES_SPARSE)
    sgroups, spays, strs = groups_of(sgrid, scams)
    crops = {perm: slab_render.inplane_crop(sgrid, perm,
                                            float(opt.sigma_thresh))
             for perm in spays}
    occupied = [len(sgrid.slab_ids(a, False, opt.sigma_thresh))
                for a in (0, 1, 2)]
    log(f"sparse: {len(sgroups)} pose groups, crops {crops}, occupied "
        f"slabs per axis {occupied}")
    # the cropped payloads and culled slab lists at full width: every pose
    # group, as the main path launches it
    for (perm, flip), idx in sgroups.items():
        check_kernels(f"sparse group {perm}/{flip}", sgrid, spays,
                      [scams[i] for i in idx], False)
    torch.cuda.empty_cache()
    scounts, sframes, sms, speak = main_path("sparse", sgrid, scams,
                                             sgroups, spays, strs)
    smrays = N_POSES_SPARSE * W * H / sms / 1e3
    sparse_diff = against_parent("sparse", sgrid, scams, sgroups, spays,
                                 strs, sframes)
    if "--profile" in sys.argv[1:]:
        _common.profile_run(
            lambda: render_all(sgrid, scams, sgroups, spays, strs),
            "sparse main path", log, DISPLAY_RANGES)
        with parent_warp([]):
            _common.profile_run(
                lambda: render_all(sgrid, scams, sgroups, spays, strs),
                "sparse main path, the parent's warp", log, DISPLAY_RANGES)
    p_sparse = gate("sparse orbit0", sdev, scams[0], sframes[0], 8,
                    FLOOR_SPARSE)

    del sframes, spays, strs, sgrid, sdev
    torch.cuda.empty_cache()

    # ---- 8-9. training ------------------------------------------------------
    tsum = train_phase(torch, dev, stats)

    # ---- 10. result ---------------------------------------------------------
    summary = {"card": card, "m_launches": stats.get("M_launches"),
               "warp_stage": stats.get("warp_stage"),
               "dense_mrays": mrays, "dense_ms": ms,
               "sparse_mrays": smrays, "sparse_ms": sms,
               "dense_peak_gib": peak, "sparse_peak_gib": speak,
               "dense_vs_parent": dense_diff,
               "sparse_vs_parent": sparse_diff,
               "psnr_orbit_db": p_orbit, "psnr_sparse_db": p_sparse,
               "dense_counts": counts, "sparse_counts": scounts,
               "train_lean_kernels": stats.get("train_lean_kernels"), **tsum,
               **probe, "seconds": time.perf_counter() - _T0}
    log(f"summary {json.dumps(summary)}")
    spec = (
        ("M", "slab_march_display",
         "volrend_torch/csrc/slab_march_display.cu",
         "volrend_tpu/ops/pallas_slab.py:344", counts["march"]),
        ("B", "warp_build", "volrend_torch/csrc/warp_build.cu",
         "volrend_tpu/ops/display_warp.py:139", counts["build"]),
        ("C", "warp_combine", "volrend_torch/csrc/warp_combine.cu",
         "volrend_tpu/ops/display_warp.py:228", counts["combine"]),
        ("W", "warp_display", "volrend_torch/csrc/warp_display.cu",
         "volrend_tpu/ops/display_warp.py:228", counts["warp"]),
        ("WF", "warp_display_fit", "volrend_torch/csrc/warp_display.cu",
         "volrend_tpu/ops/display_warp.py:467", counts["fit"]),
        ("MT", "slab_march_train", "volrend_torch/csrc/slab_march.cu",
         "volrend_tpu/ops/pallas_slab.py:344",
         tsum["train_counts"]["march"]),
        ("MB", "slab_march_bwd", "volrend_torch/csrc/slab_march_bwd.cu",
         "volrend_tpu/ops/pallas_slab.py:951",
         tsum["train_counts"]["march_bwd"]),
        ("MO", "slab_march_occupancy", "volrend_torch/csrc/slab_march.cu",
         "volrend_tpu/ops/pallas_slab.py:344",
         tsum["train_counts"]["occupancy_live"]),
        ("BK", "bake_pyramid", "volrend_torch/csrc/bake_pyramid.cu",
         "volrend_tpu/ops/slab_grad.py:244", tsum["train_counts"]["bake"]),
        ("BF", "warp_build_f32", "volrend_torch/csrc/warp_build.cu",
         "volrend_tpu/ops/display_warp.py:139",
         tsum["train_precise_counts"]["build_f32"]),
        ("CF", "warp_combine_f32", "volrend_torch/csrc/warp_combine.cu",
         "volrend_tpu/ops/display_warp.py:228",
         tsum["train_precise_counts"]["combine_f32"]),
        ("K5", "warp_combine_adj", "volrend_torch/csrc/warp_combine_adj.cu",
         "volrend_tpu/ops/display_warp.py:768",
         tsum["train_precise_counts"]["combine_adj"]),
        ("K6", "warp_build_adj", "volrend_torch/csrc/warp_build_adj.cu",
         "volrend_tpu/ops/display_warp.py:818",
         tsum["train_precise_counts"]["build_adj"]),
        ("P7", "probe_combine", "volrend_torch/csrc/probe_combine.cu",
         "tools/perf_sq3.py:83", probe["probe_counts"]["combine"]),
        ("P8", "probe_stream", "volrend_torch/csrc/probe_stream.cu",
         "tools/perf_overlap.py:96", probe["probe_counts"]["stream"]),
        ("P9", "probe_build", "volrend_torch/csrc/probe_build.cu",
         "tools/perf_sq4.py:47", probe["probe_counts"]["build"]),
        ("P9P", "probe_build_planar", "volrend_torch/csrc/probe_build.cu",
         "tools/perf_sq4.py:75", probe["probe_counts"]["build_planar"]),
    )
    rows = []
    for key, name, src, rep, launches in spec:
        s = stats[key]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches,
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s["bound_by"],
                     "library_ms": s["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
