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
   B's int8 table with its launch (blocks per SM, registers, shared
   memory) and, on three poses of the timed group, at two non-production
   windows in both table types and input layouts, bit for bit; kernel
   W and its fit mode against their plain versions, W against kernel B's
   and C's composition and the fit decisions against the parent's
   predicates, and the display warp stage's device time in turns against
   the parent's (its PyTorch geometry and fit predicates, B, C and
   copies), which it must beat on every launch checked;
4. the main path: ``render_frames`` over 200 orbit poses grouped by
   (perm, flip), RGBA8 output, gi=256 — launch counts reset just before and
   read just after, so every pose must have gone through kernels M and W
   (and the fit mode), none through kernels B and C or the reference
   warp; median wall time of REPS runs (each group's frames written with
   a device index, so the host never waits for the card between groups)
   and the peak device memory; then
   every frame against the parent's composition of the same path (the
   PyTorch geometry, B and C; ``parent_warp_to_screen_sq``) on the card,
   within one quantum, and the fit decisions against the parent's;
5. the quality gate: orbit pose 0 against ``render_exact.render_rays`` at
   stride 5 (>= 54 dB); then (5b) steep poses through ``render_image``:
   bench.py's steep pose (its boundary slope, 2.98, is below
   MAX_SLAB_SLOPE, so it takes one slab axis) and the two poses of
   tools/perf_split.py's sweep past the gate, which take the split-frame
   class passes (unit slope box): each pass's kernel M and kernel W (or
   the reference warp its fit counts give) against their plain versions
   with their times, the counted first call (one M and one fit-mode launch
   a pass, no B or C), REPS timed calls after it with the payload cache
   filled, the peak memory of both, and the gate at stride 8 (>= 52 dB,
   bench.py's steep floor);
6. the measurement probes (``volrend_torch/probes/``) on the dense grid at
   their own width (800^2, gi=448, the 96 orbit poses): the tent-combine
   (P7), payload-stream (P8) and table-build (P9, both layouts) kernels
   against their plain versions, with times, bounds and library
   yardsticks (the planar build's launch: blocks per SM, registers,
   shared memory); then the probes' own numbers (the stream's GB/s beside
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
   C's f32 table modes, B's launch logged, C's precise-level kernel also
   bit for bit against its generic one, the combine adjoint with its table's zero fill and the
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
10. bench.py's NDC (LLFF) scene (``get_ndc_tree``: depth 6, G=128 int8)
    and pose (``ndc_pose``) through ``render_frame``: the pose on the NDC
    z axis, kernel M on the NDC geometry and kernels B and C at every
    usable level against their plain versions, the counted run (M, then B
    and C at the pose's level: no kernel W, no fit mode, no reference
    warp when the pose fits), REPS timed runs and the gate at stride 8
    (>= 47.5 dB);
11. frame training on the NDC scene (800^2, gi=256, 4 poses near the
    bench's): kernel M's training mode and the backward kernel against
    their plain versions on pose 0, then timed steps from corrupted leaves
    with the precise warp's switch off and on (each step one launch of BK,
    the bits-mode occupancy, M and M-bwd, and with the switch on of B-f32,
    C-f32, 5 and 6 for every pose that fits; no plain version); pose 0's
    loss must fall;
12. kernel M's display variants at full width (variants_phase): the f16
    route (the dense SH16 scene baked f16, a bf16 payload; the 200 orbit
    poses through render_frames with every pose through the SH-bf16
    variant and kernel W, nothing else; throughput, peak memory; the
    variant against its plain version on group 0; pose 0 >= 54 dB), SG16,
    ASG16 and RGBA trees read from the same leaves (int8 bakes; each
    variant against its plain version on pose 0's group, render_image of
    pose 0 counted, >= 47.5 dB), the render options on pose 0 of the dense
    int8 grid (render_depth, render_bbox, a basis window, rot_dirs: each
    against its plain version, counted, rot and the window >= 47.5 dB,
    the bbox >= 40 dB, depth >= 30 dB), tools/perf_split.py's e = 0.5 sweep pose in depth mode (each
    class pass against its plain version, >= 30 dB) and bench.py's NDC
    pose in depth mode and with rot + bbox + basis window (>= 30 dB);
12b. the training pair's formats and options at the training bench's
    width (train_variants_phase): the bench's leaves read as SG9, ASG9,
    RGBA and SG6 trees (SG6: D = 19, a record width the kernels take at
    run time and a new bake width) and the SH9 tree with rot_dirs, a basis
    window (0, 3) and a render_bbox 0.25..0.75: for each, the bake kernel
    bit-equal to its plain version (live bits equal), kernel M's training
    mode and M-bwd against their plain versions on pose 0 (SG9 also on the
    lean trainer's bf16 cast) with each variant's registers, spills,
    blocks per SM, times and bounds, then timed step_frame steps from
    corrupted leaves (each one launch of BK, the bits mode, M and M-bwd in
    the case's variant, no plain version; peak memory; pose 0's loss must
    fall) and, for SG9, one step with the precise warp's switch on;
12c. mesh overlays, the display knobs and a quantized tree
    (overlay_phase), at full width: (a) on the dense int8 scene, orbit
    pose 0 with an occluding cube (the reference's 800^2 mesh test's): the
    host rasterizer's ms, kernel W's mesh mode against its plain version
    at both production levels and a generic one (uint8 and f32, alpha on
    every mesh pixel), its time against its bound and W's without the
    mesh, the counted render_image(meshes=) (one M, fit-mode and W-mesh
    launch; no B, C or reference warp), render_frame's ms beside the
    rasterizer's, >= 38 dB against the exact composite at gi=448 (the
    reference floor's own gi; gi=256's logged); tools/perf_split.py's e =
    0.5 pose with a cube (every class pass through W-mesh, >= 38 dB at
    gi=448); pose 0 with opt.show_grid (the wireframe to depth 2, counted,
    alpha 255 on its pixels). (b) orbit group 0 of the dense int8 grid and
    of the f16 route with slab_march._DIR_WIN = False, then _BF16_SHADE =
    True: each variant against its plain version, its time beside the
    default's, the group rendered counted, pose 0 >= 50 dB from the
    default frame and >= 54 dB against the exact renderer. (c) the sparse
    scene compressed by compress_tree at its defaults (bits 16; the dense
    scene's ~10^7 live leaves would take the median cut ~10 minutes):
    QuantLeaves on the card, fetch_rows and the int8 bake bit-equal to the
    host decode's, one orbit group counted (M and W only), pose 0 against
    the exact renderer on the QuantLeaves tree (>= 47.5 dB, the scene's
    floor);
12d. T2 ray-batch training and the headless batch renderer
    (t2_phase, headless_phase): (a) ``Trainer`` (the exact march and its
    fused re-march VJP, ops/grad.py; plain PyTorch, no kernel of its own)
    on the training bench's tree (depth-7 SH9 solid scene, full-depth LUT,
    max_steps 512) from corrupted leaves, on 1024- and 8192-ray batches of
    the 4 orbit poses at 800^2 against the clean tree's exact render: the
    median of 12 step times, peak memory, march iterations forward and
    backward, the march's host syncs and sync debug mode's count, one
    traced step (kernels per iteration, idle share), a held-out loss that
    must fall; the fused gradient against autograd through the fixed-length
    loop on 256 rays of examples/train_demo.py's scene (tests/test_grad.py's
    tolerance) with PARITY.md's config2 numbers. (b) The T2 recovery gate
    (examples/train_demo.py: 10 poses at 64^2, 150 steps): pose 0's loss
    must end at most 0.35 of its start. (c) ``python -m
    volrend_torch.cli.headless`` on the dense scene's npz: 16 orbit pose
    files and tools/perf_split.py's e = 0.5 pose as subprocesses (ms per
    frame, fps; the orbit PNGs byte-equal to render_frames' frames, the
    split pose's within one quantum of render_frame_split's), a counted
    in-process run (every orbit pose through M, W and the fit mode, no
    plain version), ``--renderer exact`` at scale 0.25 within one quantum
    of render_image, ``--renderer oracle`` on a depth-3 tree at 24x24 at
    >= 60 dB against the exact renderer;
12e. the parallel layer (zshard_phase): (a) in this process, kernel M's
    display mode on the dense scene's pose 0 (G=256 int8, gi=256, 800^2,
    stop_thresh 0) over 2 and 4 z-segments, each launch with its z_base
    and the upstream segments' state as acc_init (the resume variants)
    against its plain version, the last against the whole-grid launch;
    kernel M's training mode and M-bwd on 2 z-segments of the training
    bench's G=256 SH9 bake (the forward chained through acc_init, the
    backward of each segment from its incoming (T, A), state_init), each
    against its plain version, the segments' cotangent within 1e-5
    relative L2 of the whole grid's; the rows' times are the downstream
    segment's launches as the sharded paths make them (z_base, no
    acc_init; M-bwd with state_init), each also against its plain version;
    (b) a two-rank gloo world, both ranks on cuda:0, and (c) a one-rank
    NCCL world (launch.spawn, after the kernels are built) through the
    same calls: the z-sharded frames of the dense scene's orbit group 0
    against the unsharded frames, FrameTrainer.step_frame_zsharded against
    step_frame (and each step's device memory above its base) and
    step_frames_sharded over the 4 training poses against
    a one-rank mesh (the dry run's tolerances), Trainer.step_sharded at
    8192 rays against Trainer.step, a leaf-sharded render of the training
    tree against the replicated one; each case's host-clock ms beside the
    unsharded call's (two ranks sharing one card: a correctness run, not a
    scaling number), the segment launches of world (b) counted from 0;
13. one JSON line with every kernel's numbers (kernels B's and C's
    launches from phase 10's run, the display path that takes them; kernel
    M's display variants as rows of their own, their launches from phase
    12's counted runs; the training variants' rows of M and M-bwd by
    format and BK at D = 19 and 4, their launches from phase 12b's timed
    steps; kernel W's mesh mode and kernel M's dirslab and bf16shade
    variants, their launches from phase 12c's counted runs; kernel M's
    and M-bwd's z-segment launches as rows of their own, their times from
    phase 12e (a), their launches from world (b)'s run), then the result
    line.
"""

import contextlib
import itertools
import json
import math
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
FLOOR_STEEP = 52.0      # bench.py's steep gate (gate_steep)
FLOOR_NDC = 47.5        # bench.py's NDC gate
NDC_DEPTH = 6           # bench.py get_ndc_tree: G=128
NDC_FOCAL = 1111.11
NDC_TRAIN_POSES = 4
CACHE_SPARSE = os.path.join(HERE, ".torch_bench_sparse_cache.npz")
CACHE_NDC = os.path.join(HERE, ".torch_bench_ndc_cache.npz")
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
# kernel M's bf16 shading against its plain version's bf16 rounding: the
# kernel's f32 basis differs from the plain version's in the last bits,
# which can flip the bf16 rounding of a plane or of a partial sum
TOL_BF16_SHADE = 5e-3
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
               sigma_thresh: float, D=None, colour_planes=None, okb=None,
               z_base: float = 0.0):
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
    point where the ray saturates. ``D`` (default 3 * bd + 1), the colour
    planes read a voxel (default D - 1: fewer under a basis window, none in
    depth mode) and ``okb``, an in-plane (Gy, Gx) mask of the voxels a
    render_bbox keeps, follow a display variant's format and options;
    ``z_base``: the global z of a z-segment's first slab (its slab ids are
    local)."""
    D = 3 * bd + 1 if D is None else D
    colour_planes = D - 1 if colour_planes is None else colour_planes
    Gy, Gx = pay.shape[2], pay.shape[3]
    sig_planes = 2 if pay.dtype == torch.int8 else 1
    ids = list(slab_ids)
    over = []
    for s in ids:
        sl = pay[s]
        # a training payload's values as the kernels read them (bf16)
        sig = (sl[D - 1].float() * 128.0 + sl[D].float() if sig_planes == 2
               else sl[D - 1].to(torch.bfloat16).float())
        live = sig * float(qs[D - 1]) > sigma_thresh
        if okb is not None:
            live = live & okb
        over.append(int(live.sum()))
    over = np.asarray(over, np.int64)
    hG = 0.5 / G
    z = (torch.as_tensor(ids, dtype=torch.float32, device=zb.device)
         + 0.5) / G + z_base
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
    colour_bytes = int(over[marched].sum()) * colour_planes * elem
    return sig_bytes, colour_bytes, over_p, pairs_p


def march_bound(torch, pay, qs, zb, slab_ids, G: int, gi: int, bd: int,
                sigma_thresh: float, ops=None, z_planes: int = 3, **work):
    """Kernel M's bound for one launch over the poses of ``zb`` (P, 4, gi,
    gi), from march_work: bytes are the marched slabs' sigma planes and the
    colour planes of their voxels above the threshold, read once, plus, per
    pose, the three z planes read and the accumulator written; operations
    per pose are the shading of its voxels above the threshold (3 MACs per
    SH basis function, the basis polynomials, the direction and three
    sigmoids: ~9*bd + 30 per voxel) and, per marched (pixel, slab) pair,
    the two-axis overlap weights, four channel taps and the composite
    (~60). ``ops`` = (per voxel, per pair) and ``work`` (march_work's D,
    colour_planes, okb) follow a display variant (variant_ops); depth mode
    reads a fourth z plane (``z_planes``)."""
    sig_b, col_b, over_p, pairs_p = march_work(torch, pay, qs, zb, slab_ids,
                                               G, bd, sigma_thresh, **work)
    P = zb.shape[0]
    ov, op = (9 * bd + 30, 60) if ops is None else ops
    nbytes = sig_b + col_b + P * (z_planes + 4) * gi * gi * 4
    flops = sum(o * ov + n * op for o, n in zip(over_p, pairs_p))
    return bound(nbytes, flops)


def march_bwd_bound(torch, pay, qs, zb, G: int, gi: int, bd: int,
                    sigma_thresh: float, out_bytes: int = 4, ops=None,
                    **work):
    """The backward kernel's bound for one pose (zb (1, 4, gi, gi)): bytes
    are what the forward reads (march_bound's payload bytes), the whole
    (Gz, D, G, G) cotangent written once (``out_bytes`` per value: f32, or
    bf16 for the lean trainer) and the per-pixel inputs read (two z planes,
    four upstream cotangents, the four forward outputs); operations are the
    forward recompute (march_bound's) plus the adjoint: per marched (pixel,
    slab) pair the suffix algebra and the transposed taps (~60), per voxel
    above the threshold the shade adjoint (the basis again, sigmoid', 3*bd
    products: ~6*bd + 40). ``ops`` and ``work`` follow a training variant
    (variant_ops, as march_bound takes them): its adjoint a voxel is its
    shading again plus a product per colour plane and ~10."""
    Gz, D = pay.shape[0], pay.shape[1]
    sig_b, col_b, (over,), (pairs,) = march_work(
        torch, pay, qs, zb, range(Gz), G, bd, sigma_thresh, **work)
    nbytes = (sig_b + col_b + Gz * D * G * G * out_bytes
              + (2 + 4 + 4) * gi * gi * 4)
    if ops is None:
        per_voxel, per_pair = 9 * bd + 30 + 6 * bd + 40, 60
    else:
        colour = work.get("colour_planes", D - 1)
        per_voxel, per_pair = 2 * ops[0] + colour + 10, ops[1]
    flops = over * per_voxel + pairs * (per_pair + 60)
    return bound(nbytes, flops)


def freeze_flip_check(torch, tag, acc_k, acc_p, stop, tol=TOL_M):
    """Kernel M's acc against its plain version: max |diff|, and the rays
    past ``tol`` (stop-threshold freeze flips, allowed only in saturated
    rays, up to MAX_FREEZE_FLIPS of them, by at most stop + tol). Returns
    (max err, flips, rays)."""
    diff = (acc_k - acc_p).abs().amax(1)                    # (P, gi, gi)
    err = float(diff.max())
    off = diff > tol
    sat = torch.maximum(acc_k[:, 3], acc_p[:, 3]) < stop
    flips = int(off.sum())
    ok = (np.isfinite(err) and err <= stop + tol
          and bool(torch.all(sat[off]))
          and flips <= MAX_FREEZE_FLIPS * off.numel())
    log(f"kernel M [{tag}]: max |acc - plain| {err:.3e}; {flips} of "
        f"{off.numel()} rays past {tol} (stop-threshold freeze flips, "
        f"allowed in saturated rays up to {MAX_FREEZE_FLIPS:.0e} of them, "
        f"by <= {stop + tol})")
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
    (vt_march_display_info, for the variant of ``cfg``, the launch's
    march_slabs.display): resident blocks per SM, registers a thread,
    spill bytes a thread, static shared memory."""
    import ctypes
    out = (ctypes.c_int * 4)()
    kernels.check(kernels.lib("slab_march_display").vt_march_display_info(
        bd, cfg["rows"], cfg["fmt"], cfg["bf16"], cfg["opt"], cfg["smem"],
        out), "slab_march_display")
    return {"blocks_per_sm": out[0], "regs": out[1], "spill_bytes": out[2],
            "static_smem": out[3]}


def build_occupancy(kernels, P: int, gi: int, win, f32: bool,
                    planar: bool) -> dict:
    """What the card makes of kernel B's launch for these arguments
    (vt_warp_build_info): resident blocks per SM, registers and spill
    bytes a thread, dynamic shared memory a block, blocks a pose, window
    columns a block, whether it stages its input rows, threads a block."""
    import ctypes
    out = (ctypes.c_int * 8)()
    kernels.check(kernels.lib("warp_build").vt_warp_build_info(
        P, gi, win[0], win[1], int(f32), int(planar), out), "warp_build")
    return dict(zip(("blocks_per_sm", "regs", "spill_bytes", "smem",
                     "blocks_per_pose", "cols_per_block", "staged",
                     "threads"), out))


def build_extra_checks(torch, inter) -> None:
    """Kernel B away from the production levels: a non-production window
    (3 x 3, 2 x 5) on 3 poses of the (P, 4, gi, gi) intermediate ``inter``,
    both table types and both input layouts, bit-equal to its plain
    version."""
    from volrend_torch.ops import display_warp
    sub = inter[:3].contiguous()
    ilv = sub.movedim(1, -1).contiguous()
    for win, dt, (x, planar) in itertools.product(
            ((3, 3), (2, 5)), (torch.int8, torch.float32),
            ((sub, True), (ilv, False))):
        if not torch.equal(
                display_warp.build_table(x, win, dtype=dt, planar=planar),
                display_warp.build_table_ref(x, win, dtype=dt,
                                             planar=planar)):
            fail(f"kernel B is not bit-equal to its plain version at "
                 f"window {win}, {dt}, planar={planar}, 3 poses")
    log(f"kernel B at windows (3, 3), (2, 5), both table types and layouts, "
        f"{sub.shape[0]} poses of gi={sub.shape[-1]}: bit-equal")


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
    train_counts_ok("train (switch off)", off["counts"], n, "SH-f32")
    train_counts_ok("train (switch on)", on["counts"], n, "SH-f32",
                    precise=True)
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


def train_occupancy(kernels, bd: int, f32: bool, fmt: int = 1,
                    opt: bool = False) -> dict:
    """What the card makes of the training kernels' launches of a variant
    (vt_march_slabs_info, vt_march_slabs_bwd_info; the SH default unless
    ``fmt``/``opt`` say otherwise): resident blocks per SM,
    registers a thread, spill bytes a thread and dynamic shared memory of
    kernel M's training mode and of the backward's passes, and the launch
    configuration they were built with."""
    import ctypes
    from volrend_torch.ops.slab_march import train_lib
    m = (ctypes.c_int * 11)()
    kernels.check(train_lib("slab_march", fmt, opt).vt_march_slabs_info(
        bd, int(f32), fmt, int(opt), m), "slab_march")
    b = (ctypes.c_int * 7)()
    kernels.check(train_lib("slab_march_bwd", fmt,
                            opt).vt_march_slabs_bwd_info(
        bd, int(f32), fmt, int(opt), b), "slab_march_bwd")
    keys = ("blocks_per_sm", "regs", "spill_bytes", "smem")
    return {"M": dict(zip(keys, m[:4])),
            "M-bwd pass 1": dict(zip(keys, b[:4])),
            "M-bwd pass 2": dict(zip(keys[:3], b[4:])),
            "config": dict(zip(("ty", "tx", "nt", "ps", "ring", "dc",
                                "rslots"), m[4:]))}


def train_kernel_checks(torch, dev, planar, params, zb, gacc4, ids, cfg,
                        stop, live, extra=None):
    """Phase 8a on one payload (the bake's f32 view or its bf16 cast):
    kernel M's training mode and the backward kernel against their plain
    versions on pose 0 (and their shared coarse occupancy in both modes,
    each bit-equal to its plain version and to the other), their times,
    bounds (counted at the payload's element size), launch configuration
    and the share of slabs and jobs skipped as empty (the kernels' counts).
    ``live``: the pyramid bake's live bits. The variant is the one
    ``cfg`` trains (its format, and the options of cfg.opt), with the
    SG/ASG lobes ``extra``; an option variant's bounds count its
    variant_ops. Returns {"MT", "MB", "MO", "acc4"}; "MO" is the bits mode
    the step launches, with the full read's numbers under "full_read"."""
    import types
    from volrend_torch import kernels
    from volrend_torch.ops import slab_grad, slab_march
    G, D, bd = cfg.G, cfg.D, cfg.bd
    perm, flip = cfg.perm, cfg.flip
    f32 = planar.dtype == torch.float32
    qs = torch.ones(D, device=dev)
    st = slab_grad._kernel_statics(cfg)
    st.pop("flip")
    st["extra"] = extra
    mode = slab_march.MarchMode(cfg.fmt, extra, False, st["rot"],
                                st["bbox_full"], st["basis_lo"],
                                st["basis_hi"])
    variant = slab_march.train_variant(mode, bd, f32)
    tag = f"pose 0, {G} slabs, {planar.dtype}, {variant}"

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
            flip=flip, dir_win=False, occupancy=occ, train=True, **st)
    acc_k = run_m()
    torch.cuda.synchronize()
    acc_p, mt_plain_ms = timed_once(
        torch, lambda: slab_march.march_slabs_ref(planar, qs, D=D, bd=bd,
                                                  flip=flip, **st, **m))
    err, flips, nray = freeze_flip_check(
        torch, f"training mode, {tag}", acc_k, acc_p, stop)
    del acc_p
    mt = {"max_abs_err": err, "plain_ms": mt_plain_ms,
          "ms": cuda_ms(torch, run_m, KREPS), "library_ms": None}
    ops, work = None, {}
    if mode.options(bd):  # an option variant's operations and planes
        ops, colour = variant_ops(types.SimpleNamespace(
            fmt=cfg.fmt, basis_dim=bd), cfg.opt)
        work = dict(D=D, colour_planes=colour)
        if not st["bbox_full"]:
            prm = m["params"][0]
            c = (torch.arange(G, device=dev) + 0.5) / G
            h = 0.5 / G
            work["okb"] = (((c + h > prm[16]) & (c - h < prm[17]))[:, None]
                           & ((c + h > prm[18]) & (c - h < prm[19]))[None])
    mt["bound_ms"], mt["bound_by"] = march_bound(
        torch, planar, qs, m["zb"], ids, G, GI, bd, sthr, ops=ops, **work)
    sig_b, col_b, (over,), (pairs,) = march_work(torch, planar, qs, m["zb"],
                                                 ids, G, bd, sthr, **work)
    log(f"train [{tag}]: pose 0's march reads {sig_b} B of sigma and "
        f"{col_b} B of colour ({over} voxels above the sigma threshold) "
        f"and marches {pairs} (pixel, slab) pairs")

    acc4 = acc_k[0]

    def run_b():
        return slab_march.march_slabs_bwd(
            planar, params[0], qs, zb[0], gacc4, acc4, G, GI, D, bd, perm,
            flip=flip, out_dtype=planar.dtype, occupancy=occ, **st)

    g_k = run_b()
    torch.cuda.synchronize()
    if g_k.stride() != planar.stride():
        fail(f"the backward's cotangent has strides {g_k.stride()}, not the "
             f"payload's {planar.stride()}")
    bprm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
        params[0], zb[0], gacc4, acc4, G, GI)
    g_p, mb_plain_ms = timed_once(
        torch, lambda: slab_march.march_slabs_bwd_ref(
            planar, qs, bprm, bzb, bgacc, aux, G, GI, D, bd, flip,
            mode=mode))
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
        out_bytes=planar.element_size(), ops=ops, **work)

    # the launch configuration and the share skipped as empty
    occ_info = train_occupancy(kernels, bd, f32, cfg.fmt,
                               mode.options(bd))
    tcfg = occ_info["config"]
    cm = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64, device=dev)
    cb = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64, device=dev)
    slab_march._march_train_cuda(planar, qs, D=D, bd=bd, flip=flip,
                                 counts=cm, occ=occ, mode=mode, **m)
    slab_march._march_bwd_cuda(planar, bprm, qs, bzb, bgacc, aux, G, GI, D,
                               bd, flip, planar.dtype, counts=cb, occ=occ,
                               mode=mode)
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
    mt["variant"] = mb["variant"] = variant
    return {"MT": mt, "MB": mb, "MO": mo, "acc4": acc4}


def reset_train_counts():
    """Set the training path's launch counts to 0 (read_train_counts)."""
    from volrend_torch.ops import (display_warp, slab_grad, slab_march,
                                   slab_render)
    slab_grad.bake_from_pyramid.launches = 0
    slab_march.march_slabs.launches = 0
    slab_march.march_slabs_bwd.launches = 0
    slab_march.march_slabs.train_variants = {}
    slab_march.march_slabs_bwd.variants = {}
    slab_march.march_occupancy.launches = 0
    slab_march.march_occupancy.launches_live = 0
    display_warp.build_table.launches_f32 = 0
    display_warp.combine_emit.launches_f32 = 0
    display_warp.combine_adjoint.launches = 0
    display_warp.build_adjoint.launches = 0
    slab_render._warp_to_screen_ref.precise_poses = 0


def read_train_counts(plain_calls) -> dict:
    """The training path's launch counts since reset_train_counts, and the
    plain versions' calls (count_plain_calls)."""
    from volrend_torch.ops import (display_warp, slab_grad, slab_march,
                                   slab_render)
    return dict(bake=slab_grad.bake_from_pyramid.launches,
                march=slab_march.march_slabs.launches,
                march_bwd=slab_march.march_slabs_bwd.launches,
                march_variants=dict(slab_march.march_slabs.train_variants),
                march_bwd_variants=dict(slab_march.march_slabs_bwd.variants),
                occupancy=slab_march.march_occupancy.launches,
                occupancy_live=slab_march.march_occupancy.launches_live,
                build_f32=display_warp.build_table.launches_f32,
                combine_f32=display_warp.combine_emit.launches_f32,
                combine_adj=display_warp.combine_adjoint.launches,
                build_adj=display_warp.build_adjoint.launches,
                ref_warp_poses=slab_render._warp_to_screen_ref.precise_poses,
                plain=dict(plain_calls))


def timed_steps(torch, tr, cams, tgt, tag):
    """TRAIN_WARM untimed steps per pose, then TRAIN_STEPS synced and
    TRAIN_STEPS ``sync=False`` steps per pose with the launch counts reset
    just before and read just after, and the peak device memory over the
    timed steps. ``tgt``: one target for every pose, or a list of one a
    pose."""
    tgts = tgt if isinstance(tgt, list) else [tgt] * len(cams)
    for s in range(TRAIN_WARM * len(cams)):
        tr.step_frame(cams[s % len(cams)], tgts[s % len(cams)])
    torch.cuda.synchronize()
    plain_calls = count_plain_calls()
    reset_train_counts()
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_STEPS * len(cams)
    synced = []
    for s in range(n):
        t0 = time.perf_counter()
        loss = tr.step_frame(cams[s % len(cams)], tgts[s % len(cams)])
        synced.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss):
            fail(f"{tag}: non-finite loss at step {s}")
    t0 = time.perf_counter()
    for s in range(n):
        loss_t = tr.step_frame(cams[s % len(cams)], tgts[s % len(cams)],
                               sync=False)
    last = float(loss_t)
    pipelined = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = read_train_counts(plain_calls)
    restore_plain()
    if not np.isfinite(last):
        fail(f"{tag}: non-finite loss (sync=False)")
    ms_synced = float(np.median(synced))
    log(f"{tag}: {2 * n} steps, counts {counts}; median {ms_synced:.3f} "
        f"ms/step synced (steps {synced}), {pipelined:.3f} ms/step with "
        f"sync=False; peak {peak:.3f} GiB allocated; last loss {last:.6f}")
    return {"steps": 2 * n, "counts": counts, "ms_synced": ms_synced,
            "ms_pipelined": pipelined, "peak_gib": peak, "last_loss": last}


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
    from volrend_torch import kernels
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
    log(f"kernel B-f32 [pose 0]: on the card "
        f"{build_occupancy(kernels, 1, GI, Wn, True, False)}")
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
    import ctypes
    import torch.nn.functional as F
    from volrend_torch import kernels
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
    pinfo = (ctypes.c_int * 6)()
    kernels.check(kernels.lib("probe_build").vt_probe_build_info(gi, pinfo),
                  "probe_build")
    log("P9 planar: on the card " + json.dumps(dict(zip(
        ("blocks_per_sm", "regs", "spill_bytes", "smem", "staged",
         "threads"), pinfo))))
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
                             planar=False, plan=None, ndc=None, origin=None,
                             bg_pix=None):
    """The parent commit's display warp (display_warp.warp_to_screen_sq
    before kernel W): the fit predicates in PyTorch read on the host, then
    per level the PyTorch geometry, kernel B's int8 table, kernel C and an
    index-put of the frames; the misfit poses through the reference warp.
    ``plan`` is not read; each batch's per-pose level goes to
    ``choices``. World trees without a mesh only (the main path's;
    ``origin`` is not read)."""
    if ndc is not None or bg_pix is not None:
        fail("parent_warp_to_screen_sq: the parent's warp is compared on "
             "world trees only")
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


def reset_counts():
    """Set the display path's launch counts to 0 (and the reference warp's
    pose count)."""
    from volrend_torch.ops import display_warp, slab_march, slab_render
    slab_march.march_slabs.launches = 0
    slab_march.march_slabs.poses = 0
    display_warp.build_table.launches = 0
    display_warp.combine_emit.launches = 0
    display_warp.combine_emit.poses = 0
    display_warp.warp_display.launches = 0
    display_warp.warp_display.poses = 0
    display_warp.warp_display.mesh_launches = 0
    display_warp.warp_display.mesh_poses = 0
    display_warp.level_fit_counts.launches = 0
    slab_render._warp_to_screen_ref.poses = 0


def read_counts() -> dict:
    from volrend_torch.ops import display_warp, slab_march, slab_render
    return dict(
        march=slab_march.march_slabs.launches,
        march_poses=slab_march.march_slabs.poses,
        warp=display_warp.warp_display.launches,
        warp_poses=display_warp.warp_display.poses,
        warp_mesh=display_warp.warp_display.mesh_launches,
        warp_mesh_poses=display_warp.warp_display.mesh_poses,
        fit=display_warp.level_fit_counts.launches,
        build=display_warp.build_table.launches,
        combine=display_warp.combine_emit.launches,
        combine_poses=display_warp.combine_emit.poses,
        ref_warp_poses=slab_render._warp_to_screen_ref.poses)


def timed_reps(torch, fn):
    """fn() REPS times after one warm call: (median device ms by CUDA
    events, the host seconds of each run, peak GiB allocated over them)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append((a.elapsed_time(b), time.perf_counter() - t0))
    return (float(np.median([x[0] for x in ts])), [x[1] for x in ts],
            torch.cuda.max_memory_allocated() / 2**30)


def bench_steep_pose(Camera):
    """bench.py steep_pose (its gate_steep, floor 52 dB)."""
    back = np.asarray([np.cos(1.2), 0.2, np.sin(1.2)])
    back /= np.linalg.norm(back)
    return Camera.from_vectors(center=tuple(1.35 * back), v_back=tuple(back),
                               v_world_up=(0.0, 1.0, 0.0), width=W,
                               height=H, fx=420.0)


def split_sweep_poses(Camera):
    """The poses of tools/perf_split.py's elevation sweep (radius 1.35,
    fx 420, back ~ (cos e, 0.2, sin e)) past the single-axis gate: e = 0.5
    (boundary slope ~5.1) and e = 0.9 (~42), three class passes each."""
    cams = []
    for elev in (0.5, 0.9):
        back = np.asarray([np.cos(elev), 0.2, np.sin(elev)])
        back /= np.linalg.norm(back)
        cams.append(Camera.from_vectors(
            center=tuple(1.35 * back), v_back=tuple(back),
            v_world_up=(0.0, 1.0, 0.0), width=W, height=H, fx=420.0))
    return cams


def display_march_check(torch, tag, grid, opt, pay, g, perm, flip, crop,
                        stats):
    """Kernel M's display mode on one pose batch's geometry ``g`` against
    its plain version (freeze_flip_check); returns (acc4, run_m)."""
    from volrend_torch.ops import slab_march, slab_render
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip, opt)
    slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)
    m = slab_march.march_inputs(pay, params, zb, grid.G, GI, slab_ids,
                                slab_march._K_STEP, crop)

    def run_m():
        return slab_march.march_slabs(
            pay, params, grid.qscale, zb, grid.G, GI, grid.data_dim,
            grid.basis_dim, perm, slab_ids=slab_ids, sig2=True, flip=flip,
            bbox_full=True, dir_win=True, k_per_step=slab_march._K_STEP,
            crop=crop)

    acc_k = run_m()
    torch.cuda.synchronize()
    acc_p, _ = timed_once(torch, lambda: slab_march.march_slabs_ref(
        pay, grid.qscale, D=grid.data_dim, bd=grid.basis_dim, flip=flip,
        **m))
    err, _, _ = freeze_flip_check(
        torch, f"{tag}, crop {crop}, {len(slab_ids)} slabs", acc_k, acc_p,
        float(opt.stop_thresh))
    stats["M"]["max_abs_err"] = max(stats["M"]["max_abs_err"], err)
    return acc_k, run_m


def split_pass_check(torch, grid, opt, cam, axis, flip, stats):
    """One class pass of the steep pose (unit slope box, perm (axis,
    axis+1, axis+2)): kernel M against its plain version, the fit counts
    of kernel W's fit mode against theirs and the level the pass takes,
    and at that level kernel W against its plain version; their times."""
    from volrend_torch.ops import display_warp, slab_render
    perm = (axis, (axis + 1) % 3, (axis + 2) % 3)
    tag = f"steep pass {perm}/{flip}"
    crop = slab_render.inplane_crop(grid, perm, float(opt.sigma_thresh))
    pay = slab_render.prepare_payload(grid, perm, opt)
    g = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                              flip, W, H, opt, GI, unit_slope_box=True)
    acc, run_m = display_march_check(torch, tag, grid, opt, pay, g, perm,
                                     flip, crop, stats)
    inter = slab_render._finalize_planar(acc, opt).contiguous()
    prm = display_warp.display_params(g.R, g.fx, g.fy, g.u0, g.du, g.v0,
                                      g.dv, g.scale, perm)
    levels = display_warp._usable_levels(W, H, GI)
    cnt = display_warp.level_fit_counts(prm, levels, GI, H, W)
    if not torch.equal(cnt, display_warp.level_fit_counts_ref(
            prm, levels, GI, H, W)):
        fail(f"{tag}: kernel W's fit counts differ from their plain version")
    fits = display_warp._fits_from_counts(cnt.cpu(), levels, H,
                                          W).numpy()[:, 0]
    level = int(np.argmax(fits)) if fits.any() else -1
    res = {"perm": perm, "flip": flip, "crop": crop,
           "misfit_blocks": cnt[:, 0].tolist(),
           "warp": (str(levels[level]) if level >= 0
                    else "reference warp"),
           "m_ms": cuda_ms(torch, run_m, KREPS)}
    if level >= 0:
        B, Wn = levels[level]
        sel = torch.zeros(1, dtype=torch.int32, device=inter.device)
        bgv = float(opt.background_brightness)

        def run_w(od=torch.uint8, fn=display_warp.warp_display):
            out = torch.empty((1, H, W, 4), dtype=od, device=inter.device)
            return fn(inter, prm, sel, out, B, Wn, GI, bgv)

        for od, tol in ((torch.uint8, TOL_C_U8), (torch.float32, TOL_C_F32)):
            a = run_w(od)
            b = run_w(od, display_warp.warp_display_ref)
            err = float((a.float() - b.float()).abs().max())
            if not (np.isfinite(err) and err <= tol):
                fail(f"{tag}: kernel W disagrees with its plain version "
                     f"({od}: {err})")
            if od == torch.float32:
                stats["W"]["max_abs_err"] = max(stats["W"]["max_abs_err"],
                                                err)
            res[f"w_err_{'u8' if od == torch.uint8 else 'f32'}"] = err
        res["w_ms"] = cuda_ms(torch, run_w, KREPS)
    log(f"{tag}: {json.dumps(res)}")
    del pay, acc, inter
    return res


def steep_pose_run(torch, tdev, grid, opt, stats, gate, tag, cam):
    """One steep pose through render_image (RGBA8, gi=256): its route (the
    split-frame class passes past MAX_SLAB_SLOPE, else one slab axis), for
    a split frame each class pass's kernels against their plain versions,
    the counted first call, REPS timed calls after it with the payload
    cache filled, the peak memory of both and the gate at stride 8
    (>= FLOOR_STEEP)."""
    from volrend_torch.ops import slab_render
    _, _, slope = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                          cam.fy, W, H)
    split = not (np.isfinite(slope) and slope < slab_render.MAX_SLAB_SLOPE)
    classes = (slab_render.split_classes(grid, cam.transform, cam.fx,
                                         cam.fy, W, H) if split else ())
    log(f"{tag}: slope {slope}; "
        + (f"split frame, {len(classes)} class passes {classes}" if split
           else "below MAX_SLAB_SLOPE: one slab axis"))
    passes = [split_pass_check(torch, grid, opt, cam, a, f, stats)
              for a, f in classes]
    torch.cuda.empty_cache()
    cache = {}

    def run():
        return slab_render.render_image(grid, cam, opt, gi=GI,
                                        payload_cache=cache,
                                        out_dtype=torch.uint8)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    frame = run()
    torch.cuda.synchronize()
    counts = read_counts()
    first_peak = torch.cuda.max_memory_allocated() / 2**30
    n = max(len(classes), 1)
    n_ref = sum(p["warp"] == "reference warp" for p in passes)
    log(f"{tag}: counts {counts} (first call, payloads built: peak "
        f"{first_peak:.3f} GiB allocated; cache {sorted(cache)})")
    if (counts["march"], counts["march_poses"], counts["fit"]) != (n, n, n):
        fail(f"{tag}: not one launch of kernel M and of the fit mode a pass "
             f"({counts})")
    if split and (counts["warp_poses"],
                  counts["ref_warp_poses"]) != (n - n_ref, n_ref):
        fail(f"{tag}: the passes did not take the warps their fit counts "
             f"gave ({counts}; {n_ref} reference-warp passes)")
    if counts["warp_poses"] + counts["ref_warp_poses"] != n:
        fail(f"{tag}: a pass was not warped once ({counts})")
    if counts["build"] or counts["combine"]:
        fail(f"{tag}: kernels B or C ran ({counts})")
    ms, host_s, peak = timed_reps(torch, run)
    log(f"{tag}: render_image {ms:.3f} ms median of {REPS} (host s "
        f"{host_s}), peak {peak:.3f} GiB allocated")
    if frame.shape != (H, W, 4) or frame.dtype != np.uint8:
        fail(f"{tag}: frame {frame.shape} {frame.dtype}")
    p = gate(tag, tdev, cam, torch.as_tensor(frame, device=grid.device), 8,
             FLOOR_STEEP)
    del cache
    torch.cuda.empty_cache()
    return {"slope": slope, "split": split, "classes": classes, "ms": ms,
            "host_s": host_s, "peak_gib": peak, "first_peak_gib": first_peak,
            "counts": counts, "passes": passes, "psnr_db": p}


def steep_phase(torch, tdev, grid, opt, stats, gate):
    """Phase 5b: bench.py's steep pose, then the split-frame route at full
    width on tools/perf_split.py's sweep poses past the gate (bench.py's
    steep pose has a boundary slope below MAX_SLAB_SLOPE, so render_image
    takes one slab axis for it, in both packages)."""
    from volrend_torch.ops.camera import Camera
    out = {"steep_bench": steep_pose_run(torch, tdev, grid, opt, stats, gate,
                                         "steep (bench.py)",
                                         bench_steep_pose(Camera))}
    for i, cam in enumerate(split_sweep_poses(Camera)):
        r = steep_pose_run(torch, tdev, grid, opt, stats, gate,
                           f"steep split {i}", cam)
        if not r["split"]:
            fail(f"steep split {i}: the pose is not past the gate")
        out[f"steep_split_{i}"] = r
    return out


def ndc_tree():
    """bench.py get_ndc_tree: the depth-6 SH16 fog with the LLFF sidecar
    NdcConfig(800, 800, 1111.11) (restored after a cache load: the npz
    holds the scene arrays only)."""
    from volrend_torch.models.n3tree import NdcConfig
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.probes import _common
    tree = _common.load_tree(CACHE_NDC, lambda: make_test_tree(
        max_depth=NDC_DEPTH, basis_dim=BASIS_DIM, seed=4, n_blobs=6,
        sigma_scale=60.0))
    tree.use_ndc = True
    tree.ndc = NdcConfig(width=float(W), height=float(H), focal=NDC_FOCAL)
    return tree


def bench_ndc_pose(Camera, center=(0.0, 0.0, 0.2), back=(0.05, 0.02, 1.0)):
    """bench.py ndc_pose (and poses near it)."""
    return Camera.from_vectors(center=center, v_back=back,
                               v_world_up=(0.0, 1.0, 0.0), width=W,
                               height=H, fx=NDC_FOCAL)


def ndc_phase(torch, dev, opt, stats, gate):
    """Phase 10: bench.py's NDC scene and pose through render_frame
    (RGBA8, gi=256): kernel M on the NDC geometry, kernel B's int8 table
    and kernel C at every usable level against their plain versions, the
    counted run (M, then B and C at the pose's level: no kernel W, no fit
    mode), REPS timed runs and the PSNR gate. Returns (summary, tree)."""
    from volrend_torch.ops import dense_grid, display_warp, slab_render
    from volrend_torch.ops.camera import Camera
    t = time.perf_counter()
    tree = ndc_tree()
    tdev = tree.to_device(lut_depth=None, device=dev)
    grid = dense_grid.bake_dense(tdev, dtype="int8")
    torch.cuda.synchronize()
    log(f"ndc: tree, upload and int8 bake G={grid.G} in "
        f"{time.perf_counter() - t:.1f} s; sidecar {grid.ndc}")
    cam = bench_ndc_pose(Camera)
    perm, flip, slope = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                                cam.fy, W, H)
    log(f"ndc: pose group {perm}/{flip}, slope {slope}")
    if perm[0] != 2 or not (np.isfinite(slope)
                            and slope < slab_render.MAX_SLAB_SLOPE):
        fail(f"ndc: the bench's NDC pose is not slab-renderable on the NDC "
             f"z axis ({perm}, {slope})")
    crop = slab_render.inplane_crop(grid, perm, float(opt.sigma_thresh))
    pay = slab_render.prepare_payload(grid, perm, opt)
    g = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                              flip, W, H, opt, GI)
    acc, run_m = display_march_check(torch, "ndc pose", grid, opt, pay, g,
                                     perm, flip, crop, stats)
    inter = slab_render._finalize_planar(acc, opt).contiguous()
    geom = (g.R, g.fx, g.fy, W, H, GI, perm, g.u0, g.du, g.v0, g.dv,
            g.scale, grid.ndc, g.origin_w)
    plan = display_warp.plan_fits(*geom[:12], ndc=grid.ndc,
                                  origin=g.origin_w)
    level = int(plan.choice()[0])
    bgv = float(opt.background_brightness)
    res = {"perm": perm, "flip": flip, "slope": slope, "crop": crop,
           "misfit_blocks": plan.counts()[:, 0].tolist(),
           "warp": (str(plan.levels[level]) if level >= 0
                    else "reference warp"),
           "m_ms": cuda_ms(torch, run_m, KREPS)}
    for li, (B, Wn) in enumerate(plan.levels):
        tbl = display_warp.build_table(inter, Wn)
        if not torch.equal(tbl, display_warp.build_table_ref(inter, Wn)):
            fail(f"ndc: kernel B is not bit-equal to its plain version at "
                 f"{(B, Wn)}")
        gys, gxs, okm, Y0, X0 = display_warp._level_geometry(geom, GI, B, Wn)
        cargs = (tbl, Y0.contiguous(), X0.contiguous(),
                 (gys - Y0.float()[:, None]).contiguous(),
                 (gxs - X0.float()[:, None]).contiguous(), okm.contiguous(),
                 GI, H, W, B, Wn, bgv)
        for od, tol in ((torch.uint8, TOL_C_U8), (None, TOL_C_F32)):
            a = display_warp.combine_emit(*cargs, out_dtype=od)
            b = display_warp.combine_emit_ref(*cargs, out_dtype=od)
            err = float((a.float() - b.float()).abs().max())
            if not (np.isfinite(err) and err <= tol):
                fail(f"ndc: kernel C disagrees with its plain version at "
                     f"{(B, Wn)} ({od}: {err})")
            if od is None:
                stats["C"]["max_abs_err"] = max(stats["C"]["max_abs_err"],
                                                err)
        if li == level:
            res["b_ms"] = cuda_ms(torch, lambda: display_warp.build_table(
                inter, Wn), KREPS)
            res["c_ms"] = cuda_ms(torch, lambda: display_warp.combine_emit(
                *cargs, out_dtype=torch.uint8), KREPS)
        del tbl, gys, gxs, okm, Y0, X0, cargs
    log(f"ndc kernels: M, B (bit-equal) and C at levels {plan.levels} "
        f"against their plain versions; {json.dumps(res)}")
    del acc, inter

    def run():
        return slab_render.render_frame(
            grid, cam.transform, cam.fx, cam.fy, perm, flip, W, H, opt, GI,
            payload=pay, out_dtype=torch.uint8)

    torch.cuda.synchronize()
    reset_counts()
    frame = run()
    torch.cuda.synchronize()
    counts = read_counts()
    fits = level >= 0
    want = dict(march=1, march_poses=1, warp=0, warp_poses=0, warp_mesh=0,
                warp_mesh_poses=0, fit=0,
                build=int(fits), combine=int(fits), combine_poses=int(fits),
                ref_warp_poses=int(not fits))
    log(f"ndc: counts {counts}")
    if counts != want:
        fail(f"ndc: the path's launches {counts}, not {want}")
    ms, host_s, peak = timed_reps(torch, run)
    log(f"ndc: render_frame {ms:.3f} ms median of {REPS} (host s {host_s}), "
        f"peak {peak:.3f} GiB allocated")
    if tuple(frame.shape) != (H, W, 4):
        fail(f"ndc: frame of shape {tuple(frame.shape)}")
    p = gate("ndc", tdev, cam, frame, 8, FLOOR_NDC)
    del grid, tdev, pay, frame
    torch.cuda.empty_cache()
    return ({"ndc_ms": ms, "ndc_host_s": host_s, "ndc_peak_gib": peak,
             "ndc_counts": counts, "ndc_kernels": res, "psnr_ndc_db": p},
            tree)


def ndc_train_phase(torch, dev, tree, stats):
    """Phase 11: FrameTrainer on the NDC scene (800^2, gi=256) over
    NDC_TRAIN_POSES poses near the bench's: kernel M's training mode and
    the backward kernel against their plain versions on pose 0, then from
    corrupted leaves (as the recovery gate corrupts them) timed steps with
    the precise warp's switch off and on, each from the same start: the
    launch counts, and pose 0's loss must fall."""
    from volrend_torch import train
    from volrend_torch.ops import display_warp, slab_grad, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.utils.options import RenderOptions
    topt = RenderOptions(max_steps=1024)
    t = time.perf_counter()
    tdev = tree.to_device(lut_depth=None, device=dev)
    tr = train.FrameTrainer(tdev, opt=topt, lr=TRAIN_LR, gi=GI)
    torch.cuda.synchronize()
    G, D, bd = tr.grid.G, tr.grid.data_dim, tr.grid.basis_dim
    log(f"ndc train: FrameTrainer G={G} SH{bd} in "
        f"{time.perf_counter() - t:.1f} s")
    cams = [bench_ndc_pose(Camera, center=(0.02 * i, -0.01 * i,
                                           0.2 + 0.03 * i),
                           back=(0.05 - 0.02 * i, 0.02 + 0.01 * i, 1.0))
            for i in range(NDC_TRAIN_POSES)]
    groups = [tr._group(c) for c in cams]
    perm, flip = groups[0]
    log(f"ndc train: pose groups {groups}")

    # ---- kernel M's training mode and the backward kernel on pose 0 -------
    bake, live = slab_grad.bake_from_pyramid(
        tuple(p.detach().float() for p in tr.pyramid), tr.bmap,
        live_thresh=topt.sigma_thresh)
    geom = slab_render.FrameGeom(tr.grid, cams[0].transform, cams[0].fx,
                                 cams[0].fy, perm, flip, W, H, tr.opt, GI)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=D, bd=bd, fmt=int(tr.grid.fmt),
                            perm=perm, flip=flip, ids=ids, opt=tr.opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    gacc4 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, GI, GI)).astype(np.float32), device=dev)
    res = train_kernel_checks(torch, dev,
                              bake.permute(perm[0], 3, perm[1], perm[2]),
                              params, zb, gacc4, ids, cfg,
                              float(topt.stop_thresh), live)
    kern = {k: res[k] for k in ("MT", "MB", "MO")}
    log(f"ndc train kernels: M (training mode) {json.dumps(kern['MT'])}; "
        f"M-bwd {json.dumps(kern['MB'])}")
    del bake, live, res

    # ---- targets from the clean leaves, then corrupted leaves -------------
    def render(i):
        with torch.no_grad():
            c = cams[i]
            return slab_grad.render_frame_train(
                tr.pyramid, tr.bmap, tr.grid, c.transform, c.fx, c.fy,
                *groups[i], W, H, tr.opt, gi=GI)

    tgts = [render(i) for i in range(len(cams))]
    data = tr.data
    data[:, :D - 1] *= 0.15
    data[:, D - 1] *= torch.as_tensor(np.random.default_rng(0).uniform(
        0.6, 1.4, data.shape[0]).astype(np.float32), device=dev)
    bad = data.clone()

    def loss0():
        return float(slab_grad.loss_and_grad_frame(
            tr.pyramid, tr.bmap, tr.grid, cams[0].transform, cams[0].fx,
            cams[0].fy, *groups[0], W, H, tgts[0], tr.opt, gi=GI)[0])

    out = {"ndc_train_kernels": kern, "ndc_train_G": G}
    fits = [bool(slab_grad._precise_fits_host(
        tr.grid, c.transform, c.fx, c.fy, groups[i][0], W, H, GI)[0])
        for i, c in enumerate(cams)]
    log(f"ndc train: the precise warp's fit predicate per pose {fits}")
    for switch in (False, True):
        tag = f"ndc train (precise warp {'on' if switch else 'off'})"
        tr.data = bad.clone()
        tr.opt_state = tr.optimizer.init(tr.pyramid)
        before = loss0()
        display_warp._PRECISE_SQ = switch
        try:
            r = timed_steps(torch, tr, cams, tgts, tag)
        finally:
            display_warp._PRECISE_SQ = False
        after = loss0()
        c, n = r["counts"], r["steps"]
        n_fit = sum(fits[s % len(cams)]
                    for s in range(TRAIN_STEPS * len(cams))) * 2
        log(f"{tag}: pose 0's loss {before:.6f} -> {after:.6f}")
        if not (np.isfinite(after) and after < before):
            fail(f"{tag}: pose 0's loss did not fall ({before} -> {after})")
        if (c["march"] != n or c["march_bwd"] != n or c["bake"] != n
                or c["occupancy_live"] != n or c["occupancy"]
                or sum(c["plain"].values())):
            fail(f"{tag}: a step did not run exactly one launch of the "
                 f"bake kernel, kernels M and M-bwd and the occupancy's "
                 f"bits mode, and no plain version ({c})")
        precise = ((n_fit, n_fit, n_fit, n_fit, n - n_fit) if switch
                   else (0, 0, 0, 0, n))
        if (c["build_f32"], c["combine_f32"], c["combine_adj"],
                c["build_adj"], c["ref_warp_poses"]) != precise:
            fail(f"{tag}: the precise warp's launches or the reference "
                 f"warp's poses are not {precise} ({c})")
        key = "ndc_train_precise" if switch else "ndc_train"
        out.update({f"{key}_ms_synced": r["ms_synced"],
                    f"{key}_ms_pipelined": r["ms_pipelined"],
                    f"{key}_peak_gib": r["peak_gib"],
                    f"{key}_counts": c, f"{key}_loss0": [before, after]})
    del tr, tdev, tgts, data, bad
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 12: kernel M's display variants (the f16 bake, SG/ASG/RGBA trees,
# the viewer's render options)
# ---------------------------------------------------------------------------

#: the JSON line's rows of kernel M's display variants: (stats key, row
#: name, the variant whose launches the row counts)
VARIANT_ROWS = (
    ("M_bf16", "slab_march_display_bf16", "SH-bf16"),
    ("M_sg", "slab_march_display_sg", "SG-int8"),
    ("M_asg", "slab_march_display_asg", "ASG-int8"),
    ("M_rgba", "slab_march_display_rgba", "RGBA-int8"),
    ("M_opt", "slab_march_display_opt", "SH-int8-opt"),
    ("M_depth", "slab_march_display_depth", "SH-int8-opt-depth"),
)
FLOOR_DEPTH = 30.0     # the reference's slab-vs-exact depth floor
# the render_bbox frame's floor: the slab path masks voxels by their
# extent and box-filters the cut, where the exact renderer clips each ray,
# which costs the reference itself 12.4 dB against its exact renderer at
# G=16 (tests/test_torch_options.py::test_bbox_edge_loss_matches_the_reference;
# ROADMAP.md §3); this pose's frame read 44.555 dB on an H100, so the
# floor sits 4.5 dB under it, above the reference test's own 30 dB
# (tests/test_slab_render.py:689)
FLOOR_BBOX = 40.0
LOBE_SEED = 4          # the SG/ASG lobes of the format trees


def variant_ops(grid, opt):
    """(operations a shaded voxel, operations a marched (pixel, slab) pair,
    colour planes a shaded voxel reads) of a display variant, for its
    bound: SH 9*bd + 30 a voxel (march_bound's), SG ~14 and ASG ~20 a lobe
    (the lobe's dot products, exponential and 3 multiply-adds) + 30, RGBA
    ~10; the basis window counts its lobes only, rot adds 15; depth shades
    nothing past the sigma decode (~5) and taps one channel (~30 a pair
    against four channels' 60)."""
    from volrend_torch.models.data_format import BasisType
    bt = BasisType(grid.fmt)
    bd = grid.basis_dim
    if opt.render_depth:
        return (5, 30), 0
    if bt == BasisType.RGBA:
        return (10, 60), 3
    lo, hi = opt.basis_minmax
    n = len([k for k in range(bd) if lo <= k <= hi])
    per = {BasisType.SH: 9, BasisType.SG: 14, BasisType.ASG: 20}[bt]
    rot = 15 if any(float(v) != 0.0 for v in opt.rot_dirs) else 0
    return (per * n + 30 + rot, 60), 3 * n


def variant_check(torch, kernels, tag, grid, opt, cams, key, stats,
                  perm_flip=None, unit_slope_box=False, dir_win=True,
                  shade_bf16=False):
    """Kernel M's display variant of ``grid`` (its bake and format) and
    ``opt`` (its options) on the pose batch ``cams`` against its plain
    version (on up to PLAIN_POSES poses spread over the batch), with the
    launch's configuration and occupancy, its time on those poses beside
    their bound and the plain version's time, and the whole batch's time;
    the first check of a key gives its row's times and bound (the JSON
    line's), every check its largest max_abs_err. ``dir_win`` and
    ``shade_bf16``: the display knobs, for kernel and plain version alike
    (bf16 shading held within TOL_BF16_SHADE). Returns the row."""
    from volrend_torch.ops import slab_march, slab_render
    from volrend_torch.ops.render_exact import _rodrigues_matrix
    c0 = cams[0]
    if perm_flip is None:
        perm, flip, _ = slab_render.choose_axis(grid, c0.transform, c0.fx,
                                                c0.fy, W, H)
    else:
        perm, flip = perm_flip
    crop = slab_render.inplane_crop(grid, perm, float(opt.sigma_thresh))
    pay = slab_render.prepare_payload(grid, perm, opt)
    tr = torch.as_tensor(np.stack([c.transform for c in cams]),
                         dtype=torch.float32, device=grid.device)
    g = slab_render.FrameGeom(grid, tr, c0.fx, c0.fy, perm, flip, W, H, opt,
                              GI, unit_slope_box=unit_slope_box)
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip, opt)
    slab_ids = grid.slab_ids(perm[0], flip, opt.sigma_thresh)
    rotm = _rodrigues_matrix(opt.rot_dirs)
    kw = dict(fmt=int(grid.fmt), extra=grid.extra,
              depth=bool(opt.render_depth),
              rot=(None if rotm is None
                   else tuple(float(v) for v in rotm.reshape(-1))),
              bbox_full=slab_render._bbox_full(opt),
              basis_lo=int(opt.basis_minmax[0]),
              basis_hi=int(opt.basis_minmax[1]))
    m = slab_march.march_inputs(pay, params, zb, grid.G, GI, slab_ids,
                                slab_march._K_STEP if dir_win else 1, crop)
    bf16_shade = shade_bf16 and int(grid.fmt) == 1 and not kw["depth"]

    def run_m(prm=params, z=zb):
        return slab_march.march_slabs(
            pay, prm, grid.qscale, z, grid.G, GI, grid.data_dim,
            grid.basis_dim, perm, slab_ids=slab_ids, sig2=grid.quantized,
            flip=flip, dir_win=dir_win, shade_bf16=shade_bf16,
            k_per_step=slab_march._K_STEP, crop=crop, **kw)

    P = len(cams)
    sub = np.unique(np.linspace(0, P - 1, min(P, PLAIN_POSES)).round()
                    ).astype(np.int64).tolist()
    m_sub = dict(m, params=m["params"][sub], zb=m["zb"][sub])
    acc_k = run_m()
    torch.cuda.synchronize()
    cfg = dict(slab_march.march_slabs.display)
    acc_p, plain_ms = timed_once(torch, lambda: slab_march.march_slabs_ref(
        pay, grid.qscale, D=grid.data_dim, bd=grid.basis_dim, flip=flip,
        dir_win=dir_win, bf16_shade=bf16_shade, **kw, **m_sub))
    err, _, _ = freeze_flip_check(
        torch, f"{tag} [{cfg['variant']}], {P} poses (plain version on "
        f"poses {sub}), crop {crop}, {len(slab_ids)} slabs", acc_k[sub],
        acc_p, float(opt.stop_thresh),
        tol=TOL_BF16_SHADE if bf16_shade else TOL_M)
    occ = display_occupancy(kernels, grid.basis_dim, cfg)
    p_sub, z_sub = params[sub], zb[sub]
    ms = cuda_ms(torch, lambda: run_m(p_sub, z_sub), KREPS)
    ops, colour = variant_ops(grid, opt)
    okb = None
    if not kw["bbox_full"]:
        ycell = torch.arange(pay.shape[2], device=pay.device) + m["y0"]
        xcell = torch.arange(pay.shape[3], device=pay.device) + m["x0"]
        yc, xc = (ycell + 0.5) / grid.G, (xcell + 0.5) / grid.G
        h = 0.5 / grid.G
        okb = (((yc + h > g.lo[1]) & (yc - h < g.hi[1]))[:, None]
               & ((xc + h > g.lo[2]) & (xc - h < g.hi[2]))[None, :])
    bnd = march_bound(torch, pay, grid.qscale, m_sub["zb"], slab_ids, grid.G,
                      GI, grid.basis_dim, float(opt.sigma_thresh), ops=ops,
                      z_planes=4 if kw["depth"] else 3, D=grid.data_dim,
                      colour_planes=colour, okb=okb)
    whole_ms = cuda_ms(torch, run_m, KREPS) if P > len(sub) else ms
    row = stats.setdefault(key, {"max_abs_err": 0.0})
    if "ms" not in row:
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                   bound_by=bnd[1], library_ms=None, poses=len(sub),
                   variant=cfg["variant"], tag=tag)
    row["max_abs_err"] = max(row["max_abs_err"], err)
    log(f"kernel M [{tag}, {cfg['variant']}]: {len(sub)} poses {ms:.3f} ms "
        f"(bound {bnd[0]:.3f} ms, {bnd[1]}; plain {plain_ms:.1f} ms), "
        f"{P} poses {whole_ms:.3f} ms; launch {cfg}, on the card {occ}")
    stats.setdefault("M_variants", {})[tag] = {
        "variant": cfg["variant"], "poses": P, "ms": whole_ms,
        "sub_ms": ms, "bound_ms": bnd[0], "plain_ms": plain_ms,
        "max_abs_err": err, **occ, "rows": cfg["rows"]}
    del pay, acc_k, acc_p
    return row


def counted_render(torch, tag, fn, passes: int, world: bool, launched):
    """fn() (one render_image call of ``passes`` slab passes) with the
    launch counts and the plain versions' calls reset just before and
    read just after: kernel M once a pass, through display variants only
    (march_slabs.variants), no plain version, and on a world tree no B or
    C. Returns (frame, counts, variants)."""
    from volrend_torch.ops import slab_march
    calls = count_plain_calls()
    try:
        torch.cuda.synchronize()
        reset_counts()
        slab_march.march_slabs.variants = {}
        frame = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        variants = dict(slab_march.march_slabs.variants)
    finally:
        restore_plain()
    log(f"{tag}: counts {counts}, kernel M variants {variants}, plain "
        f"versions called {sum(calls.values())}")
    launched.update(variants)
    if (counts["march"] != passes or sum(variants.values()) != passes
            or any(calls.values())):
        fail(f"{tag}: not one kernel M launch a pass, or a plain version "
             f"ran ({counts}, {variants}, {calls})")
    if world and (counts["build"] or counts["combine"]):
        fail(f"{tag}: kernels B or C ran on a world tree ({counts})")
    if counts["warp_poses"] + counts["warp_mesh_poses"] + counts[
            "ref_warp_poses"] + counts["combine_poses"] != passes:
        fail(f"{tag}: a pass was not warped once ({counts})")
    return frame, counts, variants


def format_trees_on(torch, tdev, nb=None):
    """The dense bench tree's arrays read as SG16 and ASG16 trees (its leaf
    rows as lobe coefficients, the lobes drawn from LOBE_SEED as the
    reference's tests draw them, tests/test_slab_render.py:241-258 and
    :349-376) and as an RGBA tree (D = 4: each colour channel's first
    coefficient through a sigmoid, and sigma): {name: TreeArrays}. With
    ``nb``, the SG and ASG trees keep the first nb coefficients of each
    colour and sigma (D = 3 nb + 1) and draw nb lobes."""
    import dataclasses
    from volrend_torch.models.data_format import BasisType
    bd = tdev.basis_dim
    nb = bd if nb is None else nb
    rng = np.random.default_rng(LOBE_SEED)
    mu = rng.normal(size=(nb, 3))
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    sg = np.concatenate([rng.uniform(1.0, 6.0, (nb, 1)), mu], -1)
    asg = np.zeros((nb, 11))
    for i in range(nb):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        asg[i, 0] = rng.uniform(0.5, 4.0)
        asg[i, 1] = rng.uniform(0.5, 4.0)
        asg[i, 2:] = q.T.reshape(-1)
    dev = tdev.data.device
    D = tdev.data_dim
    lobe = tdev
    if nb != bd:
        keep = [c * bd + k for c in range(3) for k in range(nb)] + [D - 1]
        lobe = dataclasses.replace(
            tdev, data=tdev.data[:, keep].contiguous(), data_dim=3 * nb + 1,
            basis_dim=nb)
    rgba = torch.cat([torch.sigmoid(tdev.data[:, 0:3 * bd:bd].float()),
                      tdev.data[:, D - 1:D].float()], 1)
    return {
        "SG": dataclasses.replace(
            lobe, fmt=BasisType.SG,
            extra=torch.as_tensor(sg, dtype=torch.float32, device=dev)),
        "ASG": dataclasses.replace(
            lobe, fmt=BasisType.ASG,
            extra=torch.as_tensor(asg, dtype=torch.float32, device=dev)),
        "RGBA": dataclasses.replace(
            tdev, data=rgba.to(tdev.data.dtype).contiguous(), data_dim=4,
            basis_dim=-1, fmt=BasisType.RGBA),
    }


def variants_phase(torch, kernels, dev, opt, stats, gate, main_path,
                   groups_of, render_all):
    """Phase 12: kernel M's display variants at full width. (a) The f16
    route: the dense SH16 scene baked f16 (a bf16 payload), the 200 orbit
    poses through render_frames (RGBA8, gi=256) with every pose through
    the SH-bf16 variant and kernel W and nothing else, throughput and
    peak memory, the variant against its plain version on PLAIN_POSES of
    group 0 and pose 0 gated at >= FLOOR_ORBIT. (b) SG16, ASG16 and RGBA
    trees from the same leaves (format_trees_on), baked int8: each
    variant against its plain version on pose 0's group and render_image
    of pose 0 counted and gated at >= FLOOR_SPARSE. (c) On the dense int8
    grid, pose 0: render_depth, render_bbox, a basis window and rot_dirs,
    each against its plain version, counted and gated (colour >=
    FLOOR_SPARSE, depth >= FLOOR_DEPTH, the bbox >= FLOOR_BBOX). (d)
    bench.py's NDC pose in depth mode and with the viz options (>=
    FLOOR_DEPTH), and
    tools/perf_split.py's e = 0.5 sweep pose in depth mode (each class
    pass's M against its plain version; >= FLOOR_DEPTH). Returns the
    summary."""
    import collections
    import dataclasses
    from volrend_torch.ops import dense_grid, slab_march, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes import _common
    out = {}
    # each variant's launches in the counted runs (the main path's for
    # SH-bf16): the JSON line's counts
    launched = collections.Counter()
    t = time.perf_counter()
    tdev = _common.get_tree().to_device(lut_depth=None, device=dev)
    grid = dense_grid.bake_dense(tdev, dtype="f16")
    torch.cuda.synchronize()
    log(f"f16: uploaded + f16 bake G={grid.G} in "
        f"{time.perf_counter() - t:.1f} s ({grid.data.numel() * 2 / 1e9:.3f}"
        f" GB, D = {grid.data_dim})")
    cams = _common.orbit_poses(N_POSES)
    groups, pays, trs = groups_of(grid, cams)
    first = next(iter(groups.values()))
    variant_check(torch, kernels, "f16 orbit group 0", grid, opt,
                  [cams[i] for i in first], "M_bf16", stats)
    torch.cuda.empty_cache()
    calls = count_plain_calls()
    try:
        slab_march.march_slabs.variants = {}
        counts, frames, ms, peak = main_path("f16", grid, cams, groups, pays,
                                             trs)
    finally:
        restore_plain()
    variants = dict(slab_march.march_slabs.variants)
    n_runs = REPS + 1
    if (set(variants) != {"SH-bf16"}
            or variants["SH-bf16"] != n_runs * counts["march"]
            or any(calls.values())):
        fail(f"f16: the route's launches are not all SH-bf16 ({variants} "
             f"over {n_runs} runs of {counts['march']}), or a plain version "
             f"ran ({calls})")
    out["f16"] = {"ms": ms, "mrays": N_POSES * W * H / ms / 1e3,
                  "peak_gib": peak, "counts": counts}
    launched["SH-bf16"] += counts["march"]
    if "--profile" in sys.argv[1:]:
        _common.profile_run(
            lambda: render_all(grid, cams, groups, pays, trs),
            "f16 main path", log, DISPLAY_RANGES)
    out["f16"]["psnr_db"] = gate("f16 orbit0", tdev, cams[0], frames[0], 5,
                                 FLOOR_ORBIT)
    del frames, pays, trs, grid
    torch.cuda.empty_cache()

    # (b) the formats
    cam0 = cams[0]
    for fmt, tree in format_trees_on(torch, tdev).items():
        key = "M_" + fmt.lower()
        t = time.perf_counter()
        g = dense_grid.bake_dense(tree, dtype="int8")
        torch.cuda.synchronize()
        log(f"{fmt}: int8 bake G={g.G} in {time.perf_counter() - t:.1f} s")
        variant_check(torch, kernels, f"{fmt} orbit group 0", g, opt,
                      [cams[i] for i in first], key, stats)
        frame, counts, variants = counted_render(
            torch, fmt, lambda: slab_render.render_image(
                g, cam0, opt, gi=GI, out_dtype=torch.uint8), 1, True,
            launched)
        out[fmt] = {"counts": counts, "variants": variants,
                    "psnr_db": gate(f"{fmt} pose 0", tree, cam0,
                                    torch.as_tensor(frame, device=dev), 5,
                                    FLOOR_SPARSE)}
        del g, frame
        torch.cuda.empty_cache()

    # (c) the options, on the dense int8 grid
    grid = dense_grid.bake_dense(tdev, dtype="int8")
    options = (("depth", dict(render_depth=True), "M_depth", FLOOR_DEPTH),
               ("rot", dict(rot_dirs=(0.3, -0.2, 0.5)), "M_opt",
                FLOOR_SPARSE),
               ("window", dict(basis_minmax=(0, 8)), "M_opt", FLOOR_SPARSE),
               ("bbox", dict(render_bbox=(0.25,) * 3 + (0.75,) * 3),
                "M_opt", FLOOR_BBOX))
    for name, o, key, floor in options:
        vopt = dataclasses.replace(opt, **o)
        variant_check(torch, kernels, f"option {name}", grid, vopt, [cam0],
                      key, stats)
        frame, counts, _ = counted_render(
            torch, f"option {name}", lambda: slab_render.render_image(
                grid, cam0, vopt, gi=GI, out_dtype=torch.uint8), 1, True,
            launched)
        out[f"option_{name}"] = {
            "counts": counts,
            "psnr_db": gate(f"option {name}", tdev, cam0,
                            torch.as_tensor(frame, device=dev), 5, floor,
                            vopt)}
    # (d) the split sweep pose at e = 0.5, depth mode: every class pass
    scam = split_sweep_poses(Camera)[0]
    dopt = dataclasses.replace(opt, render_depth=True)
    classes = slab_render.split_classes(grid, scam.transform, scam.fx,
                                        scam.fy, W, H)
    for axis, flip in classes:
        perm = (axis, (axis + 1) % 3, (axis + 2) % 3)
        variant_check(torch, kernels, f"split depth pass {perm}/{flip}",
                      grid, dopt, [scam], "M_depth", stats,
                      perm_flip=(perm, flip), unit_slope_box=True)
    frame, counts, _ = counted_render(
        torch, "split depth", lambda: slab_render.render_image(
            grid, scam, dopt, gi=GI, out_dtype=torch.uint8), len(classes),
        True, launched)
    out["split_depth"] = {"classes": classes, "counts": counts,
                          "psnr_db": gate("split depth", tdev, scam,
                                          torch.as_tensor(frame, device=dev),
                                          8, FLOOR_DEPTH, dopt)}
    del grid, tdev, frame
    torch.cuda.empty_cache()

    # (d) bench.py's NDC pose: depth, and the viz options
    ntree = ndc_tree()
    ndev = ntree.to_device(lut_depth=None, device=dev)
    ngrid = dense_grid.bake_dense(ndev, dtype="int8")
    ncam = bench_ndc_pose(Camera)
    for name, o in (("depth", dict(render_depth=True)),
                    ("viz", dict(rot_dirs=(0.25, -0.15, 0.3),
                                 render_bbox=(0.1, 0.1, 0.0, 0.9, 0.9, 1.0),
                                 basis_minmax=(0, 2)))):
        vopt = dataclasses.replace(opt, **o)
        variant_check(torch, kernels, f"ndc {name}", ngrid, vopt, [ncam],
                      "M_depth" if name == "depth" else "M_opt", stats)
        frame, counts, _ = counted_render(
            torch, f"ndc {name}", lambda: slab_render.render_image(
                ngrid, ncam, vopt, gi=GI, out_dtype=torch.uint8), 1, False,
            launched)
        out[f"ndc_{name}"] = {
            "counts": counts,
            "psnr_db": gate(f"ndc {name}", ndev, ncam,
                            torch.as_tensor(frame, device=dev), 8,
                            FLOOR_DEPTH, vopt)}
    del ngrid, ndev
    torch.cuda.empty_cache()
    for key, _, name in VARIANT_ROWS:
        stats[key]["launches"] = launched[name]
    out["launched"] = dict(launched)
    log(f"variants: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 12b: the training pair's formats and options (SG, ASG and RGBA trees;
# rot_dirs, a basis window, a render_bbox) at the training bench's width
# ---------------------------------------------------------------------------

#: phase 12b's cases: (name, tree, render options); the trees are the
#: training bench's leaves read as SG9, ASG9, RGBA and SG6 (format_trees_on)
#: and the SH9 tree itself
TRAIN_CASES = (
    ("SG9", "SG", {}), ("ASG9", "ASG", {}), ("RGBA", "RGBA", {}),
    ("SG6", "SG6", {}),
    ("SH9-rot", "SH", dict(rot_dirs=(0.3, -0.2, 0.5))),
    ("SH9-window", "SH", dict(basis_minmax=(0, 3))),
    ("SH9-bbox", "SH", dict(render_bbox=(0.25,) * 3 + (0.75,) * 3)),
)
#: the kernels line's rows of phase 12b: kernel M's training mode and M-bwd
#: by format (their first case's numbers, every case's largest error) and
#: the bake kernel at its new widths
TRAIN_FAMILIES = {"SG9": "sg", "SG6": "sg", "ASG9": "asg", "RGBA": "rgba"}
TRAIN_VARIANT_ROWS = tuple(
    (f"{kind}_{fam}", f"{name}_{fam}", src, rep)
    for fam in ("sg", "asg", "rgba", "opt")
    for kind, name, src, rep in (
        ("MT", "slab_march_train", "volrend_torch/csrc/slab_march.cu",
         "volrend_tpu/ops/pallas_slab.py:344"),
        ("MB", "slab_march_bwd", "volrend_torch/csrc/slab_march_bwd.cu",
         "volrend_tpu/ops/pallas_slab.py:951"))) + tuple(
    (f"BK_{d}", f"bake_pyramid_d{d}", "volrend_torch/csrc/bake_pyramid.cu",
     "volrend_tpu/ops/slab_grad.py:244") for d in (19, 4))


def train_counts_ok(tag, counts, n, variant, precise=False):
    """A timed or counted run of n training steps: one launch a step of the
    bake kernel, the occupancy's bits mode, and kernels M and M-bwd in
    ``variant``, no full-read occupancy and no plain version; the precise
    warp's kernels a step with the switch on, the reference warp a step
    with it off."""
    c = counts
    if (c["march"] != n or c["march_bwd"] != n or c["bake"] != n
            or c["occupancy_live"] != n or c["occupancy"]
            or c["march_variants"] != {variant: n}
            or c["march_bwd_variants"] != {variant: n}
            or sum(c["plain"].values())):
        fail(f"{tag}: a step did not run exactly one launch of the bake "
             f"kernel, the occupancy's bits mode and kernels M and M-bwd "
             f"in {variant}, or a plain version ran ({c})")
    want = (n, n, n, n, 0) if precise else (0, 0, 0, 0, n)
    if (c["build_f32"], c["combine_f32"], c["combine_adj"], c["build_adj"],
            c["ref_warp_poses"]) != want:
        fail(f"{tag}: the precise warp's launches or the reference warp's "
             f"poses are not {want} ({c})")


def train_variant_case(torch, dev, stats, case, tdev, topt, cams,
                       lean=False, precise=False):
    """One case of phase 12b: FrameTrainer on ``tdev`` with ``topt``; the
    bake kernel against its plain versions; kernel M's training mode and
    M-bwd against theirs on pose 0 (the f32 bake, and with ``lean`` its
    bf16 cast), with their launches, times and bounds; from corrupted
    leaves (as phase 11 corrupts them) timed steps, counted (one launch of
    BK, the bits mode, M and M-bwd in the case's variant a step, no plain
    version), peak memory, and pose 0's loss must fall; with ``precise``,
    then one step with the precise warp's switch on, counted. Fills the
    kernels line's rows (TRAIN_VARIANT_ROWS); returns the case's
    summary."""
    from volrend_torch import train
    from volrend_torch.ops import display_warp, slab_grad, slab_render
    t = time.perf_counter()
    tr = train.FrameTrainer(tdev, opt=topt, lr=TRAIN_LR, gi=GI)
    G, D, bd = tr.grid.G, tr.grid.data_dim, tr.grid.basis_dim
    groups = {tr._group(c) for c in cams}
    if len(groups) != 1:
        fail(f"train {case}: the poses span {len(groups)} groups")
    (perm, flip), = groups
    log(f"train {case}: FrameTrainer G={G} D={D} "
        f"{tr.grid.fmt.name}{bd} in {time.perf_counter() - t:.1f} s")
    bk, bake, live = bake_checks(torch, tr, float(topt.sigma_thresh))
    geom = slab_render.FrameGeom(tr.grid, cams[0].transform, cams[0].fx,
                                 cams[0].fy, perm, flip, W, H, tr.opt, GI)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=D, bd=bd, fmt=int(tr.grid.fmt),
                            perm=perm, flip=flip, ids=ids, opt=tr.opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    gacc4 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, GI, GI)).astype(np.float32), device=dev)
    kern = {}
    for dt in (torch.float32, torch.bfloat16) if lean else (torch.float32,):
        pay = bake if dt == torch.float32 else bake.to(dt)
        res = train_kernel_checks(
            torch, dev, pay.permute(perm[0], 3, perm[1], perm[2]), params,
            zb, gacc4, ids, cfg, float(topt.stop_thresh), live,
            extra=tr.grid.extra)
        kern[str(dt)] = {k: res[k] for k in ("MT", "MB")}
        log(f"train {case} kernels [{dt}]: M (training mode) "
            f"{json.dumps(res['MT'])}; M-bwd {json.dumps(res['MB'])}")
        del pay, res
    del bake, live
    variant = kern["torch.float32"]["MT"]["variant"]
    torch.cuda.empty_cache()

    # ---- targets from the clean leaves, then corrupted leaves -------------
    def render(c):
        with torch.no_grad():
            return slab_grad.render_frame_train(
                tr.pyramid, tr.bmap, tr.grid, c.transform, c.fx, c.fy, perm,
                flip, W, H, tr.opt, gi=GI)

    tgts = [render(c) for c in cams]
    data = tr.data
    data[:, :D - 1] *= 0.15
    data[:, D - 1] *= torch.as_tensor(np.random.default_rng(0).uniform(
        0.6, 1.4, data.shape[0]).astype(np.float32), device=dev)
    tr.data = data
    tr.opt_state = tr.optimizer.init(tr.pyramid)
    del data

    def loss0():
        return float(slab_grad.loss_and_grad_frame(
            tr.pyramid, tr.bmap, tr.grid, cams[0].transform, cams[0].fx,
            cams[0].fy, perm, flip, W, H, tgts[0], tr.opt, gi=GI)[0])

    tag = f"train {case} ({variant})"
    before = loss0()
    r = timed_steps(torch, tr, cams, tgts, tag)
    after = loss0()
    log(f"{tag}: pose 0's loss {before:.6f} -> {after:.6f}")
    if not (np.isfinite(after) and after < before):
        fail(f"{tag}: pose 0's loss did not fall ({before} -> {after})")
    n = r["steps"]
    train_counts_ok(tag, r["counts"], n, variant)
    out = {"variant": variant, "G": G, "D": D, "kernels": kern,
           "ms_synced": r["ms_synced"], "ms_pipelined": r["ms_pipelined"],
           "peak_gib": r["peak_gib"], "counts": r["counts"],
           "loss0": [before, after]}
    if precise:  # one step with the precise warp's switch on
        calls = count_plain_calls()
        try:
            reset_train_counts()
            display_warp._PRECISE_SQ = True
            tr.step_frame(cams[0], tgts[0])
            torch.cuda.synchronize()
            c = read_train_counts(calls)
        finally:
            display_warp._PRECISE_SQ = False
            restore_plain()
        log(f"{tag}, the precise warp's switch on: one step, counts {c}")
        train_counts_ok(f"{tag} (precise warp)", c, 1, variant, precise=True)
        out["precise_counts"] = c
    fam = TRAIN_FAMILIES.get(case, "opt")
    for kind in ("MT", "MB"):
        row = stats.setdefault(f"{kind}_{fam}", {"max_abs_err": 0.0})
        if "ms" not in row:
            k32 = kern["torch.float32"][kind]
            row.update({k: k32[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
                       case=case, variant=variant, launches=r["counts"][
                           "march" if kind == "MT" else "march_bwd"])
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            k[kind]["max_abs_err"] for k in kern.values()])
    if D in (19, 4):
        stats[f"BK_{D}"] = dict(bk, launches=r["counts"]["bake"], case=case)
    del tr, tgts
    torch.cuda.empty_cache()
    return out


def train_variants_phase(torch, dev, stats):
    """Phase 12b: the training pair's formats and options at the training
    bench's width (tools/bench_train.py's scene: make_solid_tree(
    max_depth=7, basis_dim=9, seed=7), G=256, 800^2, gi=256, 4 orbit poses
    of one group, FrameTrainer(lr=5e-2)): its leaves read as SG9, ASG9,
    RGBA and SG6 trees (format_trees_on; SG6 takes D = 19, a run-time
    record width and a new bake width) and the SH9 tree with rot_dirs, a
    basis window and a render_bbox, each through train_variant_case (SG9
    also on the lean trainer's bf16 bake, and one step with the precise
    warp's switch on). Returns {case: summary}."""
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes import _common
    from volrend_torch.utils.options import RenderOptions
    topt = RenderOptions(max_steps=1024)
    tree = _common.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=DEPTH, basis_dim=9, seed=7))
    tdev = tree.to_device(lut_depth=None, device=dev)
    trees = dict(format_trees_on(torch, tdev), SH=tdev,
                 SG6=format_trees_on(torch, tdev, nb=6)["SG"])
    cams = train_orbit(Camera)
    out = {}
    for case, key, option in TRAIN_CASES:
        out[case] = train_variant_case(
            torch, dev, stats, case, trees[key], topt.replace(**option),
            cams, lean=case == "SG9", precise=case == "SG9")
    del trees, tdev, tree
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 12c: mesh overlays (kernel W's mesh-background mode), the display
# march's knobs (per-slab directions, bf16 SH shading) and codebook-quantized
# trees
# ---------------------------------------------------------------------------

#: the reference's 800^2 mesh floor (tests/test_slab_render.py:1031-1069),
#: which it sets at gi=448: a mesh frame's silhouettes are resolved on the
#: slope grid (the clip is nearest-sampled there and the warp blends
#: clipped and unclipped cells across the edge), so its PSNR rises with gi
#: (37.990 dB at gi=256 on pose 0, NVIDIA H100 80GB HBM3 700 W)
FLOOR_MESH = 38.0
GI_MESH = 448
#: a display knob's frame against the default frame (the reference's
#: per-slab gate, tests/test_slab_render.py:1076-1106)
FLOOR_KNOB = 50.0
#: the quantized phase's tree: the sparse scene compressed at the
#: compressor's defaults (its median cut over the dense scene's ~10^7 live
#: leaves would take ~10 minutes of host time)
CACHE_QUANT = os.path.join(HERE, ".torch_bench_sparse_quant_cache.npz")
QUANT_ROWS = 1_000_000      # leaves fetch_rows is held to the decode on
#: kernel W's mesh mode is checked at both production levels and one level
#: of its generic kernel
MESH_LEVELS = (((4, 4), (5, 5)), ((2, 2), (4, 4)), ((2, 4), (4, 5)))
#: the JSON line's rows of this phase's new kernel variants: (stats key,
#: row name, source, the TPU kernel it replaces)
OVERLAY_ROWS = (
    ("WM", "warp_display_mesh", "volrend_torch/csrc/warp_display.cu",
     "volrend_tpu/ops/display_warp.py:239"),
    ("M_dirslab", "slab_march_display_dirslab",
     "volrend_torch/csrc/slab_march_display.cu",
     "volrend_tpu/ops/pallas_slab.py:344"),
    ("M_bf16shade", "slab_march_display_bf16shade",
     "volrend_torch/csrc/slab_march_display.cu",
     "volrend_tpu/ops/pallas_slab.py:344"),
)


def mesh_cube(cam, scale=0.45, k=0.35):
    """The reference's 800^2 mesh test's cube (red, ``scale`` across, at
    ``k`` of the way from the origin to the camera: it occludes part of
    the volume and sits partly inside it)."""
    from volrend_torch.models.mesh import Mesh
    cube = Mesh.Cube((1.0, 0.1, 0.1))
    cube.scale = scale
    cube.translation = np.asarray(cam.center * k, np.float32)
    return cube


def mesh_gate(torch, tag, tdev, cam, frame, stride, floor, buf, opt):
    """``frame`` (H, W, 4) uint8 on the host against the exact renderer's
    rays composited over the mesh buffers ``buf`` (render_rays(tmax_bg=,
    bg_rgb=), the reference's composite_with_meshes contract) at
    ``stride``: rgb PSNR >= floor and alpha 255 on every sampled mesh
    pixel. Returns the PSNR."""
    from volrend_torch.ops import render_exact
    ys, xs = np.arange(0, H, stride), np.arange(0, W, stride)
    origins, dirs = cam.pixel_rays(xp=np)
    sel = (ys[:, None] * W + xs[None, :]).reshape(-1)
    t = time.perf_counter()
    exact = render_exact.render_rays(
        tdev, torch.as_tensor(np.ascontiguousarray(origins[sel])),
        torch.as_tensor(np.ascontiguousarray(dirs[sel])), opt,
        tmax_bg=np.ascontiguousarray(buf.dist.reshape(-1)[sel]),
        bg_rgb=np.ascontiguousarray(buf.color.reshape(-1, 3)[sel])
    ).cpu().numpy()
    got = np.asarray(frame).reshape(-1, 4)[sel].astype(np.float64) / 255.0
    hit = np.isfinite(buf.dist.reshape(-1)[sel])
    p = psnr(got[:, :3], exact[:, :3])
    log(f"{tag}: PSNR {p:.3f} dB vs exact rays over the mesh at stride "
        f"{stride} (floor {floor}; {int(hit.sum())} sampled mesh pixels; "
        f"exact rays in {time.perf_counter() - t:.1f} s)")
    if not (p >= floor and np.all(got[hit, 3] == 1.0)):
        fail(f"{tag}: PSNR {p:.3f} dB < {floor}, or a mesh pixel's alpha "
             "is not 255")
    return p


def mesh_warp_checks(torch, dev, grid, opt, cam, buf, stats):
    """Kernel W's mesh mode on orbit pose 0's own intermediate (the march
    clipped at the mesh) against its plain version at MESH_LEVELS in uint8
    and f32 (alpha 255 / 1 on every hit pixel); then at the production
    level its time against its bound, its plain version's and W's without
    the mesh on the same inputs. Returns the summary."""
    from volrend_torch.ops import display_warp, slab_march, slab_render
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, W, H)
    g = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                              flip, W, H, opt, GI, mesh_dist=buf.dist)
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip, opt)
    crop = slab_render.inplane_crop(grid, perm, float(opt.sigma_thresh))
    acc = slab_march.march_slabs(
        slab_render.prepare_payload(grid, perm, opt), params, grid.qscale,
        zb, grid.G, GI, grid.data_dim, grid.basis_dim, perm,
        slab_ids=grid.slab_ids(perm[0], flip, opt.sigma_thresh), sig2=True,
        flip=flip, bbox_full=True, dir_win=True, crop=crop)
    inter = slab_render._finalize_planar(acc, opt).contiguous()
    prm = display_warp.display_params(g.R, g.fx, g.fy, g.u0, g.du, g.v0,
                                      g.dv, g.scale, perm)
    mesh = display_warp.mesh_background(buf.dist, buf.color, 1, H, W, dev)
    hit = torch.as_tensor(np.isfinite(buf.dist), device=dev)
    sel = torch.zeros(1, dtype=torch.int32, device=dev)
    bgv = float(opt.background_brightness)
    row = stats.setdefault("WM", {"max_abs_err": 0.0})
    for B_, Wn in MESH_LEVELS:
        for od, tol, one in ((torch.uint8, TOL_C_U8, 255),
                             (torch.float32, TOL_C_F32, 1.0)):
            o_k = display_warp.warp_display(
                inter, prm, sel, torch.empty((1, H, W, 4), dtype=od,
                                             device=dev), B_, Wn, GI, bgv,
                mesh)
            o_p = display_warp.warp_display_ref(
                inter, prm, sel, torch.empty((1, H, W, 4), dtype=od,
                                             device=dev), B_, Wn, GI, bgv,
                mesh)
            torch.cuda.synchronize()
            err = float((o_k.float() - o_p.float()).abs().max())
            n = int((o_k != o_p).any(-1).sum())
            alpha_ok = bool(torch.all(o_k[0, ..., 3][hit] == one))
            log(f"kernel W mesh mode {B_}x{Wn} {od}: max err {err:.3e} "
                f"against its plain version (tol {tol}; {n} of {H * W} "
                f"pixels differ), alpha {one} on all {int(hit.sum())} mesh "
                f"pixels: {alpha_ok}")
            if not (np.isfinite(err) and err <= tol and alpha_ok):
                fail(f"kernel W's mesh mode disagrees at {B_}x{Wn} {od}")
            if od == torch.float32:
                row["max_abs_err"] = max(row["max_abs_err"], err)
    B_, Wn = MESH_LEVELS[0]
    out = torch.empty((1, H, W, 4), dtype=torch.uint8, device=dev)
    wm_ms = cuda_ms(torch, lambda: display_warp.warp_display(
        inter, prm, sel, out, B_, Wn, GI, bgv, mesh), KREPS)
    w_ms = cuda_ms(torch, lambda: display_warp.warp_display(
        inter, prm, sel, out, B_, Wn, GI, bgv), KREPS)
    plain_ms = cuda_ms(torch, lambda: display_warp.warp_display_ref(
        inter, prm, sel, out, B_, Wn, GI, bgv, mesh), 3)
    geom = (g.R, g.fx, g.fy, W, H, GI, perm, g.u0, g.du, g.v0, g.dv,
            g.scale)
    gys, gxs, okm, Y0, X0 = display_warp._level_geometry(geom, GI, B_, Wn)
    taps = tent_taps(torch, gys - Y0.float()[:, None],
                     gxs - X0.float()[:, None], okm, Wn)
    # W's bytes and work, and the background's 8 bytes a pixel
    bnd = bound(4 * GI * GI * 4 + H * W * 4 + H * W * 8 + 16 * 4 + 4,
                H * W * (30 + 20 + 6) + taps * 9)
    row.update(ms=wm_ms, plain_ms=plain_ms, bound_ms=bnd[0],
               bound_by=bnd[1], library_ms=None, no_mesh_ms=w_ms)
    log(f"kernel W mesh mode [{B_}x{Wn}, one pose, RGBA8]: {wm_ms:.4f} ms "
        f"(bound {bnd[0]:.4f} ms, {bnd[1]}; plain {plain_ms:.2f} ms); W "
        f"without the mesh on the same inputs {w_ms:.4f} ms")
    return {"wm_ms": wm_ms, "w_ms": w_ms, "wm_bound_ms": bnd[0]}


def mesh_phase(torch, dev, opt, stats, tdev, grid, host_tree, cams):
    """Phase 12c (a): mesh overlays on the dense int8 scene (G=256), 800^2,
    gi=256. Orbit pose 0 with mesh_cube: the host rasterizer's ms (median
    of 3), kernel W's mesh mode against its plain version
    (mesh_warp_checks), the counted render_image(meshes=[cube]) (one M,
    one fit-mode and one W-mesh launch; no B, C or reference warp; no
    plain version; alpha 255 on mesh pixels; its PSNR against the exact
    composite logged), render_frame's median of REPS on the buffers, and
    the frame at GI_MESH, the reference floor's own gi, >= FLOOR_MESH
    against the exact composite; then tools/perf_split.py's e = 0.5 pose
    with a cube (render_image counted: every class pass through W's mesh
    mode; at GI_MESH >= FLOOR_MESH), and pose 0 with
    ``opt.show_grid`` (the wireframe to grid_max_depth 2, counted, alpha
    on its pixels, its PSNR against the exact composite logged)."""
    import collections
    import dataclasses
    from volrend_torch.ops import display_warp, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.ops.composite import wireframe_mesh
    from volrend_torch.ops.rasterize import rasterize_meshes
    out = {}
    launched = collections.Counter()    # kernel M's variants, and W-mesh
    cam = cams[0]
    cube = mesh_cube(cam)
    ts = []
    for _ in range(3):
        t = time.perf_counter()
        buf = rasterize_meshes([cube], cam)
        ts.append((time.perf_counter() - t) * 1e3)
    hit = np.isfinite(buf.dist)
    out["raster_host_ms"] = float(np.median(ts))
    out["mesh_pixels"] = int(hit.sum())
    log(f"mesh pose 0: cube rasterized on the host in {ts} ms (median "
        f"{out['raster_host_ms']:.1f}); {out['mesh_pixels']} mesh pixels")
    if not 0 < out["mesh_pixels"] < H * W:
        fail("mesh pose 0: the cube covers no pixel, or every pixel")
    out.update(mesh_warp_checks(torch, dev, grid, opt, cam, buf, stats))

    def counted_mesh(tag, fn, passes):
        frame, counts, _ = counted_render(torch, tag, fn, passes, True,
                                          launched)
        if (counts["warp_mesh"] != passes or counts["warp"]
                or counts["ref_warp_poses"] or counts["fit"] != passes):
            fail(f"{tag}: not one fit-mode and one W-mesh launch a pass "
                 f"({counts})")
        launched["WM"] += counts["warp_mesh"]
        return frame, counts

    frame, counts = counted_mesh(
        "mesh pose 0", lambda: slab_render.render_image(
            grid, cam, opt, gi=GI, meshes=[cube], out_dtype=torch.uint8), 1)
    out["pose0_counts"] = counts
    out["pose0_gi256_psnr_db"] = mesh_gate(
        torch, f"mesh pose 0 (render_image, gi={GI})", tdev, cam, frame, 5,
        0.0, buf, opt)
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, W, H)
    pay = slab_render.prepare_payload(grid, perm, opt)
    ts = []
    for _ in range(REPS):
        t = time.perf_counter()
        slab_render.render_frame(grid, cam.transform, cam.fx, cam.fy, perm,
                                 flip, W, H, opt, GI, payload=pay,
                                 mesh_dist=buf.dist, mesh_rgb=buf.color,
                                 out_dtype=torch.uint8)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    out["render_frame_host_ms"] = float(np.median(ts))
    log(f"mesh pose 0: render_frame on the buffers {ts} ms (median "
        f"{out['render_frame_host_ms']:.2f}) beside the rasterizer's "
        f"{out['raster_host_ms']:.1f} ms")
    del pay
    frame = slab_render.render_frame(
        grid, cam.transform, cam.fx, cam.fy, perm, flip, W, H, opt, GI_MESH,
        mesh_dist=buf.dist, mesh_rgb=buf.color, out_dtype=torch.uint8)
    out["pose0_psnr_db"] = mesh_gate(
        torch, f"mesh pose 0 (render_frame, gi={GI_MESH})", tdev, cam,
        frame.cpu().numpy(), 5, FLOOR_MESH, buf, opt)

    scam = split_sweep_poses(Camera)[0]
    scube = mesh_cube(scam, scale=0.4, k=0.55)
    sbuf = rasterize_meshes([scube], scam)
    classes = slab_render.split_classes(grid, scam.transform, scam.fx,
                                        scam.fy, W, H)
    frame, counts = counted_mesh(
        "mesh split e=0.5", lambda: slab_render.render_image(
            grid, scam, opt, gi=GI, meshes=[scube], out_dtype=torch.uint8),
        len(classes))
    p256 = mesh_gate(torch, f"mesh split e=0.5 (render_image, gi={GI})",
                     tdev, scam, frame, 5, 0.0, sbuf, opt)
    frame = display_warp.to_display_dtype(slab_render.render_frame_split(
        grid, scam.transform, scam.fx, scam.fy, W, H, opt, gi=GI_MESH,
        mesh_dist=sbuf.dist, mesh_rgb=sbuf.color), torch.uint8)
    out["split"] = {"classes": classes, "counts": counts,
                    "mesh_pixels": int(np.isfinite(sbuf.dist).sum()),
                    "gi256_psnr_db": p256,
                    "psnr_db": mesh_gate(
                        torch, f"mesh split e=0.5 (gi={GI_MESH})", tdev,
                        scam, frame.cpu().numpy(), 5, FLOOR_MESH, sbuf,
                        opt)}

    # to depth 2: the default depth 4 draws 360,960 segments over 92 % of
    # the dense scene's frame, 48.5 s of host rasterizing (NVIDIA H100
    # 80GB HBM3 host, 700 W card)
    gopt = dataclasses.replace(opt, show_grid=True, grid_max_depth=2)
    t = time.perf_counter()
    wire = wireframe_mesh(host_tree, gopt.grid_max_depth)
    gbuf = rasterize_meshes([wire], cam)
    out["grid_host_s"] = time.perf_counter() - t
    frame, counts = counted_mesh(
        "show_grid pose 0", lambda: slab_render.render_image(
            grid, cam, gopt, gi=GI, host_tree=host_tree,
            out_dtype=torch.uint8), 1)
    ghit = np.isfinite(gbuf.dist)
    out["grid"] = {"segments": int(wire.faces.size // 2),
                   "wire_pixels": int(ghit.sum()), "counts": counts,
                   "host_s": out["grid_host_s"]}
    log(f"show_grid pose 0: wireframe to depth {gopt.grid_max_depth}: "
        f"{out['grid']['segments']} segments, {int(ghit.sum())} pixels, "
        f"built and rasterized in {out['grid_host_s']:.1f} s")
    if not (ghit.any() and np.all(frame[ghit][:, 3] == 255)):
        fail("show_grid pose 0: no wire pixel, or one with alpha below 255")
    out["grid"]["psnr_db"] = mesh_gate(torch, "show_grid pose 0", tdev, cam,
                                       frame, 5, 0.0, gbuf, gopt)
    stats["WM"]["launches"] = launched["WM"]
    out["launched"] = dict(launched)
    log(f"mesh: {json.dumps(out)}")
    return out


def knob_phase(torch, kernels, dev, opt, stats, gate, tdev, grids, cams,
               groups_of):
    """Phase 12c (b): the display march's knobs on orbit group 0 of the dense
    int8 grid and of the f16 route (``grids``: {name: grid}), with
    slab_march._DIR_WIN = False and then _BF16_SHADE = True: each variant
    against its plain version (variant_check: its time on PLAIN_POSES
    poses, its bound, the whole group's time) beside the default's in the
    same run, the group rendered with the switch flipped (counted: every
    launch in the knob's variant, one W launch, no plain version), pose
    0's frame against the default frame (>= FLOOR_KNOB) and against the
    exact renderer (>= FLOOR_ORBIT)."""
    import collections
    from volrend_torch.ops import slab_march, slab_render
    out = {}
    launched = collections.Counter()
    for name, grid in grids.items():
        groups, pays, trs = groups_of(grid, cams)
        first = next(iter(groups.values()))
        gcams = [cams[i] for i in first]
        perm, flip = next(iter(groups))
        tr, _ = trs[(perm, flip)]
        fx, fy = cams[0].fx, cams[0].fy

        def render():
            return slab_render.render_frames(
                grid, tr, fx, fy, perm, flip, W, H, opt, gi=GI,
                payload=pays[perm], out_dtype=torch.uint8)

        variant_check(torch, kernels, f"{name} knobs default", grid, opt,
                      gcams, f"M_knobbase_{name}", stats)
        base_ms = stats["M_variants"][f"{name} knobs default"]["ms"]
        base_frame = render()
        for knob, attr, val, key, suffix in (
                ("dirslab", "_DIR_WIN", False, "M_dirslab", "-dirslab"),
                ("bf16shade", "_BF16_SHADE", True, "M_bf16shade",
                 "-bf16shade")):
            tag = f"{name} {knob}"
            variant_check(torch, kernels, tag, grid, opt, gcams, key, stats,
                          dir_win=val if attr == "_DIR_WIN" else True,
                          shade_bf16=val if attr == "_BF16_SHADE" else False)
            v = stats["M_variants"][tag]
            calls = count_plain_calls()
            setattr(slab_march, attr, val)
            try:
                torch.cuda.synchronize()
                reset_counts()
                slab_march.march_slabs.variants = {}
                frames = render()
                torch.cuda.synchronize()
                counts = read_counts()
                variants = dict(slab_march.march_slabs.variants)
            finally:
                setattr(slab_march, attr, not val)
                restore_plain()
            log(f"{tag}: counts {counts}, kernel M variants {variants}, "
                f"plain versions called {sum(calls.values())}")
            variant = next(iter(variants), "")
            if (counts["march"] != 1 or len(variants) != 1
                    or not variant.endswith(suffix)
                    or counts["warp_poses"] != len(first)
                    or any(calls.values())):
                fail(f"{tag}: the group did not take the {knob} variant "
                     f"once and kernel W ({counts}, {variants})")
            launched[key] += 1
            f0, b0 = frames[0].float() / 255.0, base_frame[0].float() / 255.0
            mse = float(((f0[..., :3] - b0[..., :3]) ** 2).mean())
            p_base = 99.0 if mse < 1e-12 else -10.0 * np.log10(mse)
            log(f"{tag}: pose 0 {p_base:.3f} dB against the default frame "
                f"(floor {FLOOR_KNOB}); kernel M on the group of "
                f"{len(first)} {v['ms']:.3f} ms against the default's "
                f"{base_ms:.3f} ms")
            if not p_base >= FLOOR_KNOB:
                fail(f"{tag}: {p_base:.3f} dB from the default frame")
            out[tag] = {"variant": variant, "counts": counts,
                        "group_ms": v["ms"], "sub_ms": v["sub_ms"],
                        "default_group_ms": base_ms,
                        "vs_default_db": p_base,
                        "psnr_db": gate(tag, tdev, cams[0], frames[0], 5,
                                        FLOOR_ORBIT)}
            del frames
        del pays, trs, base_frame
        torch.cuda.empty_cache()
    for key in ("M_dirslab", "M_bf16shade"):
        stats[key]["launches"] = stats[key].get("launches", 0) + launched[key]
    log(f"knobs: {json.dumps(out)}")
    return out


def quant_tree(tree_path: str):
    """The compressed sparse scene (CACHE_QUANT: compress_tree at its
    defaults, bits 16) and the host seconds it took (0 from the cache)."""
    from volrend_torch.compress import compress_tree
    if os.path.isfile(CACHE_QUANT):
        return CACHE_QUANT, 0.0
    t = time.perf_counter()
    with np.load(tree_path, allow_pickle=False) as f:
        z = compress_tree(dict(f.items()))
    np.savez(CACHE_QUANT, **z)
    return CACHE_QUANT, time.perf_counter() - t


def quant_phase(torch, dev, opt, stats, gate, groups_of):
    """Phase 12c (c): a codebook-quantized tree, the sparse scene compressed at
    the compressor's defaults (bits 16; set-up, its host seconds logged).
    QuantLeaves on the card (its device bytes against the decoded tree's
    dense leaves); fetch_rows bit-equal to the host decode's rows on
    QUANT_ROWS random leaves; the int8 bake of the QuantLeaves tree
    bit-equal to the decode's (codes, qscale, occupancy); one orbit group
    through render_frames, counted (kernel M and W only); pose 0 against
    the exact renderer on the same QuantLeaves tree (>= FLOOR_SPARSE, the
    scene's floor)."""
    from volrend_torch.models.n3tree import N3Tree
    from volrend_torch.models.quantized import (load_quantized,
                                                to_device_quantized)
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import dense_grid, slab_render
    from volrend_torch.probes import _common
    _common.load_tree(CACHE_SPARSE, lambda: make_solid_tree(
        max_depth=DEPTH, basis_dim=BASIS_DIM, seed=3))
    path, secs = quant_tree(CACHE_SPARSE)
    out = {"compress_host_s": secs}
    t = time.perf_counter()
    qdev = to_device_quantized(load_quantized(path), lut_depth=None,
                               device=dev)
    host = N3Tree(path)
    hdev = host.to_device(lut_depth=None, device=dev)
    torch.cuda.synchronize()
    leaves = qdev.data
    out["quant_bytes"] = leaves.nbytes()
    out["dense_bytes"] = host.n_cells * host.data_dim * 2
    log(f"quant: sparse scene compressed in {secs:.1f} s (0: from the "
        f"cache), {leaves.n_q} codebooks of {leaves.codebooks.shape[1]} "
        f"codes, {leaves.n_retain} retained; uploaded with its decode in "
        f"{time.perf_counter() - t:.1f} s; QuantLeaves "
        f"{out['quant_bytes'] / 2**20:.1f} MiB on the card against "
        f"{out['dense_bytes'] / 2**20:.1f} MiB of dense f16 leaves")
    D = host.data_dim
    idx = torch.randint(0, host.n_cells, (QUANT_ROWS,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    if not torch.equal(leaves.fetch_rows(idx), hdev.data[idx, :D]):
        fail("quant: fetch_rows differs from the host decode's rows")
    gq = dense_grid.bake_dense(qdev, dtype="int8")
    gh = dense_grid.bake_dense(hdev, dtype="int8")
    if not (torch.equal(gq.data, gh.data) and torch.equal(gq.qscale,
                                                         gh.qscale)
            and gq.occ_max == gh.occ_max):
        fail("quant: the bake of the QuantLeaves tree differs from the "
             "decode's")
    log(f"quant: fetch_rows bit-equal to the decode on {QUANT_ROWS} leaves; "
        f"int8 bake G={gq.G} bit-equal (codes, qscale, occupancy)")
    del gh
    cams = _common.orbit_poses(N_POSES, width=W, height=H)
    groups, pays, trs = groups_of(gq, cams)
    (perm, flip), first = next(iter(groups.items()))
    tr, _ = trs[(perm, flip)]
    calls = count_plain_calls()
    try:
        torch.cuda.synchronize()
        reset_counts()
        frames = slab_render.render_frames(
            gq, tr, cams[0].fx, cams[0].fy, perm, flip, W, H, opt, gi=GI,
            payload=pays[perm], out_dtype=torch.uint8)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        restore_plain()
    log(f"quant group 0 ({len(first)} poses): counts {counts}, plain "
        f"versions called {sum(calls.values())}")
    if (counts["march"] != 1 or counts["warp_poses"] != len(first)
            or counts["build"] or counts["combine"]
            or counts["ref_warp_poses"] or any(calls.values())):
        fail(f"quant: the group did not take kernels M and W alone "
             f"({counts})")
    out["counts"] = counts
    out["psnr_db"] = gate("quant pose 0", qdev, cams[0], frames[0], 5,
                          FLOOR_SPARSE)
    del frames, pays, trs, gq, hdev, qdev
    torch.cuda.empty_cache()
    log(f"quant: {json.dumps(out)}")
    return out


def overlay_phase(torch, kernels, dev, opt, stats, gate, groups_of):
    """Phase 12c: mesh_phase and knob_phase on the dense scene (int8, then
    the f16 route for the knobs), then quant_phase."""
    from volrend_torch.ops import dense_grid
    from volrend_torch.probes import _common
    host_tree = _common.get_tree()
    tdev = host_tree.to_device(lut_depth=None, device=dev)
    grid = dense_grid.bake_dense(tdev, dtype="int8")
    cams = _common.orbit_poses(N_POSES, width=W, height=H)
    out = {"mesh": mesh_phase(torch, dev, opt, stats, tdev, grid, host_tree,
                              cams)}
    out["knobs"] = knob_phase(torch, kernels, dev, opt, stats, gate, tdev,
                              {"int8": grid}, cams, groups_of)
    del grid
    torch.cuda.empty_cache()
    f16 = dense_grid.bake_dense(tdev, dtype="f16")
    out["knobs"].update(knob_phase(torch, kernels, dev, opt, stats, gate,
                                   tdev, {"f16": f16}, cams, groups_of))
    del f16, tdev
    torch.cuda.empty_cache()
    out["quant"] = quant_phase(torch, dev, opt, stats, gate, groups_of)
    return out


# ---------------------------------------------------------------------------
# Phase 12d: T2 ray-batch training (Trainer: the exact march and its fused
# re-march VJP, ops/grad.py) and the headless batch renderer (cli/headless)
# ---------------------------------------------------------------------------

T2_BATCHES = (1024, 8192)     # examples/train_demo.py's batch, and 8x it
T2_STEPS = 12                 # timed Trainer.step calls per batch size
T2_WARM = 2                   # untimed steps before them
T2_MAX_STEPS = 512            # examples/train_demo.py's RenderOptions
T2_NOISE = 0.35               # tests/test_train.py:40-45's corruption
T2_LR = 5e-2
T2_HELD = 8192                # rays of the held-out batch
T2_GRAD_RAYS = 256
T2_FD_COORDS = 5
T2_FD_EPS = 3e-3              # tools/config_report.py's config2 step
T2_GRAD_ATOL = 3e-3           # times max|g| (tests/test_grad.py)
T2_GRAD_RTOL = 2e-3
T2_MAX_REL = 1e-3             # config2's pass: fused vs autodiff
T2_MAX_FD = 5e-2              # config2's pass: median FD relative error
DEMO2_POSES = 10              # examples/train_demo.py
DEMO2_SIZE = 64
DEMO2_STEPS = 150
DEMO2_BATCH = 1024
DEMO2_NOISE = 0.4
DEMO2_RATIO = 0.35            # tests/test_train.py:68's recovery ratio
HEADLESS_POSES = 16
FLOOR_ORACLE = 60.0
HEADLESS_DIR = os.path.join(HERE, "build", "smoke_headless")


def demo_scene(dev):
    """examples/train_demo.py's scene on ``dev``: the depth-4 SH9 test tree,
    full-depth LUT, its 10 orbit poses at 64^2 (fx 80)."""
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops.camera import Camera
    tree = make_test_tree(max_depth=4, basis_dim=9, seed=11,
                          sigma_scale=50.0)
    cams = []
    for th in np.linspace(0, 2 * np.pi, DEMO2_POSES, endpoint=False):
        b = np.array([np.cos(th), np.sin(th), 0.45])
        b /= np.linalg.norm(b)
        cams.append(Camera.from_vectors(center=tuple(2.6 * b),
                                        v_back=tuple(b), width=DEMO2_SIZE,
                                        height=DEMO2_SIZE, fx=80.0))
    return tree.to_device(lut_depth=None, device=dev), cams


def sync_count(torch, fn):
    """(fn(), the synchronizing CUDA operations it made): the warnings of
    torch.cuda's sync debug mode."""
    import warnings
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(x.message) for x in w)


def t2_grad_checks(torch, dev):
    """The fused gradient on the card against autograd through the
    fixed-length loop (tests/test_grad.py's tolerance) and PARITY.md's
    config2 numbers, on T2_GRAD_RAYS rays of the demo scene."""
    import dataclasses
    from volrend_torch.ops import grad as grad_mod, render_exact
    from volrend_torch.utils.options import RenderOptions
    tdev, cams = demo_scene(dev)
    dopt = RenderOptions(max_steps=T2_MAX_STEPS, renormalize=False)
    rng = np.random.default_rng(5)
    rays = [c.pixel_rays(xp=np) for c in cams]
    k = rng.integers(0, len(cams), T2_GRAD_RAYS)
    px = rng.integers(0, DEMO2_SIZE * DEMO2_SIZE, T2_GRAD_RAYS)
    o = torch.as_tensor(np.stack([rays[a][0][b] for a, b in zip(k, px)]),
                        device=dev)
    d = torch.as_tensor(np.stack([rays[a][1][b] for a, b in zip(k, px)]),
                        device=dev)
    tgt = torch.as_tensor(rng.uniform(0, 1, (T2_GRAD_RAYS, 4)).astype(
        np.float32), device=dev)
    data32 = tdev.data.float()
    loss_f, g_f = grad_mod.l2_loss_and_grad(tdev, o, d, tgt, dopt,
                                            data=data32)
    dat = data32.clone().requires_grad_(True)
    out = render_exact.render_rays(dataclasses.replace(tdev, data=dat), o,
                                   d, dopt, differentiable=True,
                                   n_steps=T2_MAX_STEPS)
    loss_a = torch.mean((out[:, :3] - tgt[:, :3]) ** 2)
    loss_a.backward()
    g_f, g_a = g_f.cpu().numpy(), dat.grad.cpu().numpy()
    scale = float(np.abs(g_a).max())
    err = np.abs(g_f - g_a)
    ok = bool(np.all(err <= T2_GRAD_ATOL * scale
                     + T2_GRAD_RTOL * np.abs(g_a)))
    rel = float(err.max() / max(scale, 1e-12))

    def loss_fused(dat):
        with torch.no_grad():
            out = grad_mod.render_rays_train(tdev, o, d, dopt, data=dat)
            return float(torch.mean((out[:, :3] - tgt[:, :3]) ** 2))

    fd_errs = []
    for idx in np.argsort(-np.abs(g_f).ravel())[:T2_FD_COORDS]:
        i, j = np.unravel_index(idx, g_f.shape)
        dp, dm = data32.clone(), data32.clone()
        dp[i, j] += T2_FD_EPS
        dm[i, j] -= T2_FD_EPS
        fd = (loss_fused(dp) - loss_fused(dm)) / (2 * T2_FD_EPS)
        fd_errs.append(abs(fd - float(g_f[i, j])) / max(abs(fd), 1e-9))
    fd_med = float(np.median(fd_errs))
    log(f"T2 gradient [{T2_GRAD_RAYS} rays of the demo scene]: fused loss "
        f"{float(loss_f):.8f}, autograd {float(loss_a.detach()):.8f}; max|g| "
        f"{scale:.4e}, max|fused - autograd| {float(err.max()):.4e} "
        f"(atol {T2_GRAD_ATOL} x max|g|, rtol {T2_GRAD_RTOL}: "
        f"{'within' if ok else 'OUTSIDE'}); config2: fused_vs_autodiff_max_"
        f"rel {rel:.4e}, finite_diff_median_rel_err {fd_med:.4e} over the "
        f"{T2_FD_COORDS} largest-|grad| coordinates (eps {T2_FD_EPS}; "
        f"each {[round(e, 6) for e in fd_errs]})")
    if not (ok and rel < T2_MAX_REL and fd_med < T2_MAX_FD
            and np.isclose(float(loss_f), float(loss_a.detach()),
                           rtol=1e-5)):
        fail("T2: the fused gradient disagrees with autograd or finite "
             "differences")
    return {"t2_fused_vs_autodiff_max_rel": rel,
            "t2_finite_diff_median_rel_err": fd_med}


def t2_recovery(torch, dev):
    """(b) examples/train_demo.py's configuration: corrupted leaves (noise
    DEMO2_NOISE, seed 0), Trainer(lr 5e-2), DEMO2_STEPS steps of
    DEMO2_BATCH rays over the 10 poses; pose 0's loss must end at most
    DEMO2_RATIO of its start."""
    import dataclasses
    from volrend_torch import train
    from volrend_torch.ops import render_exact
    from volrend_torch.utils.options import RenderOptions
    tdev, cams = demo_scene(dev)
    dopt = RenderOptions(max_steps=T2_MAX_STEPS, renormalize=False)
    targets = [render_exact.render_image(tdev, c, dopt) for c in cams]
    rng = np.random.default_rng(0)
    noisy = (tdev.data.float().cpu().numpy()
             + rng.normal(0, DEMO2_NOISE, tuple(tdev.data.shape)
                          ).astype(np.float32))
    tr = train.Trainer(dataclasses.replace(
        tdev, data=torch.as_tensor(noisy, dtype=torch.float16, device=dev)),
        dopt, lr=T2_LR)
    rays = [tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                  for x in c.pixel_rays(xp=np)) for c in cams]

    def pose0():
        img = render_exact.render_image(tr.current_tree(), cams[0], dopt)
        mse = float(torch.mean((img[..., :3] - targets[0][..., :3]) ** 2))
        return mse, 99.0 if mse < 1e-12 else -10.0 * float(np.log10(mse))

    l0, p0 = pose0()
    losses = []
    t0 = time.perf_counter()
    for it in range(DEMO2_STEPS):
        k = it % len(cams)
        sel = torch.as_tensor(rng.integers(0, DEMO2_SIZE * DEMO2_SIZE,
                                           DEMO2_BATCH), device=dev)
        losses.append(tr.step(rays[k][0][sel], rays[k][1][sel],
                              targets[k].reshape(-1, 4)[sel]))
    secs = time.perf_counter() - t0
    l1, p1 = pose0()
    log(f"T2 recovery (examples/train_demo.py: {DEMO2_POSES} poses at "
        f"{DEMO2_SIZE}^2, {DEMO2_BATCH}-ray batches, noise {DEMO2_NOISE}, "
        f"lr {T2_LR}, {DEMO2_STEPS} steps in {secs:.2f} s): pose 0 loss "
        f"{l0:.6f} -> {l1:.6f} (ratio {l1 / l0:.4f}, gate "
        f"{DEMO2_RATIO}), PSNR {p0:.3f} -> {p1:.3f} dB; step losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    if not (np.all(np.isfinite(losses)) and l1 <= DEMO2_RATIO * l0):
        fail(f"T2 recovery: pose 0's loss {l0:.6f} -> {l1:.6f}, above "
             f"{DEMO2_RATIO} of its start")
    return {"t2_recovery_loss_ratio": l1 / l0, "t2_recovery_psnr_db":
            [p0, p1], "t2_recovery_seconds": secs}


def t2_phase(torch, dev):
    """Phase 12d (a) and (b): T2 ray-batch training at the training bench's
    width (the depth-7 SH9 solid tree, full-depth LUT), then the gradient
    checks and the recovery gate on the demo scene."""
    import dataclasses
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import grad as grad_mod, render_exact
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes import _common
    from volrend_torch.utils.options import RenderOptions

    topt = RenderOptions(max_steps=T2_MAX_STEPS, renormalize=False)
    tree = _common.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=DEPTH, basis_dim=9, seed=7))
    clean = tree.to_device(lut_depth=None, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    noisy = dataclasses.replace(clean, data=(
        clean.data.float() + T2_NOISE * torch.randn(
            tuple(clean.data.shape), generator=gen, device=dev)
    ).to(torch.float16))
    cams = train_orbit(Camera)
    rays = [c.pixel_rays(xp=np) for c in cams]
    rng = np.random.default_rng(7)

    def batch(n):
        """n rays drawn from the 4 poses; the clean tree's exact render of
        them as the target; all on the card."""
        k = rng.integers(0, len(cams), n)
        px = rng.integers(0, W * H, n)
        o = torch.as_tensor(np.stack([rays[a][0][b] for a, b in zip(k, px)]),
                            device=dev)
        d = torch.as_tensor(np.stack([rays[a][1][b] for a, b in zip(k, px)]),
                            device=dev)
        return o, d, render_exact.render_rays(clean, o, d, topt)

    held = batch(T2_HELD)

    def held_loss(tr):
        with torch.no_grad():
            out = grad_mod.render_rays_train(tr.tree, held[0], held[1],
                                             tr.opt, data=tr.data)
            return float(torch.mean((out[:, :3] - held[2][:, :3]) ** 2))

    out = {"t2_leaves": int(clean.data.shape[0])}
    for n in T2_BATCHES:
        batches = [batch(n) for _ in range(T2_WARM + T2_STEPS + 3)]
        tr = train.Trainer(noisy, topt, lr=T2_LR)
        h0 = held_loss(tr)
        for b in batches[:T2_WARM]:
            tr.step(*b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, iters, losses = [], [], []
        for b in batches[T2_WARM:T2_WARM + T2_STEPS]:
            render_exact.reset_march_counts()
            t0 = time.perf_counter()
            losses.append(tr.step(*b))
            ms.append((time.perf_counter() - t0) * 1e3)
            iters.append(dict(render_exact.march_counts))
        peak = torch.cuda.max_memory_allocated() / 2**30
        render_exact.reset_march_counts()
        _, n_sync = sync_count(torch, lambda: tr.step(*batches[-3]))
        counted = dict(render_exact.march_counts)
        render_exact.reset_march_counts()
        prof = _common.profile_run(lambda: tr.step(*batches[-2]),
                                   f"T2 step, {n} rays", log)
        traced = dict(render_exact.march_counts)
        n_kern = sum(v[1] for v in prof.values())
        per_iter = n_kern / max(1, traced["fwd"] + traced["bwd"])
        h1 = held_loss(tr)
        med = float(np.median(ms))
        fwd = [c["fwd"] for c in iters]
        bwd = [c["bwd"] for c in iters]
        syn = [c["syncs"] for c in iters]
        log(f"T2 Trainer.step [{n} rays, {len(clean.data)} leaves, {W}x{H} "
            f"orbit rays]: median {med:.2f} ms over {T2_STEPS} steps "
            f"({n / med:.1f} krays/s), steps (ms) "
            f"{[round(x, 2) for x in ms]}; peak {peak:.3f} GiB allocated; "
            f"march iterations forward {fwd}, backward {bwd}; the march's "
            f"host syncs {syn} a step (every "
            f"{render_exact.ACTIVE_CHECK_EVERY} iterations, each way, plus "
            f"the loss); sync debug mode counted {n_sync} synchronizing "
            f"operations in one step ({counted}); the traced step launched "
            f"{n_kern} kernels over {traced['fwd']} + {traced['bwd']} "
            f"iterations ({per_iter:.1f} a iteration); held-out loss "
            f"{h0:.6f} -> {h1:.6f}; step losses "
            f"{[round(x, 6) for x in losses]}")
        if not (np.all(np.isfinite(losses)) and h1 < h0):
            fail(f"T2 [{n} rays]: the held-out loss did not fall "
                 f"({h0:.6f} -> {h1:.6f})")
        out[f"t2_{n}"] = {
            "median_ms": med, "step_ms": ms, "peak_gib": peak,
            "fwd_iterations": fwd, "bwd_iterations": bwd,
            "march_syncs": syn, "sync_debug_syncs": n_sync,
            "kernels_per_iteration": per_iter, "held_loss": [h0, h1]}
        del tr, batches
        torch.cuda.empty_cache()
    del clean, noisy
    torch.cuda.empty_cache()
    out.update(t2_grad_checks(torch, dev))
    out.update(t2_recovery(torch, dev))
    return out


def _write_pose(path, transform) -> None:
    c2w = np.eye(4)
    c2w[:3] = np.asarray(transform, np.float64).reshape(3, 4)
    np.savetxt(path, c2w)


def _write_intrin(path, f) -> None:
    k = np.eye(4)
    k[0, 0] = k[1, 1] = f
    np.savetxt(path, k)


def _headless(torch, argv, subprocess_run: bool):
    """One headless run (``python -m volrend_torch.cli.headless argv``) as
    a subprocess or in this process; returns (ms per frame, fps, stderr)."""
    import io
    from volrend_torch.cli import headless
    if subprocess_run:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (HERE, env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m",
                              "volrend_torch.cli.headless", *argv],
                             cwd=HERE, env=env, capture_output=True,
                             text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"headless {argv[-4:]} exited {res.returncode}: "
                 f"{res.stderr[-3000:]}")
        out, err = res.stdout, res.stderr
    else:
        so, se = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = headless.main(list(argv))
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"headless {argv[-4:]} returned {rc}")
        out, err = so.getvalue(), se.getvalue()
    vals = {}
    for line in out.splitlines():
        for key in ("ms per frame", "fps"):
            if line.strip().endswith(key):
                vals[key] = float(line.split()[0])
    if len(vals) != 2:
        fail(f"headless {argv[-4:]}: no ms per frame / fps in {out!r}")
    return vals["ms per frame"], vals["fps"], err.strip(), wall


def headless_phase(torch, dev):
    """Phase 12d (c): the headless batch renderer on the dense bench scene
    (its npz cache, written by N3Tree.save_npz): HEADLESS_POSES orbit poses
    and tools/perf_split.py's e = 0.5 sweep pose as 4x4 txt files, each
    with its intrinsics txt, through ``--renderer slab`` as subprocesses;
    the PNGs against render_frames / render_frame_split; a counted
    in-process run; ``--renderer exact`` at scale 0.25 against
    render_image; ``--renderer oracle`` on a small tree against the exact
    renderer."""
    import shutil
    from volrend_torch.cli import headless, opts
    from volrend_torch.models.synthetic import make_test_tree
    from volrend_torch.ops import dense_grid, render_exact, slab_render
    from volrend_torch.ops.camera import Camera, poses_from_files, read_intrins
    from volrend_torch.probes import _common
    from volrend_torch.utils.png import read_png, rgba_to_bytes

    shutil.rmtree(HEADLESS_DIR, ignore_errors=True)
    os.makedirs(HEADLESS_DIR)
    _common.get_tree()                           # writes the npz cache
    tree_path = _common.CACHE
    cams = _common.orbit_poses(HEADLESS_POSES)
    poses = []
    for i, c in enumerate(cams):
        poses.append(os.path.join(HEADLESS_DIR, f"orbit_{i:03d}.txt"))
        _write_pose(poses[-1], c.transform)
    intrin = os.path.join(HEADLESS_DIR, "intrin.txt")
    _write_intrin(intrin, cams[0].fx)
    scam = split_sweep_poses(Camera)[0]
    split_pose = os.path.join(HEADLESS_DIR, "split_e05.txt")
    _write_pose(split_pose, scam.transform)
    split_intrin = os.path.join(HEADLESS_DIR, "intrin_split.txt")
    _write_intrin(split_intrin, scam.fx)
    common = ["-W", str(W), "-H", str(H), "--device", str(dev)]
    out_dir = os.path.join(HEADLESS_DIR, "slab")
    res = {}
    ms, fps, err, wall = _headless(
        torch, [tree_path, *poses, "-i", intrin, *common, "--renderer",
                "slab", "-o", out_dir], True)
    log(f"headless slab [{HEADLESS_POSES} orbit poses, subprocess, wall "
        f"{wall:.1f} s]: {ms:.3f} ms per frame, {fps:.3f} fps; {err}")
    res.update(headless_slab_ms=ms, headless_slab_fps=fps,
               headless_slab_wall_s=wall)
    ms2, fps2, err2, wall2 = _headless(
        torch, [tree_path, split_pose, "-i", split_intrin, *common,
                "--renderer", "slab", "-o", out_dir], True)
    log(f"headless slab [the e = 0.5 split pose, subprocess, wall "
        f"{wall2:.1f} s]: {ms2:.3f} ms per frame, {fps2:.3f} fps; {err2}")
    res.update(headless_split_ms=ms2, headless_split_fps=fps2)

    # the frames the CLI must have written, rendered here from the same
    # files through the same entry points
    args = headless.build_parser().parse_args([tree_path, poses[0]])
    hopt = opts.render_options_from_args(args).replace(max_steps=4096)
    from volrend_torch.models.n3tree import N3Tree
    tdev = N3Tree(tree_path).to_device(lut_depth=None, device=dev)
    grid = dense_grid.bake_dense(tdev)
    gi = slab_render.default_gi(grid)
    trans, names = poses_from_files(poses)
    fx, fy = read_intrins(intrin)
    fcams = [Camera(W, H, fx, fy, t) for t in trans]
    groups = {}
    for i, c in enumerate(fcams):
        perm, flip, slope = slab_render.choose_axis(grid, c.transform, fx,
                                                    fy, W, H)
        if not (np.isfinite(slope) and slope < slab_render.MAX_SLAB_SLOPE):
            fail(f"headless: orbit pose {i} past the slab gate")
        groups.setdefault((perm, flip), []).append(i)
    n_diff = 0
    for (perm, flip), idx in groups.items():
        frames = slab_render.render_frames(
            grid, torch.as_tensor(np.stack([trans[i] for i in idx]),
                                  device=dev), fx, fy, perm, flip, W, H,
            hopt, gi=gi, payload=slab_render.prepare_payload(grid, perm,
                                                             hopt),
            out_dtype=torch.uint8).cpu().numpy()
        for j, i in enumerate(idx):
            png_img = read_png(os.path.join(out_dir, names[i] + ".png"))
            n_diff += int(not np.array_equal(png_img, frames[j]))
    log(f"headless slab PNGs against render_frames (gi {gi}, "
        f"{len(groups)} groups): {HEADLESS_POSES - n_diff} of "
        f"{HEADLESS_POSES} byte-equal")
    if n_diff:
        fail(f"headless: {n_diff} slab PNGs differ from render_frames")
    sfx, sfy = read_intrins(split_intrin)
    (strans,), _ = poses_from_files([split_pose])
    sframe = rgba_to_bytes(slab_render.render_frame_split(
        grid, strans, sfx, sfy, W, H, hopt, gi=gi).cpu().numpy())
    spng = read_png(os.path.join(out_dir, "split_e05.png"))
    serr = int(np.abs(spng.astype(np.int32) - sframe).max())
    log(f"headless split PNG against render_frame_split: max {serr} "
        f"quanta, {int((spng != sframe).any(-1).sum())} pixels differ")
    if serr > 1:
        fail(f"headless: the split pose's PNG is {serr} quanta from "
             "render_frame_split's")
    del grid
    torch.cuda.empty_cache()

    # the counted in-process run: warm-up + timed pass, every orbit pose
    # through M, W and the fit mode, no plain version
    reset_counts()
    plain = count_plain_calls()
    try:
        ms3, fps3, _, _ = _headless(
            torch, [tree_path, *poses, "-i", intrin, *common], False)
    finally:
        restore_plain()
    counts = read_counts()
    log(f"headless slab in process: {ms3:.3f} ms per frame, {fps3:.3f} "
        f"fps; counts {counts}; plain calls {plain}")
    n2 = 2 * HEADLESS_POSES
    if (counts["march_poses"] != n2 or counts["warp_poses"] != n2
            or counts["fit"] < 1 or counts["build"] or counts["combine"]
            or counts["ref_warp_poses"] or any(plain.values())):
        fail(f"headless: not every orbit pose went through M, W and the "
             f"fit mode alone ({counts}, plain {plain})")
    res.update(headless_counts=counts)

    # --renderer exact at scale 0.25, one image
    ex_dir = os.path.join(HEADLESS_DIR, "exact")
    ms4, fps4, _, _ = _headless(
        torch, [tree_path, poses[0], "-i", intrin, *common, "--renderer",
                "exact", "--max_imgs", "1", "--scale", "0.25", "-o", ex_dir],
        False)
    w4, h4 = int(W * 0.25), int(H * 0.25)
    ecam = Camera(w4, h4, fx * 0.25, fy * 0.25, trans[0])
    eimg = rgba_to_bytes(render_exact.render_image(tdev, ecam, hopt)
                         .cpu().numpy())
    epng = read_png(os.path.join(ex_dir, names[0] + ".png"))
    eerr = int(np.abs(epng.astype(np.int32) - eimg).max())
    log(f"headless exact [{w4}x{h4}]: {ms4:.3f} ms per frame, {fps4:.3f} "
        f"fps; PNG against render_image: max {eerr} quanta")
    if eerr > 1:
        fail(f"headless: the exact PNG is {eerr} quanta from render_image")
    res.update(headless_exact_ms=ms4, headless_exact_fps=fps4)
    del tdev
    torch.cuda.empty_cache()

    # --renderer oracle on a small tree against the exact renderer
    small = make_test_tree(max_depth=3, basis_dim=4, seed=5)
    small_path = os.path.join(HEADLESS_DIR, "small.npz")
    small.save_npz(small_path)
    back = np.array([1.0, 0.2, 0.3])
    back /= np.linalg.norm(back)
    ocam = Camera.from_vectors(center=tuple(2.5 * back), v_back=tuple(back),
                               width=24, height=24, fx=30.0)
    opose = os.path.join(HEADLESS_DIR, "oracle_pose.txt")
    _write_pose(opose, ocam.transform)
    ointrin = os.path.join(HEADLESS_DIR, "intrin_oracle.txt")
    _write_intrin(ointrin, ocam.fx)
    or_dir = os.path.join(HEADLESS_DIR, "oracle")
    ms5, _, _, _ = _headless(
        torch, [small_path, opose, "-i", ointrin, "-W", "24", "-H", "24",
                "--device", str(dev), "--renderer", "oracle", "-o", or_dir],
        False)
    (otrans,), _ = poses_from_files([opose])
    ofx, ofy = read_intrins(ointrin)
    ref = render_exact.render_image(
        small.to_device(lut_depth=None, device=dev),
        Camera(24, 24, ofx, ofy, otrans), hopt).cpu().numpy()
    ogot = read_png(os.path.join(or_dir, "oracle_pose.png")) / 255.0
    p_or = psnr(ogot[..., :3], rgba_to_bytes(ref)[..., :3] / 255.0)
    log(f"headless oracle [24x24, depth-3 tree]: {ms5:.1f} ms per frame; "
        f"PNG against the exact renderer's frame {p_or:.2f} dB (floor "
        f"{FLOOR_ORACLE})")
    if not p_or >= FLOOR_ORACLE:
        fail(f"headless: the oracle's PNG at {p_or:.2f} dB < {FLOOR_ORACLE}")
    res.update(headless_oracle_psnr_db=p_or, headless_oracle_ms=ms5)
    shutil.rmtree(HEADLESS_DIR, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# Phase 12e: the parallel layer (z-segments of kernels M and M-bwd; the
# sharded renders and trainers on torch.distributed)
# ---------------------------------------------------------------------------

#: the kernels line's rows of this phase: kernel M's display and training
#: modes and M-bwd on z-segments (z_base, acc_init, state_init)
ZSEG_ROWS = (
    ("MZ", "slab_march_display_zseg",
     "volrend_torch/csrc/slab_march_display.cu",
     "volrend_tpu/ops/pallas_slab.py:344"),
    ("MTZ", "slab_march_train_zseg", "volrend_torch/csrc/slab_march.cu",
     "volrend_tpu/ops/pallas_slab.py:344"),
    ("MBZ", "slab_march_bwd_zseg", "volrend_torch/csrc/slab_march_bwd.cu",
     "volrend_tpu/ops/pallas_slab.py:951"),
)
TOL_ZSEG_BWD_REL = 1e-5     # the segments' cotangent against the whole's
TOL_ZSTEP_LOSS = 1e-5       # the dry run's: a sharded step's loss, relative
TOL_ZSTEP_ATOL = 2e-4       # ... and its parameters
TOL_ZSTEP_RTOL = 1e-4
# z-sharded frames against unsharded ones: their accumulators agree to f32
# rounding, but the display warp quantizes the intermediate image to int8
# steps of 1/255 (display_warp._quantize_affine), so a cell on a step's
# edge may move one step: one quantum, and a PSNR floor
TOL_ZFRAME = 1.0 / 255.0 + 1e-6
FLOOR_ZFRAME_DB = 60.0
TOL_RAYS = 2e-5             # ray-sharded / leaf-sharded renders
ZRAYS = 8192                # the ray-sharded trainer's batch
ZSHARD_TIMEOUT_S = 600


def zseg_display_checks(torch, dev, stats):
    """12e (a), kernel M's display mode on z-segments: the dense scene
    (G=256 int8, gi=256) at orbit pose 0, 800^2, stop_thresh 0: over 2 and
    4 segments, each launched with its z_base and the upstream segments'
    state as acc_init, held against the plain version on the same inputs;
    the last segment's output against the whole-grid launch (the chained
    launches take the resume variants). Fills stats["MZ"] (times of the
    downstream segment of two as the z-sharded render launches it: its
    z_base, no acc_init)."""
    from volrend_torch.ops import slab_march, slab_render
    from volrend_torch.parallel import dist as pdist
    from volrend_torch.probes import _common
    from volrend_torch.utils.options import RenderOptions
    grid = _common.dense_grid_on(dev)
    cam = _common.orbit_poses(N_POSES)[0]
    sopt = RenderOptions(max_steps=1024, stop_thresh=0.0, renormalize=False)
    perm, flip, _ = slab_render.choose_axis(grid, cam.transform, cam.fx,
                                            cam.fy, W, H)
    g = slab_render.FrameGeom(grid, cam.transform, cam.fx, cam.fy, perm,
                              flip, W, H, sopt, GI)
    params, zb = slab_render._march_frame_fields(grid, g, perm, flip, sopt)
    G, D, bd = grid.G, grid.data_dim, grid.basis_dim
    qs = grid.qscale
    kw = dict(sig2=True, flip=flip, bbox_full=True, dir_win=True,
              fmt=int(grid.fmt), extra=grid.extra, k_per_step=4)
    args = (qs, zb, G, GI, D, bd, perm)
    pay = slab_render._permuted_grid(grid, perm)
    whole = slab_march.march_slabs(
        pay, params, *args,
        slab_ids=tuple(range(G - 1, -1, -1) if flip else range(G)), **kw)
    del pay
    out = {"segments": {}}
    worst = 0.0
    for n in (2, 4):
        Gl = G // n
        order = list(range(n - 1, -1, -1) if flip else range(n))
        lids = tuple(range(Gl - 1, -1, -1) if flip else range(Gl))
        acc = None
        for k, i in enumerate(order):
            seg = pdist._zsegment(grid, perm, Gl, i)
            zbase = i * (Gl / G)
            acc_k = slab_march.march_slabs(seg, params, *args, slab_ids=lids,
                                           z_base=zbase, acc_init=acc, **kw)
            m = slab_march.march_inputs(seg, params, zb, G, GI, lids, 4,
                                        None, zbase)
            acc_p = slab_march.march_slabs_ref(
                seg, qs, D=D, bd=bd, flip=flip, dir_win=True,
                acc_init=None if acc is None else acc.clone(), **m)
            err, _, _ = freeze_flip_check(
                torch, f"display segment {i} of {n}", acc_k, acc_p, 0.0)
            worst = max(worst, err)
            if n == 2 and k == 1:
                # the timed launch: the downstream segment of two, as the
                # z-sharded render launches it (its parts fold afterwards),
                # against its plain version too
                def path_launch():
                    return slab_march.march_slabs(
                        seg, params, *args, slab_ids=lids, z_base=zbase,
                        **kw)
                acc_p, plain_ms = timed_once(torch, lambda: slab_march.
                                             march_slabs_ref(
                    seg, qs, D=D, bd=bd, flip=flip, dir_win=True, **m))
                err, _, _ = freeze_flip_check(
                    torch, f"display segment {i} of {n} (no acc_init)",
                    path_launch(), acc_p, 0.0)
                worst = max(worst, err)
                stats["MZ"] = {
                    "plain_ms": plain_ms, "library_ms": None,
                    "ms": cuda_ms(torch, path_launch, KREPS),
                    "segment": f"{i} of {n}, z_base {zbase}"}
                stats["MZ"]["bound_ms"], stats["MZ"]["bound_by"] = (
                    march_bound(torch, seg, qs, m["zb"], lids, G, GI, bd,
                                float(m["params"][0, 14]), z_base=zbase))
            acc = acc_k
            del seg, acc_p
        d = float((acc - whole).abs().max())
        out["segments"][n] = d
        log(f"kernel M display on {n} z-segments (pose 0, z_base and "
            f"acc_init chained): each against its plain version, the last "
            f"against the whole-grid launch: max |diff| {d:.3e}")
        if not d <= TOL_M:
            fail(f"kernel M's display segments ({n}) differ from the whole "
                 f"grid's launch by {d}")
    stats["MZ"]["max_abs_err"] = worst
    del grid, whole
    torch.cuda.empty_cache()
    return out


def zseg_train_checks(torch, dev, stats):
    """12e (a), kernel M's training mode and M-bwd on z-segments: the
    training bench's G=256 SH9 bake (f32) at its pose 0, stop_thresh 0,
    over 2 segments (slab_grad.zsegment, their coarse occupancy the whole
    one's slice): the forward chained through acc_init (the resume
    variant), each launch against its plain version, the last against the
    whole grid's; the backward of each segment from its incoming (T, A)
    (state_init, from the forward's parts) against its plain version, and
    the segments' cotangent together within TOL_ZSEG_BWD_REL of the whole
    grid's. Fills stats["MTZ"] and stats["MBZ"] (times of the downstream
    segment as the z-sharded trainer launches it: z_base, and state_init
    for M-bwd)."""
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import slab_grad, slab_march, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.probes import _common
    from volrend_torch.utils.options import RenderOptions
    sopt = RenderOptions(max_steps=1024, stop_thresh=0.0)
    tree = _common.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=DEPTH, basis_dim=9, seed=7))
    tr = train.FrameTrainer(tree.to_device(lut_depth=None, device=dev),
                            opt=sopt, lr=TRAIN_LR, gi=GI)
    sthr = float(tr.opt.sigma_thresh)
    with torch.no_grad():  # the kernels' inputs: no autograd graph
        bake, live = slab_grad.bake_from_pyramid(tuple(tr.pyramid), tr.bmap,
                                                 live_thresh=sthr)
    cam = train_orbit(Camera)[0]
    perm, flip = tr._group(cam)
    G, D, bd = tr.grid.G, tr.grid.data_dim, tr.grid.basis_dim
    geom = slab_render.FrameGeom(tr.grid, cam.transform, cam.fx, cam.fy,
                                 perm, flip, W, H, tr.opt, GI)
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=D, bd=bd, fmt=int(tr.grid.fmt),
                            perm=perm, flip=flip, ids=(), opt=tr.opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    del tr
    q = (perm[0], 3, perm[1], perm[2])
    qs = torch.ones(D, device=dev)
    st = slab_grad._kernel_statics(cfg)
    st.pop("flip")
    occ = slab_march.march_occupancy(bake.permute(*q), params.cpu(), qs,
                                     live=live, perm=perm)
    kw = dict(flip=flip, dir_win=False, train=True, **st)
    whole = slab_march.march_slabs(
        bake.permute(*q), params, qs, zb, G, GI, D, bd, perm,
        slab_ids=tuple(range(G - 1, -1, -1) if flip else range(G)),
        occupancy=occ, **kw)[0]
    gacc4 = torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, GI, GI)).astype(np.float32), device=dev)
    bkw = dict(flip=flip, **st)
    whole_g = slab_march.march_slabs_bwd(bake.permute(*q), params[0], qs,
                                         zb[0], gacc4, whole, G, GI, D, bd,
                                         perm, occupancy=occ, **bkw)
    n, Gl = 2, G // 2
    order = [1, 0] if flip else [0, 1]
    lids = tuple(range(Gl - 1, -1, -1) if flip else range(Gl))
    segs, parts = {}, {}
    acc, worst = None, 0.0
    for k, i in enumerate(order):
        seg = slab_grad.zsegment(bake.permute(*q), i, Gl)
        socc = occ[i * Gl:(i + 1) * Gl]
        zbase = i * (Gl / G)
        segs[i] = (seg, socc, zbase)
        acc_k = slab_march.march_slabs(seg, params, qs, zb, G, GI, D, bd,
                                       perm, slab_ids=lids, z_base=zbase,
                                       acc_init=acc, occupancy=socc, **kw)
        m = slab_march.march_inputs(seg, params, zb, G, GI, lids, 4, None,
                                    zbase)
        mode_kw = {k2: v for k2, v in st.items() if k2 != "extra"}
        acc_p = slab_march.march_slabs_ref(
            seg, qs, D=D, bd=bd, flip=flip,
            acc_init=None if acc is None else acc.clone(), **mode_kw, **m)
        err, _, _ = freeze_flip_check(
            torch, f"training segment {i} of {n}", acc_k, acc_p, 0.0)
        worst = max(worst, err)

        def path_launch():
            # the segment as the z-sharded trainer launches it: its parts
            # fold afterwards
            return slab_march.march_slabs(
                seg, params, qs, zb, G, GI, D, bd, perm, slab_ids=lids,
                z_base=zbase, occupancy=socc, **kw)
        parts[i] = path_launch()[0]
        if k == 1:
            acc_p, mt_plain_ms = timed_once(torch, lambda: slab_march.
                                            march_slabs_ref(
                seg, qs, D=D, bd=bd, flip=flip, **mode_kw, **m))
            err, _, _ = freeze_flip_check(
                torch, f"training segment {i} of {n} (no acc_init)",
                parts[i][None], acc_p, 0.0)
            worst = max(worst, err)
            stats["MTZ"] = {
                "plain_ms": mt_plain_ms, "library_ms": None,
                "ms": cuda_ms(torch, path_launch, KREPS),
                "segment": f"{i} of {n}, z_base {zbase}"}
            stats["MTZ"]["bound_ms"], stats["MTZ"]["bound_by"] = (
                march_bound(torch, seg, qs, m["zb"], lids, G, GI, bd, sthr,
                            z_base=zbase))
        acc = acc_k
        del acc_p
    stats["MTZ"]["max_abs_err"] = worst
    d = float((acc[0] - whole).abs().max())
    log(f"kernel M training mode on {n} z-segments (pose 0, z_base and "
        f"acc_init chained): the last against the whole grid's launch: max "
        f"|diff| {d:.3e}")
    if not d <= TOL_M:
        fail(f"kernel M's training segments differ from the whole grid's "
             f"launch by {d}")
    states = slab_grad.segment_states(
        torch.stack([parts[i] for i in range(n)]), gacc4, order)
    gsegs, mb = [], {}
    for k, i in enumerate(order):
        seg, socc, zbase = segs[i]
        g_k = slab_march.march_slabs_bwd(
            seg, params[0], qs, zb[0], gacc4, whole, G, GI, D, bd, perm,
            occupancy=socc, z_base=zbase, state_init=states[i], **bkw)
        bprm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
            params[0], zb[0], gacc4, whole, G, GI, states[i], zbase)
        mode = slab_march.MarchMode(cfg.fmt, None, False, st["rot"],
                                    st["bbox_full"], st["basis_lo"],
                                    st["basis_hi"])
        g_p, mb_plain_ms = timed_once(torch, lambda: slab_march.
                                      march_slabs_bwd_ref(
            seg, qs, bprm, bzb, bgacc, aux, G, GI, D, bd, flip,
            mode=mode))
        gk, gp = g_k.double(), g_p.double()
        rel = float((gk - gp).norm() / gp.norm())
        cos = float((gk * gp).sum() / (gk.norm() * gp.norm()))
        log(f"kernel M-bwd on segment {i} of {n} (z_base {zbase}, "
            f"state_init): against its plain version relative L2 {rel:.3e}, "
            f"cosine {cos:.9f}")
        if not (rel < TOL_BWD_REL and cos > MIN_BWD_COS):
            fail(f"kernel M-bwd's segment {i} disagrees with its plain "
                 f"version")
        mb["max_abs_err"] = max(mb.get("max_abs_err", 0.0),
                                float((g_k - g_p).abs().max()))
        if k == 1:
            mb.update(plain_ms=mb_plain_ms, library_ms=None,
                      segment=f"{i} of {n}, z_base {zbase}, state_init",
                      ms=cuda_ms(torch, lambda: slab_march.march_slabs_bwd(
                          seg, params[0], qs, zb[0], gacc4, whole, G, GI, D,
                          bd, perm, occupancy=socc, z_base=zbase,
                          state_init=states[i], **bkw), KREPS))
            mb["bound_ms"], mb["bound_by"] = march_bwd_bound(
                torch, seg, qs, bzb[None], G, GI, bd, sthr, z_base=zbase)
        gsegs.append((i, g_k))
        del g_p, gk, gp
    gsegs.sort()
    # slab-major views: the segments' cotangents follow each other
    full = torch.cat([g.permute(0, 2, 3, 1) for _, g in gsegs]).double()
    wg = whole_g.permute(0, 2, 3, 1).double()
    rel = float((full - wg).norm() / wg.norm())
    mb["segments_vs_whole_rel_l2"] = rel
    stats["MBZ"] = mb
    log(f"kernel M-bwd on {n} z-segments: the segments' cotangent against "
        f"the whole grid's relative L2 {rel:.3e} (tolerance "
        f"{TOL_ZSEG_BWD_REL})")
    if not rel < TOL_ZSEG_BWD_REL:
        fail(f"the z-segments' cotangent differs from the whole grid's "
             f"({rel})")
    del bake, live, occ, whole_g, full, wg, gsegs, segs
    torch.cuda.empty_cache()
    return {"train_segments_vs_whole": d, "bwd_segments_rel_l2": rel}


def _zshard_counts():
    from volrend_torch.ops import render_exact, slab_march
    from volrend_torch.parallel import mesh as mesh_mod
    slab_march.march_slabs.segments = 0
    slab_march.march_slabs.train_segments = 0
    slab_march.march_slabs_bwd.segments = 0
    mesh_mod.collective_counts.clear()
    render_exact.reset_march_counts()


def _close_report(torch, a, b, atol, rtol):
    """(max |a - b|, values past atol + rtol |b|) of two tensors."""
    d = (a.float() - b.float()).abs()
    return float(d.max()), int((d > atol + rtol * b.float().abs()).sum())


def zshard_rank(rank: int, backend: str, device: str = "cuda:0") -> dict:
    """12e (b)/(c): one rank of the sharded world (gloo: every rank on
    cuda:0; NCCL: one rank). Drives the parallel layer's entry points at
    full width and holds each against its unsharded run in this rank:
    - render_frames_slab_zsharded on the dense scene's orbit group 0 and
      render_frame_slab_zsharded on its first pose, against render_frames
      (stop_thresh 0): max |diff| within TOL_ZFRAME, PSNR >= 60 dB;
    - two FrameTrainer.step_frame_zsharded steps on the training bench
      (800^2, gi=256) against two step_frame steps: the second loss and
      the parameters at the dry run's tolerances;
    - step_frames_sharded over the 4 training poses against a one-rank
      mesh's (no collective);
    - Trainer.step_sharded at ZRAYS rays against Trainer.step;
    - a leaf-sharded render of the training tree against the replicated
      one.
    Each case's host-clock ms (its second call, after a warming one;
    the trainers' steps likewise two a side) beside the unsharded call's;
    the segment launches and collectives counted over the run (from 0).
    Returns a dict of numbers; raises on a failed check."""
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, HERE)
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import render_exact, slab_march, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.parallel import dist as pdist
    from volrend_torch.parallel import leaf_shard
    from volrend_torch.parallel import mesh as mesh_mod
    from volrend_torch.probes import _common
    from volrend_torch.utils.options import RenderOptions

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    res = {"rank": rank, "backend": backend,
           "world": tdist.get_world_size()}
    problems = []

    def check(ok, what):
        if not ok:
            problems.append(what)

    def timed(fn):
        """fn's second call and its host-clock ms (the first call warms
        it: a trainer takes two steps)."""
        fn()
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    _zshard_counts()
    # ---- the z-sharded display frames: the dense scene's group 0 --------
    sopt = RenderOptions(max_steps=1024, stop_thresh=0.0, renormalize=False)
    grid = _common.dense_grid_on(dev)
    cams = _common.orbit_poses(N_POSES)
    (perm, flip), idx = next(iter(_common.pose_groups(grid, cams, W,
                                                      H).items()))
    trs = np.stack([cams[i].transform for i in idx])
    zmesh = mesh_mod.make_mesh("z", device=dev)
    fx, fy = cams[0].fx, cams[0].fy
    fz, ms_z = timed(lambda: pdist.render_frames_slab_zsharded(
        grid, trs, fx, fy, W, H, sopt, zmesh, gi=GI))
    fu, ms_u = timed(lambda: slab_render.render_frames(
        grid, trs, fx, fy, perm, flip, W, H, sopt, gi=GI))
    err = float((fz - fu).abs().max())
    mse = float(((fz[..., :3] - fu[..., :3]).double() ** 2).mean())
    f1, ms_1 = timed(lambda: pdist.render_frame_slab_zsharded(
        grid, trs[0], fx, fy, W, H, sopt, zmesh, gi=GI))
    err1 = float((f1 - fz[0]).abs().max())
    db = 99.0 if mse < 1e-12 else -10 * math.log10(mse)
    res["frames"] = {"poses": len(idx), "max_abs_diff": err, "psnr_db": db,
                     "values_past_1e-5": int(((fz - fu).abs() > 1e-5).sum()),
                     "one_pose_vs_batch": err1, "ms": ms_z,
                     "unsharded_ms": ms_u, "one_pose_ms": ms_1}
    check(err <= TOL_ZFRAME and err1 <= TOL_ZFRAME and db >= FLOOR_ZFRAME_DB,
          f"z-sharded frames differ from the unsharded ones ({err}, {err1}, "
          f"{db} dB)")
    del grid, fz, fu, f1

    # ---- the training bench: z-sharded and pose-sharded frame steps ----
    tree = _common.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=DEPTH, basis_dim=9, seed=7))
    tdev = tree.to_device(lut_depth=None, device=dev)
    tcams = train_orbit(Camera)
    tgt = torch.full((H, W, 4), 0.5, dtype=torch.float32, device=dev)
    def step_extra_gib(fn):
        """The device memory one more call of fn takes above what is
        allocated before it (this process's peak over its base), GiB;
        not measured (nan) off the card."""
        if dev.type != "cuda":
            fn()
            return float("nan")
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn()
        sync()
        return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30

    tz = train.FrameTrainer(tdev, opt=sopt, lr=TRAIN_LR, gi=GI)
    lz, ms_z = timed(lambda: tz.step_frame_zsharded(zmesh, tcams[0], tgt))
    pz = [p.detach().clone() for p in tz.pyramid]
    gib_z = step_extra_gib(lambda: tz.step_frame_zsharded(zmesh, tcams[0],
                                                          tgt))
    del tz
    tu = train.FrameTrainer(tdev, opt=sopt, lr=TRAIN_LR, gi=GI)
    lu, ms_u = timed(lambda: tu.step_frame(tcams[0], tgt))
    pu = [p.detach().clone() for p in tu.pyramid]
    gib_u = step_extra_gib(lambda: tu.step_frame(tcams[0], tgt))
    worst, past = 0.0, 0
    for a, b in zip(pz, pu):
        m, c = _close_report(torch, a, b, TOL_ZSTEP_ATOL, TOL_ZSTEP_RTOL)
        worst, past = max(worst, m), past + c
    res["zstep"] = {"loss": lz, "unsharded_loss": lu, "param_max_diff":
                    worst, "params_past_tol": past, "ms": ms_z,
                    "unsharded_ms": ms_u, "step_extra_gib": gib_z,
                    "unsharded_step_extra_gib": gib_u}
    check(abs(lz - lu) <= TOL_ZSTEP_LOSS * max(1.0, abs(lu)),
          f"z-sharded step loss {lz} != unsharded {lu}")
    check(past == 0, f"z-sharded step: {past} parameters past the "
                     f"tolerance (max |diff| {worst})")
    del tu, pz, pu
    topt = RenderOptions(max_steps=1024)
    fmesh = mesh_mod.make_mesh("frames", device=dev)
    ts = train.FrameTrainer(tdev, opt=topt, lr=TRAIN_LR, gi=GI)
    placed = ts.place_frames(tcams, [tgt] * len(tcams))
    ls, ms_s = timed(lambda: ts.step_frames_sharded(fmesh, tcams, placed))
    ps = [p.detach() for p in ts.pyramid]
    del ts
    t1 = train.FrameTrainer(tdev, opt=topt, lr=TRAIN_LR, gi=GI)
    one = mesh_mod.make_mesh("frames", device=dev,
                             ranks=[tdist.get_rank()])
    l1, ms_1 = timed(lambda: t1.step_frames_sharded(one, tcams, placed))
    worst, past = 0.0, 0
    for a, b in zip(ps, t1.pyramid):
        m, c = _close_report(torch, a, b.detach(), TOL_ZSTEP_ATOL,
                             TOL_ZSTEP_RTOL)
        worst, past = max(worst, m), past + c
    res["frames_step"] = {"poses": len(tcams), "loss": ls,
                          "one_rank_loss": l1, "param_max_diff": worst,
                          "params_past_tol": past, "ms": ms_s,
                          "one_rank_ms": ms_1}
    check(abs(ls - l1) <= TOL_ZSTEP_LOSS * max(1.0, abs(l1)),
          f"pose-sharded step loss {ls} != one rank's {l1}")
    check(past == 0, f"pose-sharded step: {past} parameters past the "
                     f"tolerance (max |diff| {worst})")
    del t1, ps, placed

    # ---- the ray-batch trainer and the leaf-sharded render -------------
    rmesh = mesh_mod.make_mesh("rays", device=dev)
    o, d = tcams[0].pixel_rays(xp=np)
    mid = o.shape[0] // 2 - ZRAYS // 2
    o = np.ascontiguousarray(o[mid:mid + ZRAYS])
    d = np.ascontiguousarray(d[mid:mid + ZRAYS])
    tt = np.full((ZRAYS, 4), 0.5, np.float32)
    ta = train.Trainer(tdev, topt, lr=TRAIN_LR)
    tb = train.Trainer(tdev, topt, lr=TRAIN_LR)
    la, ms_a = timed(lambda: ta.step(o, d, tt))
    lb, ms_b = timed(lambda: tb.step_sharded(rmesh, o, d, tt))
    m, c = _close_report(torch, tb.data, ta.data, TOL_ZSTEP_ATOL,
                         TOL_ZSTEP_RTOL)
    res["ray_step"] = {"rays": ZRAYS, "loss": lb, "unsharded_loss": la,
                       "data_max_diff": m, "data_past_tol": c, "ms": ms_b,
                       "unsharded_ms": ms_a}
    check(abs(la - lb) <= TOL_ZSTEP_LOSS * max(1.0, abs(la)),
          f"ray-sharded step loss {lb} != unsharded {la}")
    check(c == 0, f"ray-sharded step: {c} rows past the tolerance")
    del ta, tb
    ref, ms_r = timed(lambda: render_exact.render_rays(tdev, o, d, topt))
    tree_s, rps = leaf_shard.shard_tree_leaves(tdev, rmesh)
    ol, dl, nv = pdist.shard_rays(o, d, rmesh)
    got, ms_l = timed(lambda: leaf_shard.render_rays_leaf_sharded(
        tree_s, ol, dl, topt, rmesh, rps)[:nv])
    m, c = _close_report(torch, got, ref, TOL_RAYS, 1e-5)
    res["leaf_render"] = {"rays": ZRAYS, "rows_per_rank": rps,
                          "max_abs_diff": m, "past_tol": c, "ms": ms_l,
                          "unsharded_ms": ms_r,
                          "iterations": render_exact.march_counts["fwd"]}
    check(c == 0, f"leaf-sharded render: {c} values past the tolerance")
    res["counts"] = {
        "display_segments": slab_march.march_slabs.segments,
        "train_segments": slab_march.march_slabs.train_segments,
        "bwd_segments": slab_march.march_slabs_bwd.segments,
        "collectives": dict(mesh_mod.collective_counts)}
    res["problems"] = problems
    return res


def zshard_phase(torch, dev, stats):
    """Phase 12e: the z-segment kernels in this process (a), then the
    parallel layer's entry points in a two-rank gloo world whose ranks
    share cuda:0 (b) and a one-rank NCCL world (c), both started with the
    kernels already built. Two ranks on one card are a correctness run:
    their times are not a scaling number. Fills the MZ, MTZ and MBZ rows
    (launches: the segment launches of world (b)'s run); returns a summary
    dict."""
    from volrend_torch.parallel import launch
    out = {"display": zseg_display_checks(torch, dev, stats)}
    out.update(zseg_train_checks(torch, dev, stats))
    worlds = {}
    for n, backend in ((2, "gloo"), (1, "nccl")):
        t = time.perf_counter()
        ranks = launch.spawn(zshard_rank, n, args=(backend, "cuda:0"),
                             backend=backend, timeout_s=ZSHARD_TIMEOUT_S)
        secs = time.perf_counter() - t
        for r in ranks:
            log(f"sharded world [{backend} x{n}, rank {r['rank']}, all on "
                f"cuda:0; a correctness run, not a scaling number]: "
                f"{json.dumps(r)}")
            if r["problems"]:
                fail(f"sharded world {backend} x{n} rank {r['rank']}: "
                     f"{r['problems']}")
        cn = {k: sum(r["counts"][k] for r in ranks)
              for k in ("display_segments", "train_segments",
                        "bwd_segments")}
        log(f"sharded world [{backend} x{n}] in {secs:.1f} s: segment "
            f"launches {cn}" + ("" if n > 1 else " (one rank: the z-sharded "
                                "step marches the whole grid)"))
        if n > 1 and min(cn.values()) < 1:
            fail(f"sharded world {backend} x{n}: a segment kernel never "
                 f"launched ({cn})")
        worlds[f"{backend}x{n}"] = {"seconds": secs, "counts": cn,
                                    "rank0": ranks[0]}
    for key, cnt in (("MZ", "display_segments"), ("MTZ", "train_segments"),
                     ("MBZ", "bwd_segments")):
        stats[key]["launches"] = worlds["gloox2"]["counts"][cnt]
    out["worlds"] = worlds
    return out


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
            if ("registers" in line or "spill" in line
                    or line.startswith("nvcc seconds")):
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
        # each group's transforms and its frames' indices, on the card: an
        # index from a host list would be copied from pageable memory,
        # which waits for the work queued before it
        trs = {k: (torch.as_tensor(np.stack([cams[i].transform for i in v]),
                                   dtype=torch.float32, device=dev),
                   torch.as_tensor(v, dtype=torch.int64, device=dev))
               for k, v in groups.items()}
        return groups, pays, trs

    def render_all(grid, cams, groups, pays, trs):
        fx, fy = cams[0].fx, cams[0].fy
        out = torch.empty((len(cams), H, W, 4), dtype=torch.uint8,
                          device=dev)
        for perm, flip in groups:
            tr, idx = trs[(perm, flip)]
            out[idx] = slab_render.render_frames(
                grid, tr, fx, fy, perm, flip, W, H, opt, gi=GI,
                payload=pays[perm], out_dtype=torch.uint8)
        return out

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

    def gate(tag, tdev, cam, frame, stride, floor, gopt=None):
        """``frame`` (H, W, 4) uint8 on the card against the exact
        renderer's rays (options ``gopt``, default the smoke's) at
        ``stride``: rgb PSNR >= floor."""
        ys = np.arange(0, H, stride)
        xs = np.arange(0, W, stride)
        origins, dirs = cam.pixel_rays(xp=np)
        sel = (ys[:, None] * W + xs[None, :]).reshape(-1)
        t = time.perf_counter()
        exact = render_exact.render_rays(
            tdev, torch.as_tensor(np.ascontiguousarray(origins[sel])),
            torch.as_tensor(np.ascontiguousarray(dirs[sel])),
            gopt or opt).cpu().numpy()
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
        log(f"kernel B [{tag}]: table {tuple(tbl_k.shape)} bit-equal; on "
            f"the card {build_occupancy(kernels, P, GI, Wn, False, True)}")
        if time_it and P >= 3:
            build_extra_checks(torch, inter)

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

    # ---- 5b. the steep pose: split-frame class passes ----------------------
    steep = steep_phase(torch, tdev, grid, opt, stats, gate)

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

    # ---- 10-11. the NDC scene: display, then frame training ----------------
    ndc, ndc_tree_ = ndc_phase(torch, dev, opt, stats, gate)
    ndc.update(ndc_train_phase(torch, dev, ndc_tree_, stats))
    del ndc_tree_

    # ---- 12. kernel M's display variants -----------------------------------
    variants = variants_phase(torch, kernels, dev, opt, stats, gate,
                              main_path, groups_of, render_all)

    # ---- 12b. the training pair's formats and options -----------------------
    train_variants = train_variants_phase(torch, dev, stats)

    # ---- 12c. mesh overlays, the display knobs, a quantized tree ------------
    overlay = overlay_phase(torch, kernels, dev, opt, stats, gate, groups_of)

    # ---- 12d. T2 ray-batch training, the headless batch renderer -----------
    t2 = t2_phase(torch, dev)
    t2.update(headless_phase(torch, dev))

    # ---- 12e. the parallel layer: z-segments, the sharded worlds ------------
    zshard = zshard_phase(torch, dev, stats)

    # ---- 13. result ---------------------------------------------------------
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
               **probe, **steep, **ndc, "variants": variants,
               "train_variants": train_variants, "overlay": overlay,
               "m_variant_launches": stats.get("M_variants"), "t2": t2,
               "zshard": zshard,
               "seconds": time.perf_counter() - _T0}
    log(f"summary {json.dumps(summary)}")
    spec = (
        ("M", "slab_march_display",
         "volrend_torch/csrc/slab_march_display.cu",
         "volrend_tpu/ops/pallas_slab.py:344", counts["march"]),
        ("B", "warp_build", "volrend_torch/csrc/warp_build.cu",
         "volrend_tpu/ops/display_warp.py:139", ndc["ndc_counts"]["build"]),
        ("C", "warp_combine", "volrend_torch/csrc/warp_combine.cu",
         "volrend_tpu/ops/display_warp.py:228",
         ndc["ndc_counts"]["combine"]),
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
    spec += tuple((key, name, "volrend_torch/csrc/slab_march_display.cu",
                   "volrend_tpu/ops/pallas_slab.py:344",
                   stats[key]["launches"]) for key, name, _ in VARIANT_ROWS)
    spec += tuple((key, name, src, rep, stats[key]["launches"])
                  for key, name, src, rep in TRAIN_VARIANT_ROWS)
    spec += tuple((key, name, src, rep, stats[key]["launches"])
                  for key, name, src, rep in OVERLAY_ROWS)
    spec += tuple((key, name, src, rep, stats[key]["launches"])
                  for key, name, src, rep in ZSEG_ROWS)
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
