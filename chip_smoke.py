#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``volrend_torch``) on one NVIDIA
GPU: builds the hand-written kernels, holds each against its plain PyTorch
version at the display path's full width, drives the display render path
end to end and gates its quality against the exact octree renderer.

    python3 chip_smoke.py [--profile]

``--profile`` adds a torch.profiler trace of one dense main-path run and of
one training step (device time by kernel, the device's idle share).

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
   sigma threshold);
4. the main path: ``render_frames`` over 200 orbit poses grouped by
   (perm, flip), RGBA8 output, gi=256 — launch counts reset just before and
   read just after, so every pose must have gone through kernels M, B and
   C and none through the reference warp; median wall time of REPS runs;
5. the quality gate: orbit pose 0 against ``render_exact.render_rays`` at
   stride 5 (>= 54 dB);
6. the sparse solid scene: each kernel against its plain version on the
   first pose group of each perm (cropped payloads, culled slab lists),
   then 96 orbit poses at full width, throughput and a gate at stride 8
   (>= 47.5 dB);
7. training at the reference's training-bench width (tools/bench_train.py:
   ``make_solid_tree(max_depth=7, basis_dim=9, seed=7)``, G=256 SH9,
   800^2 frames, gi=256, 4 orbit poses of one (perm, flip) group,
   ``FrameTrainer(lr=5e-2)``): kernel M's training mode and the backward
   kernel against their plain versions on pose 0, with times and bounds;
   then timed ``step_frame`` steps (synced and ``sync=False``) with the
   launch counts reset just before and read just after — every step must
   run exactly one launch of each kernel and no plain version — and the
   peak device memory;
8. the recovery gate at G=128 (examples/train_slab_demo.py): corrupt the
   leaf rows, train 60 steps, PSNR must rise by more than 5 dB;
9. one JSON line with every kernel's numbers, then the result line.
"""

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
CACHE = os.path.join(HERE, ".torch_bench_tree_cache.npz")
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
KREPS = 10          # kernel timing repetitions (median)
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
MIN_BWD_COS = 0.9999
TOL_C_F32 = 1e-5    # combine f32 emit
TOL_C_U8 = 1        # combine uint8 emit, in display quanta
# card peaks for the bounds (NVIDIA data sheet, H100 SXM, dense rates)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

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
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    fp32 operations over the fp32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def march_work(torch, pay, qs, zb, slab_ids, G: int, bd: int,
               sigma_thresh: float):
    """What this run's data asks of the march, counted from the payload and
    the per-pixel z intervals: a slab is marched for a pose when some
    pixel's interval [zlo, zhi] (zb[p, 0:2]) meets it; a voxel is shaded,
    and its colour planes read, only when its sigma is above the threshold.
    Returns (sigma-plane bytes of the slabs marched for any pose, colour
    bytes of their voxels above the threshold, per pose: voxels above the
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
        sig = (sl[D - 1].float() * 128.0 + sl[D].float() if sig_planes == 2
               else sl[D - 1].float())
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


def profile_run(torch, fn, tag: str) -> None:
    """Trace one call of ``fn`` with torch.profiler: device time by kernel
    name (the 30 largest), the device's busy time (union of kernel
    intervals) and its idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        fail(f"{tag}: the profiler saw no device activity")
    by_name = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += (e.time_range.end - e.time_range.start) / 1e3
        d[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy = (busy + cur_e - cur_s) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    log(f"{tag} profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms,"
        f" idle share {1.0 - busy / wall_ms:.4f}, {len(kern)} kernels")
    for name, (ms, n) in ranked[:30]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name[:150]}")


def orbit_poses(Camera, n, radius=2.8, elev=0.45):
    """The bench's orbit protocol (bench.py orbit_poses)."""
    cams = []
    for i in range(n):
        th = 2 * np.pi * i / n
        back = np.array([np.cos(th) * np.cos(elev),
                         np.sin(th) * np.cos(elev), np.sin(elev)])
        cams.append(Camera.from_vectors(
            center=tuple(radius * back), v_back=tuple(back),
            width=W, height=H))
    return cams


def steep_pose(Camera, slab_render, grid, lo=3.6, hi=3.95):
    """Orbit pose 0's view with the focal narrowed until the boundary-ray
    slope lies in [lo, hi): steep, yet below MAX_SLAB_SLOPE."""
    base = orbit_poses(Camera, 1)[0]
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


def load_tree(path, make):
    from volrend_torch.models.n3tree import N3Tree
    if os.path.isfile(path):
        return N3Tree(path)
    tree = make()
    tree.save_npz(path, compressed=False)
    return tree


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
    """Phases 7 and 8: the training path at the training bench's width,
    then the recovery gate. Fills stats["MT"] (kernel M, training mode) and
    stats["MB"] (the backward kernel); returns a summary dict."""
    from volrend_torch import train
    from volrend_torch.models.synthetic import make_solid_tree
    from volrend_torch.ops import slab_grad, slab_march, slab_render
    from volrend_torch.ops.camera import Camera
    from volrend_torch.utils.options import RenderOptions

    topt = RenderOptions(max_steps=1024)
    t = time.perf_counter()
    tree = load_tree(CACHE_TRAIN, lambda: make_solid_tree(
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

    # ---- 7a. kernel checks on pose 0 at full width ------------------------
    cam = cams[0]
    with torch.no_grad():
        payload = slab_grad.bake_from_pyramid(tr.pyramid, tr.bmap)
        planar = torch.empty((G, D, G, G), dtype=torch.bfloat16,
                             device=dev).copy_(
            payload.permute(perm[0], 3, perm[1], perm[2]))
        del payload
    geom = slab_render.FrameGeom(tr.grid, cam.transform, cam.fx, cam.fy,
                                 perm, flip, W, H, tr.opt, GI)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=D, bd=bd, fmt=int(tr.grid.fmt),
                            perm=perm, flip=flip, ids=ids, opt=tr.opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    qs = torch.ones(D, device=dev)

    def run_m():
        return slab_march.march_slabs(
            planar, params, qs, zb, G, GI, D, bd, perm, slab_ids=ids,
            flip=flip, bbox_full=True, dir_win=False)

    m = slab_march.march_inputs(planar, params, zb, G, GI, ids)
    sthr = float(m["params"][0, 14])

    def run_m_plain():
        return slab_march.march_slabs_ref(planar, qs, D=D, bd=bd, flip=flip,
                                          **m)

    acc_k = run_m()
    torch.cuda.synchronize()
    acc_p, mt_plain_ms = timed_once(torch, run_m_plain)
    err, flips, nray = freeze_flip_check(
        torch, f"training mode, pose 0, {G} slabs", acc_k, acc_p,
        float(topt.stop_thresh))
    del acc_p
    stats["MT"] = {"max_abs_err": err, "plain_ms": mt_plain_ms,
                   "ms": cuda_ms(torch, run_m, KREPS), "library_ms": None}
    stats["MT"]["bound_ms"], stats["MT"]["bound_by"] = march_bound(
        torch, planar, qs, m["zb"], ids, G, GI, bd, sthr)
    sig_b, col_b, (over,), (pairs,) = march_work(torch, planar, qs, m["zb"],
                                                 ids, G, bd, sthr)
    log(f"train: pose 0's march reads {sig_b} B of sigma planes and {col_b} "
        f"B of colour planes ({over} voxels above the sigma threshold) and "
        f"marches {pairs} (pixel, slab) pairs")

    rng = np.random.default_rng(0)
    gacc4 = torch.as_tensor(rng.normal(size=(4, GI, GI)).astype(np.float32),
                            device=dev)
    acc4 = acc_k[0]

    def run_b():
        return slab_march.march_slabs_bwd(
            planar, params[0], qs, zb[0], gacc4, acc4, G, GI, D, bd, perm,
            flip=flip, bbox_full=True)

    g_k = run_b()
    torch.cuda.synchronize()
    bprm, bzb, bgacc, aux = slab_march.march_bwd_inputs(
        params[0], zb[0], gacc4, acc4, G, GI)
    g_p, mb_plain_ms = timed_once(
        torch, lambda: slab_march.march_slabs_bwd_ref(
            planar, qs, bprm, bzb, bgacc, aux, G, GI, D, bd, flip))
    gk, gp = g_k.double(), g_p.double()
    rel = float((gk - gp).norm() / gp.norm())
    cos = float((gk * gp).sum() / (gk.norm() * gp.norm()))
    mx = float((g_k - g_p).abs().max())
    log(f"kernel M-bwd [pose 0, {G} slabs]: relative L2 {rel:.3e}, cosine "
        f"{cos:.9f}, max |diff| {mx:.3e} (max |plain| "
        f"{float(gp.abs().max()):.3e}); forward freeze flips {flips} of "
        f"{nray} rays (tolerance: relative L2 < {TOL_BWD_REL}, cosine > "
        f"{MIN_BWD_COS})")
    if not (np.isfinite(rel) and rel < TOL_BWD_REL and cos > MIN_BWD_COS):
        fail("the backward kernel disagrees with its plain version")
    del g_k, g_p, gk, gp
    stats["MB"] = {"max_abs_err": mx, "rel_l2": rel, "cosine": cos,
                   "freeze_flips": flips, "plain_ms": mb_plain_ms,
                   "ms": cuda_ms(torch, run_b, KREPS), "library_ms": None}
    stats["MB"]["bound_ms"], stats["MB"]["bound_by"] = march_bwd_bound(
        torch, planar, qs, bzb[None], G, GI, bd, sthr)
    log(f"train kernels: M (training mode) {json.dumps(stats['MT'])}; "
        f"M-bwd {json.dumps(stats['MB'])}")
    del planar, acc_k, acc4, m, aux
    torch.cuda.empty_cache()

    # ---- 7b. timed steps ----------------------------------------------------
    for s in range(TRAIN_WARM * len(cams)):
        tr.step_frame(cams[s % len(cams)], tgt)
    torch.cuda.synchronize()
    plain_calls = count_plain_calls(slab_march)
    slab_march.march_slabs.launches = 0
    slab_march.march_slabs_bwd.launches = 0
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_STEPS * len(cams)
    synced = []
    for s in range(n):
        t0 = time.perf_counter()
        loss = tr.step_frame(cams[s % len(cams)], tgt)
        synced.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(loss):
            fail(f"train: non-finite loss at step {s}")
    t0 = time.perf_counter()
    for s in range(n):
        loss_t = tr.step_frame(cams[s % len(cams)], tgt, sync=False)
    last = float(loss_t)
    pipelined = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(march=slab_march.march_slabs.launches,
                  march_bwd=slab_march.march_slabs_bwd.launches,
                  plain=dict(plain_calls))
    restore_plain(slab_march)
    log(f"train: {2 * n} steps, counts {counts}")
    if (counts["march"] != 2 * n or counts["march_bwd"] != 2 * n
            or sum(plain_calls.values())):
        fail(f"train: a step did not run exactly one launch of each kernel "
             f"and no plain version ({counts})")
    if not np.isfinite(last):
        fail("train: non-finite loss (sync=False)")
    ms_synced = float(np.median(synced))
    log(f"train: median {ms_synced:.3f} ms/step synced (steps {synced}), "
        f"{pipelined:.3f} ms/step with sync=False; peak "
        f"{peak:.3f} GiB allocated; last loss {last:.6f}")
    if "--profile" in sys.argv[1:]:
        profile_run(torch, lambda: tr.step_frame(cams[0], tgt),
                    "training step")
    summary = {"train_ms_synced": ms_synced, "train_ms_pipelined": pipelined,
               "train_peak_gib": peak, "train_counts": counts,
               "train_G": G, "train_steps": 2 * n}
    del tr, tdev, tree
    torch.cuda.empty_cache()
    summary.update(recovery_gate(torch, dev, topt))
    summary["train_counts"] = counts
    return summary


def timed_once(torch, fn):
    """(fn(), its device time in ms): one call between CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


_PLAIN = ("march_slabs_ref", "march_slabs_bwd_ref")


def count_plain_calls(slab_march):
    """Wrap the kernels' plain versions with call counters (the training
    path must not reach them on the card); returns the live counts."""
    calls = {name: 0 for name in _PLAIN}
    for name in _PLAIN:
        fn = getattr(slab_march, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        counted.original = fn
        setattr(slab_march, name, counted)
    return calls


def restore_plain(slab_march):
    for name in _PLAIN:
        setattr(slab_march, name, getattr(slab_march, name).original)


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

    t = time.perf_counter()
    tree = load_tree(CACHE_DEMO, lambda: make_solid_tree(
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
    from volrend_torch.models.synthetic import (make_solid_tree,
                                                make_test_tree)
    from volrend_torch.ops import (dense_grid, display_warp, render_exact,
                                   slab_march, slab_render)
    from volrend_torch.ops.camera import Camera
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

    def setup(path, make, tag):
        t = time.perf_counter()
        tree = load_tree(path, make)
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
        slab_render._warp_to_screen_ref.poses = 0

    def read_counts():
        return dict(
            march=slab_march.march_slabs.launches,
            march_poses=slab_march.march_slabs.poses,
            build=display_warp.build_table.launches,
            combine=display_warp.combine_emit.launches,
            combine_poses=display_warp.combine_emit.poses,
            ref_warp_poses=slab_render._warp_to_screen_ref.poses)

    def main_path(tag, grid, cams, groups, pays, trs):
        """One counted run, then REPS timed runs; returns (counts, frames,
        median ms)."""
        reset_counts()
        frames = render_all(grid, cams, groups, pays, trs)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"{tag}: counts {counts}")
        n = len(cams)
        if counts["ref_warp_poses"] != 0:
            fail(f"{tag}: {counts['ref_warp_poses']} poses fell back to "
                 "the reference warp")
        if counts["march_poses"] != n or counts["combine_poses"] != n:
            fail(f"{tag}: not every pose went through kernels M and C "
                 f"({counts})")
        if min(counts["march"], counts["build"], counts["combine"]) < 1:
            fail(f"{tag}: a kernel of the path never launched ({counts})")
        if tuple(frames.shape) != (n, H, W, 4):
            fail(f"{tag}: frames of shape {tuple(frames.shape)}")
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
        log(f"{tag}: {n} poses, median {ms:.1f} ms "
            f"({n * W * H / ms / 1e3:.1f} Mrays/s); reps (ms, host s) {ts}")
        return counts, frames, ms

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
    tdev, grid = setup(CACHE, lambda: make_test_tree(
        max_depth=DEPTH, basis_dim=BASIS_DIM, seed=3, n_blobs=6,
        sigma_scale=60.0), "dense")
    cams = orbit_poses(Camera, N_POSES)
    groups, pays, trs = groups_of(grid, cams)
    log(f"dense: {len(groups)} pose groups "
        f"{[(k, len(v)) for k, v in groups.items()]}")

    # ---- 3. kernel checks on real inputs ------------------------------------
    bgv = float(opt.background_brightness)
    B_, Wn = (4, 4), (5, 5)          # the cascade level all orbit poses take
    H3, W3 = GI - Wn[0] + 1, GI - Wn[1] + 1
    C = 4 * Wn[0] * Wn[1]
    stats = {k: {"max_abs_err": 0.0} for k in ("M", "B", "C")}

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
        one = march_bound(torch, pay, grid.qscale, m["zb"], slab_ids, G, GI,
                          bd, sthr)
        whole_ms = cuda_ms(torch, run_m, KREPS)
        log(f"kernel M [{tag}, {P} poses]: {whole_ms:.3f} ms per launch, "
            f"bound {one[0]:.3f} ms ({one[1]})")
        if not time_it:
            return

        # kernel M's row: one launch over the poses its plain version ran;
        # the main path's launch of the whole group is kept beside it
        stats["M_group"] = {"poses": P, "ms": whole_ms, "bound_ms": one[0],
                            "bound_by": one[1]}
        stats["M"]["poses"] = len(sub)
        stats["M"]["ms"] = cuda_ms(
            torch, lambda: run_m(params[sub], zb[sub]), KREPS)
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
        cflops = P * H * W * (Wn[0] * Wn[1] * 9 + 30)
        stats["C"]["bound_ms"], stats["C"]["bound_by"] = bound(cbytes,
                                                               cflops)
        stats["C"]["library_ms"] = None
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
    counts, frames, ms = main_path("dense", grid, cams, groups, pays, trs)
    mrays = N_POSES * W * H / ms / 1e3
    if "--profile" in sys.argv[1:]:
        profile_run(torch, lambda: render_all(grid, cams, groups, pays, trs),
                    "dense main path")

    # ---- 5. quality gate ----------------------------------------------------
    p_orbit = gate("dense orbit0", tdev, cams[0], frames[0], 5, FLOOR_ORBIT)
    del frames, pays, trs, grid, tdev
    torch.cuda.empty_cache()

    # ---- 6. sparse scene ----------------------------------------------------
    sdev, sgrid = setup(CACHE_SPARSE, lambda: make_solid_tree(
        max_depth=DEPTH, basis_dim=BASIS_DIM, seed=3), "sparse")
    scams = orbit_poses(Camera, N_POSES_SPARSE)
    sgroups, spays, strs = groups_of(sgrid, scams)
    crops = {perm: slab_render.inplane_crop(sgrid, perm,
                                            float(opt.sigma_thresh))
             for perm in spays}
    occupied = [len(sgrid.slab_ids(a, False, opt.sigma_thresh))
                for a in (0, 1, 2)]
    log(f"sparse: {len(sgroups)} pose groups, crops {crops}, occupied "
        f"slabs per axis {occupied}")
    # the cropped payloads and culled slab lists at full width: the first
    # pose group of each perm, as the main path launches it
    seen = set()
    for (perm, flip), idx in sgroups.items():
        if perm not in seen:
            seen.add(perm)
            check_kernels(f"sparse group {perm}/{flip}", sgrid, spays,
                          [scams[i] for i in idx], False)
    torch.cuda.empty_cache()
    scounts, sframes, sms = main_path("sparse", sgrid, scams, sgroups,
                                      spays, strs)
    smrays = N_POSES_SPARSE * W * H / sms / 1e3
    p_sparse = gate("sparse orbit0", sdev, scams[0], sframes[0], 8,
                    FLOOR_SPARSE)

    del sframes, spays, strs, sgrid, sdev
    torch.cuda.empty_cache()

    # ---- 7-8. training ------------------------------------------------------
    tsum = train_phase(torch, dev, stats)

    # ---- 9. result ----------------------------------------------------------
    summary = {"card": card, "dense_mrays": mrays, "dense_ms": ms,
               "sparse_mrays": smrays, "sparse_ms": sms,
               "psnr_orbit_db": p_orbit, "psnr_sparse_db": p_sparse,
               "dense_counts": counts, "sparse_counts": scounts, **tsum,
               "seconds": time.perf_counter() - _T0}
    log(f"summary {json.dumps(summary)}")
    spec = (
        ("M", "slab_march", "volrend_torch/csrc/slab_march.cu",
         "volrend_tpu/ops/pallas_slab.py:344", counts["march"]),
        ("B", "warp_build", "volrend_torch/csrc/warp_build.cu",
         "volrend_tpu/ops/display_warp.py:139", counts["build"]),
        ("C", "warp_combine", "volrend_torch/csrc/warp_combine.cu",
         "volrend_tpu/ops/display_warp.py:228", counts["combine"]),
        ("MT", "slab_march_train", "volrend_torch/csrc/slab_march.cu",
         "volrend_tpu/ops/pallas_slab.py:344",
         tsum["train_counts"]["march"]),
        ("MB", "slab_march_bwd", "volrend_torch/csrc/slab_march_bwd.cu",
         "volrend_tpu/ops/pallas_slab.py:951",
         tsum["train_counts"]["march_bwd"]),
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
