"""The training march's launch configurations on the training bench: the
evidence behind the one the kernels are built with (``tmarch::CONFIG`` in
``csrc/slab_common.cuh``).

On pose 0 of the training bench (``make_solid_tree(max_depth=7,
basis_dim=9, seed=7)``, G=256 SH9, 800^2, gi=256, the bake's f32 tensor
through the group's permutation, as ``FrameTrainer`` marches it), times
kernel M's training mode and the backward kernel at each tile shape
(rows x columns), threads a block, ring depth (the jobs whose sigma is
staged ahead), colour prefetch distance and record slots a thread, all on
one coarse occupancy (``march_occupancy``, timed apart). Each
configuration is a build of its own: ``csrc/slab_march.cu`` and
``csrc/slab_march_bwd.cu`` compiled with its ``-DVT_TM_*`` values and
``-DVT_TM_CYCLES`` (thread 0's clock cycles by part of the loop and the
slowest block's, ``tmarch::Clock``) into ``build/volrend_torch/
train_march/``, apart from ``kernels.SOURCES``; the port's wrappers run
on it while its libraries stand in for the port's. Each launch's counts
(``slab_march.N_COUNTS``) and cycles are logged beside its time, and the
port's own launches are traced (torch.profiler) to split them into their
kernels. Each configuration's output is held to the port's: kernel M's
within 1e-3 but for stop-threshold freeze flips (the pieces' side sets
the order of the tap sums), the backward's to relative L2 1e-4 (its
global atomics add in a run-dependent order).

``--cases SH9,SG9,ASG9,SG6`` instead times the formats and options at the
port's own configuration, each case as ``chip_smoke.TRAIN_CASES`` builds it
(``case_spec``): the training bench's leaves read as SG and ASG trees of any
lobe count and as an RGBA tree (``_common.format_trees``), the SH9 tree itself
(SH9, the baseline) and with its render options (SH9-rot, SH9-window,
SH9-bbox: the SH option variant); a ``-bf16`` suffix marches the lean
trainer's bf16 cast and writes a bf16 cotangent. Each is baked by its own
``FrameTrainer``. For each case and build it times kernel M
and M-bwd on pose 0, splits M-bwd into pass 1, pass 2 and the cotangent
buffer's fill (torch.profiler), reads thread 0's cycles by part of the loop
from a ``-DVT_TM_CYCLES`` build with each block's loop cycles and jobs
(``m_blocks``: the cycles' mean, 99th percentile and slowest, the slowest
block's tile, its pieces run and shaded and its cycles a piece), and reads
every launch's registers, local bytes and blocks per SM
(``vt_march_slabs_info``, ``vt_march_slabs_bwd_info``), and the device
memory M-bwd's call holds above what was allocated before it
(``bwd_alloc_mib``: its output and its buffers). Both kernels' outputs are
held to the port's plain versions
(``march_slabs_ref``, ``march_slabs_bwd_ref``) at chip_smoke.py's tolerances.
``--parent DIR`` builds the same two sources of another checkout (an unpacked
parent; the C entry points must be the same) and times it in turns with this
one: parent, change, change, parent; kernel M's outputs are compared with the
parent's bit for bit (``m_bit_equal_parent``) and every library's SASS
function by function (``sass``); ``--builds parent`` times the parent alone
(before a change runs on the card); ``--alt FLAGS`` builds this checkout again
with extra nvcc flags (a build-time alternative a source reads as a macro;
several separated by ``;``) and times each between them. Each build's
instantiations in the libraries the cases need (the SH defaults, SH with
options and RGBA, SG and ASG at every lobe bound) are listed by their
launches (``variant_info``).

Every time is the card's: CUDA events around back-to-back launches queued
behind a device sleep, median of three runs. Run on a card from the root of
the checkout::

    python -m volrend_torch.probes.train_march [--configs 8:8:128:4:2:1,...]
        [--out train_march.json]
    python -m volrend_torch.probes.train_march --cases SH9,SG9,ASG9,SG6
        [--parent DIR] [--alt "FLAGS;FLAGS"] [--out cases.json]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
from typing import NamedTuple, Optional

import numpy as np
import torch

from volrend_torch import kernels
from volrend_torch.probes import _common as c
from volrend_torch.probes.display_tiles import device_ms
from volrend_torch.utils.options import RenderOptions

GI = 256
W = H = 800
CACHE_TRAIN = os.path.join(c._ROOT, ".torch_bench_train_cache.npz")
#: (tile rows, columns, threads a block, sigma ring depth, colour prefetch
#: distance, record slots a thread); the piece side is 2 * max(rows,
#: columns) + 8
CONFIGS = ((16, 16, 256, 4, 2, 1), (8, 8, 64, 4, 2, 2), (8, 8, 128, 4, 2, 1),
           (8, 8, 256, 4, 2, 1), (4, 8, 64, 4, 2, 1), (4, 8, 128, 1, 0, 1),
           (4, 8, 128, 2, 0, 1), (4, 8, 128, 4, 0, 1), (4, 8, 128, 4, 2, 1),
           (4, 8, 128, 8, 2, 1), (4, 8, 256, 4, 2, 1), (4, 4, 128, 4, 2, 1))
#: a configuration's fields, as the VT_TM_* macros name them
_KEYS = ("ty", "tx", "nt", "ps", "ring", "dc", "rslots")
#: the libraries a configuration's build replaces
_LIB_NAMES = ("slab_march", "slab_march_bwd")
#: the parts of tmarch::Clock, then the loop's cycles summed and largest
_PARTS = ("queue", "decide", "shade", "taps", "composite", "list",
          "loop_sum", "loop_max")


def _load(path, name: str, clock: bool) -> ctypes.CDLL:
    """A probe build's library ``name`` at ``path``, its entries typed (a
    clock build's readers too, where it has them: an older checkout's
    build may lack the per-block reader)."""
    lib = c.typed_lib(path, name)
    if clock:
        for fn, argtypes in (("vt_train_cycles", [ctypes.c_void_p]),
                             ("vt_train_blocks",
                              [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int])):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
    return lib


def build(configs) -> dict:
    """Compile each configuration's two libraries (one nvcc each, all
    started together, with the port's flags) and load them:
    {config: {library name: CDLL}}."""
    out_dir = kernels.build_dir() / "train_march"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tc in configs:
        flags = [f"-DVT_TM_{k.upper()}={v}" for k, v in zip(_KEYS, tc)]
        tag = "_".join(map(str, tc))
        for name in _LIB_NAMES:
            out = out_dir / f"lib{name}_{tag}.so"
            src = kernels._CSRC / kernels.SOURCES[name][0]
            procs.append((tc, name, out, subprocess.Popen(
                [kernels._nvcc(), *kernels._NVCC_FLAGS, *flags,
                 "-DVT_TM_CYCLES", "-o", str(out), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {}
    for tc, name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"train_march: build of {name} at {tc} "
                               f"failed:\n{log}")
        libs.setdefault(tc, {})[name] = _load(out, name, True)
    return libs


@contextlib.contextmanager
def _standing_in(libs: dict):
    """The port's wrappers launch ``libs`` (a configuration's build) in
    place of the port's libraries while the block runs."""
    saved = {k: kernels._LIBS.get(k) for k in libs}
    kernels._LIBS.update(libs)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                kernels._LIBS.pop(k, None)
            else:
                kernels._LIBS[k] = v


def _cycles(lib) -> dict:
    """The build's clock (read and cleared) after one launch."""
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * len(_PARTS))()
    kernels.check(lib.vt_train_cycles(out), "slab_march")
    return dict(zip(_PARTS, out))


def _blocks(lib, gi: int, P: int, tile=(4, 8)) -> Optional[dict]:
    """The last launch's loop cycles and jobs by block (read and cleared;
    None for a build that does not keep them): the cycles' mean, 99th
    percentile, slowest, their ratios to the mean; the slowest block's
    pose and tile (its pixel rows and columns on the slope grid; ``tile``:
    the build's rows and columns a tile), its jobs run and shaded and its
    cycles a job run; the jobs' mean and largest over the blocks."""
    if not hasattr(lib, "vt_train_blocks"):
        return None
    ty, tx = tile
    gx, gy = -(-gi // tx), -(-gi // ty)
    n = gx * gy * P
    out = (ctypes.c_ulonglong * n)()
    jobs = (ctypes.c_ulonglong * n)()
    torch.cuda.synchronize()
    kernels.check(lib.vt_train_blocks(out, jobs, n), "slab_march")
    a = np.frombuffer(out, dtype=np.uint64).astype(np.float64)
    j = np.frombuffer(jobs, dtype=np.uint64)
    run, shaded = (j & 0xffffffff).astype(np.float64), (j >> 32).astype(
        np.float64)
    i = int(a.argmax())
    bx, by, p = i % gx, (i // gx) % gy, i // (gx * gy)
    mean = float(a.mean())
    p99 = float(np.percentile(a, 99))
    return {"blocks": n, "mean": mean, "p99": p99, "max": float(a[i]),
            "p99_over_mean": p99 / max(mean, 1.0),
            "max_over_mean": float(a[i]) / max(mean, 1.0),
            "slowest": {"pose": p, "rows": [by * ty, by * ty + ty - 1],
                        "cols": [bx * tx, bx * tx + tx - 1],
                        "jobs_run": int(run[i]), "jobs_shaded": int(shaded[i]),
                        "cycles_a_job": float(a[i]) / max(float(run[i]), 1.0)},
            "jobs_run_mean": float(run.mean()), "jobs_run_max": int(run.max()),
            "jobs_shaded_mean": float(shaded.mean())}


def _bench_tree(dev):
    """The training bench's SH9 tree on ``dev``."""
    from volrend_torch.models.synthetic import make_solid_tree
    tree = c.load_tree(CACHE_TRAIN, lambda: make_solid_tree(
        max_depth=7, basis_dim=9, seed=7))
    return tree.to_device(lut_depth=None, device=dev)


def _pose0(dev, tdev=None, options=None):
    """The training bench's trainer (on ``tdev``, default the SH9 tree,
    with the render ``options``) and pose 0's march inputs (the bake's f32
    view, params, z interval, slab ids, config)."""
    from volrend_torch import train
    from volrend_torch.ops import slab_grad, slab_render
    from volrend_torch.ops.camera import Camera

    tr = train.FrameTrainer(_bench_tree(dev) if tdev is None else tdev,
                            opt=RenderOptions(max_steps=1024).replace(
                                **(options or {})), lr=5e-2, gi=GI)
    back = np.array([np.cos(0.25), np.sin(0.25), 0.45])
    back /= np.linalg.norm(back)
    cam = Camera.from_vectors(center=tuple(2.6 * back), v_back=tuple(back),
                              width=W, height=H)
    perm, flip = tr._group(cam)
    G = tr.grid.G
    with torch.no_grad():
        bake = slab_grad.bake_from_pyramid(tr.pyramid, tr.bmap)
    geom = slab_render.FrameGeom(tr.grid, cam.transform, cam.fx, cam.fy,
                                 perm, flip, W, H, tr.opt, GI)
    ids = tuple(range(G - 1, -1, -1) if flip else range(G))
    cfg = slab_grad.SlabCfg(G=G, gi=GI, D=tr.grid.data_dim,
                            bd=tr.grid.basis_dim, fmt=int(tr.grid.fmt),
                            perm=perm, flip=flip, ids=ids, opt=tr.opt)
    params = slab_grad._pack_geom_params(geom, cfg, 1.0 / geom.scale)
    zb = torch.stack([geom.z_lo_pix, geom.z_hi_pix], 1)
    return (bake.permute(perm[0], 3, perm[1], perm[2]), params, zb, cfg,
            tr.grid.extra)


def run(dev, configs=CONFIGS) -> dict:
    from volrend_torch.ops import slab_march
    configs = [tuple(tc[:3]) + (2 * max(tc[:2]) + 8,) + tuple(tc[3:])
               for tc in configs]
    libs = build(configs)
    planar, params, zb, cfg, _ = _pose0(dev)
    G, D, bd, flip = cfg.G, cfg.D, cfg.bd, cfg.flip
    qs = torch.ones(D, device=dev)
    m = slab_march.march_inputs(planar, params, zb, G, GI, cfg.ids)
    # the coarse occupancy both kernels share, built once (timed apart)
    occ = slab_march.march_occupancy(planar, m["params"], qs)
    occ_ms = device_ms(lambda: slab_march.march_occupancy(
        planar, m["params"], qs))

    def fwd(counts=None):
        return slab_march._march_train_cuda(planar, qs, D=D, bd=bd,
                                            flip=flip, counts=counts,
                                            occ=occ, **m)

    acc0 = fwd()
    rng = np.random.default_rng(0)
    gacc4 = torch.as_tensor(rng.normal(size=(4, GI, GI)).astype(np.float32),
                            device=dev)
    prm, bzb, bg, aux = slab_march.march_bwd_inputs(params[0], zb[0], gacc4,
                                                    acc0[0], G, GI)

    def bwd(counts=None):
        return slab_march._march_bwd_cuda(planar, prm, qs, bzb, bg, aux, G,
                                          GI, D, bd, flip, torch.float32,
                                          counts=counts, occ=occ)

    g0 = bwd().double()

    def _measure(row, lib):
        cnt = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64,
                          device=dev)
        acc = fwd(cnt)
        row["m_cycles"] = _cycles(lib["slab_march"])
        row["m_counts"] = cnt.tolist()
        d = (acc - acc0).abs().amax(1)
        row["m_max_diff"] = float(d.max())
        row["m_rays_past_1e-3"] = int((d > 1e-3).sum())
        row["m_ms"] = device_ms(fwd)
        cnt = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64,
                          device=dev)
        g = bwd(cnt).double()
        row["bwd_cycles"] = _cycles(lib["slab_march_bwd"])
        row["bwd_counts"] = cnt.tolist()
        row["bwd_rel_l2"] = float((g - g0).norm() / g0.norm())
        row["bwd_ms"] = device_ms(bwd)

    rows = []
    for tc in configs:
        row = dict(zip(_KEYS, tc))
        try:
            with _standing_in(libs[tc]):
                _measure(row, libs[tc])
        except RuntimeError as e:
            # the card refuses a block more shared memory than it has
            if "invalid argument" not in str(e):
                raise
            row["refused"] = str(e)
        rows.append(row)
        c.log(f"train_march {json.dumps(row)}")
        if row.get("bwd_rel_l2", 0) > 1e-4 or row.get(
                "m_max_diff", 0) > float(cfg.opt.stop_thresh) + 1e-3:
            raise RuntimeError(f"configuration {tc} disagrees with the "
                               f"port's build")

    # the port's launches split into their kernels (occupancy, march,
    # backward passes, the memsets) on the card
    parts = {}
    for tag, fn in (("M", fwd), ("M-bwd", bwd)):
        prof = c.profile_run(fn, f"train_march {tag} (the port's build)")
        parts[tag] = {k: v[0] for k, v in prof.items()}
    return {"device": torch.cuda.get_device_name(0),
            "occupancy_ms": occ_ms, "configs": rows, "parts_ms": parts}


# ---- --cases: the formats at the port's configuration ----------------------

#: the libraries a checkout's training pair is built as for --cases: the
#: defaults, the SH option and RGBA set and the SG/ASG set (VT_TRAIN_SET;
#: kernels._FLAGS), each a kernel M and an M-bwd library
_SET_SUFFIX = {0: "", 1: "_opt", 2: "_lobes"}
_CASE_LIBS = tuple((f"{kind}{suffix}", tset)
                   for tset, suffix in _SET_SUFFIX.items()
                   for kind in ("slab_march", "slab_march_bwd"))
#: chip_smoke.py's tolerances against the plain versions: M's acc (but
#: stop-threshold freeze flips), M-bwd's relative L2 (f32, bf16 cotangent)
_TOL_M, _TOL_BWD = 1e-3, {torch.float32: 1e-3, torch.bfloat16: 4e-3}


def start_checkout(root: str, tag: str, flags=(), clock=True,
                   sets=(0, 1, 2)) -> list:
    """Start compiling the training pair of the checkout at ``root`` (its
    ``volrend_torch/csrc``, with the extra nvcc ``flags``) as the
    _CASE_LIBS of the VT_TRAIN_SET ``sets``, each without and (``clock``)
    with the clock (``-DVT_TM_CYCLES``), one nvcc each, into
    ``build/volrend_torch/train_march/<tag>/``; ``finish_checkout`` waits
    for them."""
    from pathlib import Path
    csrc = Path(root) / "volrend_torch" / "csrc"
    out_dir = kernels.build_dir() / "train_march" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for clock in (False, True) if clock else (False,):
        for name, tset in _CASE_LIBS:
            if tset not in sets:
                continue
            out = out_dir / f"lib{name}{'_clock' if clock else ''}.so"
            src = csrc / kernels.SOURCES[name][0]
            procs.append((tag, clock, name, out, subprocess.Popen(
                [kernels._nvcc(), *kernels._NVCC_FLAGS, *flags,
                 f"-DVT_TRAIN_SET={tset}",
                 *(["-DVT_TM_CYCLES"] if clock else []), "-o", str(out),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_checkout(procs: list) -> dict:
    """Wait for ``start_checkout``'s compiles and load them: {clock:
    {library: CDLL}}; raises with the log of a build that failed."""
    libs = {}
    for tag, clock, name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"train_march: build of {name} ({tag}) "
                               f"failed:\n{log}")
        libs.setdefault(clock, {})[name] = _load(out, name, clock)
    return libs


#: the library of kernel M's SH option and RGBA variants, whose clock build chip_smoke.py's phase 12b reads
#: (start_probe_build)
PROBE_LIB = "slab_march_opt"


def start_probe_build():
    """Start compiling the clock build (``-DVT_TM_CYCLES``) of PROBE_LIB,
    with the port's flags, into ``build/volrend_torch/train_march/``
    unless it is built: keyed, as the port's libraries are, by the source,
    the shared headers and the flags. ``load_probe_build`` waits for it."""
    out = kernels.build_dir() / "train_march" / kernels._target(
        PROBE_LIB).name.replace(f"lib{PROBE_LIB}_",
                                f"lib{PROBE_LIB}_cycles_")
    return c.start_nvcc(
        out, kernels._CSRC / kernels.SOURCES[PROBE_LIB][0],
        (*kernels._FLAGS.get(PROBE_LIB, []), "-DVT_TM_CYCLES"))


def load_probe_build(started) -> ctypes.CDLL:
    """Wait for ``start_probe_build``'s compile and load the library
    (raises with the log if the build failed)."""
    return _load(c.finish_nvcc(started, "train_march: the probe build"),
                 PROBE_LIB, True)


def probe_launch(lib, fwd, gi: int, P: int) -> dict:
    """One launch of ``fwd`` (kernel M's training mode, an option variant)
    on the clock build ``lib`` of PROBE_LIB: its output, thread 0's cycles
    by part, and each block's loop cycles and jobs (_blocks)."""
    with _standing_in({PROBE_LIB: lib}):
        _cycles(lib), _blocks(lib, gi, P)  # cleared
        acc = fwd()
        return {"acc": acc, "cycles": _cycles(lib),
                "blocks": _blocks(lib, gi, P)}


def sass_compare(parent: dict, change: dict) -> dict:
    """The SASS of two builds' libraries (``finish_checkout``'s CDLLs
    without the clock), function by function (cuobjdump, as
    probes/display_sass reads it): per library, the functions equal and
    those that differ or are missing from one build."""
    from volrend_torch.probes.display_sass import functions
    out = {}
    for name in sorted(set(parent) & set(change)):
        a, b = functions(parent[name]._name), functions(change[name]._name)
        out[name] = {
            "equal": sum(a[k] == b[k] for k in set(a) & set(b)),
            "differ": sorted(k for k in set(a) & set(b) if a[k] != b[k]),
            "parent_only": sorted(set(a) - set(b)),
            "change_only": sorted(set(b) - set(a))}
    return out


#: the render options of the SH9 option cases, as chip_smoke.TRAIN_CASES
#: sets them
CASE_OPTIONS = {"rot": dict(rot_dirs=(0.3, -0.2, 0.5)),
                "window": dict(basis_minmax=(0, 3)),
                "bbox": dict(render_bbox=(0.25,) * 3 + (0.75,) * 3)}


class Case(NamedTuple):
    """A --cases case: the tree's format (SH, SG, ASG, RGBA), its lobe
    count or SH basis functions (None for RGBA), the render options and
    the payload's dtype (the cotangent's too)."""
    fmt: str
    nb: Optional[int]
    options: dict
    dtype: torch.dtype


def case_spec(name: str) -> Case:
    """What --cases marches for ``name``: SH9 (the training bench's tree),
    SH9-rot, SH9-window, SH9-bbox (with CASE_OPTIONS), SG<n> and ASG<n>
    (1 <= n <= 25 lobes), RGBA; each with an optional -bf16 suffix (the
    lean trainer's payload). Raises ValueError for any other name."""
    base, bf16 = (name[:-5], True) if name.endswith("-bf16") else (name,
                                                                    False)
    dtype = torch.bfloat16 if bf16 else torch.float32
    fmt, _, option = base.partition("-")
    if fmt == "SH9" and (not option or option in CASE_OPTIONS):
        return Case("SH", 9, dict(CASE_OPTIONS.get(option, {})), dtype)
    if fmt == "RGBA" and not option:
        return Case("RGBA", None, {}, dtype)
    for lobes in ("ASG", "SG"):
        n = fmt[len(lobes):]
        if (fmt.startswith(lobes) and not option and n.isdigit()
                and 1 <= int(n) <= 25 and not n.startswith("0")):
            return Case(lobes, int(n), {}, dtype)
    raise ValueError(f"train_march: unknown case {name!r} (SH9, SH9-rot, "
                     f"SH9-window, SH9-bbox, SG<n>, ASG<n>, RGBA, each with "
                     f"an optional -bf16)")


def _case_tree(spec: Case, tdev):
    """Case ``spec``'s tree: the SH9 bench tree, or its leaves read as SG
    or ASG lobes (SG6: the first six coefficients a colour) or as RGBA."""
    if spec.fmt == "SH":
        return tdev
    if spec.fmt == "RGBA":
        return c.format_trees(tdev)["RGBA"]
    return c.format_trees(tdev, nb=spec.nb)[spec.fmt]


def _case_set(spec: Case) -> int:
    """The VT_TRAIN_SET of the library that marches case ``spec``."""
    if spec.fmt in ("SG", "ASG"):
        return 2
    return 1 if spec.fmt == "RGBA" or spec.options else 0


def _split(prof: dict) -> dict:
    """M-bwd's traced kernels by part: pass 1, pass 2, and the rest (the
    cotangent buffer's fill and the output's allocation)."""
    out = {"pass1": 0.0, "pass2": 0.0, "fill": 0.0}
    for kname, (ms, _n, _mx) in prof.items():
        key = ("pass1" if "bwd_march" in kname
               else "pass2" if "bwd_shade" in kname else "fill")
        out[key] += ms
    return out


def _parts(fn, tag: str):
    """M-bwd's parts (_split) from a trace of one call of ``fn``; None if
    the profiler caught no device activity twice (it can miss a trace)."""
    for _ in range(2):
        try:
            return _split(c.profile_run(fn, f"train_march {tag}"))
        except RuntimeError as e:
            if "no device activity" not in str(e):
                raise
            c.log(f"train_march {tag}: {e}")
    return None


def _info(libs: dict, fmt: int, bd: int, f32: bool, opt: bool) -> dict:
    """The launches of an instantiation (format ``fmt``, option variant or
    not) in ``libs``."""
    suffix = _SET_SUFFIX[2 if fmt in (2, 3) else int(opt)]
    fwd = libs["slab_march" + suffix]
    bwd = libs["slab_march_bwd" + suffix]
    m = (ctypes.c_int * 11)()
    b = (ctypes.c_int * 7)()
    args = (bd, int(f32), fmt, int(opt))
    kernels.check(fwd.vt_march_slabs_info(*args, m), "slab_march")
    kernels.check(bwd.vt_march_slabs_bwd_info(*args, b), "slab_march_bwd")
    keys = ("blocks_per_sm", "regs", "local_bytes", "smem")
    return {"M": dict(zip(keys, m[:4])), "pass1": dict(zip(keys, b[:4])),
            "pass2": dict(zip(keys[:3], b[4:]))}


def _info_or_none(libs: dict, fmt: int, bd: int, f32: bool,
                  opt: bool) -> Optional[dict]:
    """_info, or None for an instantiation the build refuses: one whose
    block needs more shared memory than the card gives one (an --alt
    build's)."""
    try:
        return _info(libs, fmt, bd, f32, opt)
    except RuntimeError as e:
        if "invalid argument" not in str(e):
            raise
        return None


def variant_info(libs: dict) -> dict:
    """A build's instantiations by bound and payload (_info_or_none), keyed
    as probes/train_info.py keys them, of the libraries it holds: the SH
    defaults, SH with options and RGBA, SG and ASG by lobe bound."""
    out = {}
    for f32 in (True, False):
        pay = "f32" if f32 else "bf16"
        if "slab_march_opt" in libs:
            out[f"RGBA-{pay}"] = _info_or_none(libs, 0, -1, f32, True)
        for bound in (1, 4, 9, 16, 25):
            for name, fmt, opt in (("SH", 1, False), ("SH", 1, True),
                                   ("SG", 2, True), ("ASG", 3, True)):
                if bound == 1 and fmt > 1:
                    continue
                suffix = _SET_SUFFIX[2 if fmt > 1 else int(opt)]
                if "slab_march" + suffix not in libs:
                    continue
                key = (f"SH{bound}{'-opt' if opt else ''}" if fmt == 1
                       else f"{name}<={bound}")
                out[f"{key}-{pay}"] = _info_or_none(libs, fmt, bound, f32,
                                                    opt)
    return out


#: the builds --cases can time: this checkout's and the parent's
BUILDS = ("change", "parent")


def run_cases(dev, cases, parent=None, alt=None, only=BUILDS) -> dict:
    """--cases: each case's M and M-bwd on pose 0 for this checkout's
    build (and ``parent``'s, and this checkout's built with each flag set
    of ``alt``, in turns), as the module's docstring says; ``only`` keeps
    some of BUILDS (the alternatives are timed whenever given)."""
    from volrend_torch.ops import slab_grad, slab_march
    specs = {case: case_spec(case) for case in cases}
    sets = sorted({0} | {_case_set(s) for s in specs.values()})
    alts = [a for a in (alt or "").split(";") if a.strip()]
    # every build's nvcc started together, then waited for
    started = {}
    if "change" in only:
        started["change"] = start_checkout(c._ROOT, "change", sets=sets)
    if parent is not None and "parent" in only:
        started["parent"] = start_checkout(parent, "parent", sets=sets)
    for i, flags in enumerate(alts):
        started[f"alt{i}"] = start_checkout(c._ROOT, f"alt{i}",
                                            flags.split(), clock=False,
                                            sets=sets)
    builds = {t: finish_checkout(p) for t, p in started.items()}
    tags = [t for t in ("parent", "change") if t in builds] + [
        f"alt{i}" for i in range(len(alts))]
    order = tags + tags[::-1] if len(tags) > 1 else tags
    infos = {t: variant_info(b[False]) for t, b in builds.items()}
    for t, info in infos.items():
        c.log(f"train_march variant_info ({t}"
              f"{': ' + alts[int(t[3:])] if t.startswith('alt') else ''}): "
              f"{json.dumps(info)}")
    sass = None
    if "parent" in builds and "change" in builds:
        sass = sass_compare(builds["parent"][False], builds["change"][False])
        c.log(f"train_march SASS against the parent: {json.dumps(sass)}")
    tdev = _bench_tree(dev)
    out = {}
    for case in cases:
        spec = specs[case]
        dt = spec.dtype
        planar, params, zb, cfg, extra = _pose0(dev, _case_tree(spec, tdev),
                                                spec.options)
        planar = planar if dt == torch.float32 else planar.to(dt)
        G, D, bd, flip = cfg.G, cfg.D, cfg.bd, cfg.flip
        qs = torch.ones(D, device=dev)
        st = slab_grad._kernel_statics(cfg)
        mode = slab_march.MarchMode(cfg.fmt, extra, False, st["rot"],
                                    st["bbox_full"], st["basis_lo"],
                                    st["basis_hi"])
        m = slab_march.march_inputs(planar, params, zb, G, GI, cfg.ids)
        occ = slab_march.march_occupancy(planar, m["params"], qs)
        gacc4 = torch.as_tensor(np.random.default_rng(0).normal(
            size=(4, GI, GI)).astype(np.float32), device=dev)

        def fwd(counts=None):
            return slab_march._march_train_cuda(
                planar, qs, D=D, bd=bd, flip=flip, counts=counts, occ=occ,
                mode=mode, **m)

        st.pop("flip")
        acc_p = slab_march.march_slabs_ref(planar, qs, D=D, bd=bd, flip=flip,
                                           extra=extra, **st, **m)
        prm, bzb, bg, aux = slab_march.march_bwd_inputs(
            params[0], zb[0], gacc4, acc_p[0], G, GI)

        def bwd(counts=None):
            return slab_march._march_bwd_cuda(
                planar, prm, qs, bzb, bg, aux, G, GI, D, bd, flip, dt,
                counts=counts, occ=occ, mode=mode)

        g_p = slab_march.march_slabs_bwd_ref(planar, qs, prm, bzb, bg, aux,
                                             G, GI, D, bd, flip,
                                             mode=mode).double()
        rows, outs = {}, {}
        for tag in order:
            libs = builds[tag]
            with _standing_in(libs[False]):
                m_ms, bwd_ms = device_ms(fwd), device_ms(bwd)
                row = rows.setdefault(tag, {"m_ms": [], "bwd_ms": []})
                row["m_ms"].append(m_ms)
                row["bwd_ms"].append(bwd_ms)
                if "parts_ms" in row:
                    continue
                outs[tag] = fwd()
                d = (outs[tag] - acc_p).abs().amax(1)
                # the device memory M-bwd's call holds above what was
                # allocated before it: its output and its buffers
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                g = bwd()
                torch.cuda.synchronize()
                row["bwd_alloc_mib"] = (torch.cuda.max_memory_allocated()
                                        - base) / 2**20
                g = g.double()
                row["m_max_diff"] = float(d.max())
                row["m_rays_past_tol"] = int((d > _TOL_M).sum())
                row["bwd_rel_l2"] = float((g - g_p).norm() / g_p.norm())
                del g
                row["parts_ms"] = _parts(bwd, f"{case} M-bwd ({tag})")
                row["info"] = _info(libs[False], cfg.fmt, bd,
                                    dt == torch.float32, mode.options(bd))
            if (row["bwd_rel_l2"] > _TOL_BWD[dt] or row["m_max_diff"]
                    > float(cfg.opt.stop_thresh) + _TOL_M):
                raise RuntimeError(f"train_march {case} ({tag}) disagrees "
                                   f"with the plain versions: {row}")
            suffix = _SET_SUFFIX[_case_set(spec)]
            if True not in libs:  # an --alt build: no clock
                continue
            with _standing_in(libs[True]):
                cnt = torch.zeros(slab_march.N_COUNTS, dtype=torch.int64,
                                  device=dev)
                fwd(cnt)
                lib = libs[True]["slab_march" + suffix]
                row["m_cycles"] = _cycles(lib)
                row["m_blocks"] = _blocks(lib, GI, 1)
                row["m_counts"] = cnt.tolist()
                cnt.zero_()
                bwd(cnt)
                row["bwd_cycles"] = _cycles(libs[True][
                    "slab_march_bwd" + suffix])
                row["bwd_counts"] = cnt.tolist()
        # kernel M's output bit for bit against the parent's build's
        for tag in outs:
            if tag != "parent" and "parent" in outs:
                rows[tag]["m_bit_equal_parent"] = bool(
                    torch.equal(outs[tag], outs["parent"]))
        for tag, row in rows.items():
            c.log(f"train_march {case} ({tag}): {json.dumps(row)}")
        out[case] = rows
        del planar, acc_p, g_p, occ, m, outs
        torch.cuda.empty_cache()
    return {"device": torch.cuda.get_device_name(0), "alts": alts,
            "variant_info": infos, "sass": sass, "cases": out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default=",".join(
        ":".join(map(str, k)) for k in CONFIGS),
                    help="rows:columns:threads:ring:colour distance:record "
                    "slots, comma-separated")
    ap.add_argument("--cases", default=None,
                    help="time these formats at the port's configuration "
                    "instead (SH9, SH9-rot, SH9-window, SH9-bbox, SG<n>, "
                    "ASG<n>, RGBA; a -bf16 suffix the lean trainer's "
                    "payload), comma-separated")
    ap.add_argument("--parent", default=None,
                    help="with --cases: a parent checkout to time in turns")
    ap.add_argument("--alt", default=None,
                    help="with --cases: extra nvcc flags of another build "
                    "of this checkout to time in turns (several: separated "
                    "by ';')")
    ap.add_argument("--builds", default=",".join(BUILDS),
                    help="with --cases: the builds to time, of "
                    f"{','.join(BUILDS)} (the parent needs --parent)")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_march: needs a CUDA device")
    if args.cases:
        for case in args.cases.split(","):
            case_spec(case)  # an unknown case fails before any build
        out = run_cases(torch.device("cuda"), args.cases.split(","),
                        args.parent, args.alt,
                        tuple(args.builds.split(",")))
    else:
        configs = [tuple(int(v) for v in k.split(":"))
                   for k in args.configs.split(",")]
        out = run(torch.device("cuda"), configs)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
