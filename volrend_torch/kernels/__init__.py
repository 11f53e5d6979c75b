"""Build and load the port's hand-written CUDA kernels.

Each source in ``volrend_torch/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface, at first use, for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), into ``build/volrend_torch/``
at the root of the checkout (git-ignored), or, for an installed package,
into ``$XDG_CACHE_HOME/volrend_torch`` (``~/.cache`` by default).
Libraries are keyed by a hash of their source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads from the previous build. All sources compile in
parallel (one ``nvcc`` each). The libraries are loaded with ctypes; every
entry point returns ``cudaGetLastError()`` after its launch, which
``check`` turns into an exception.

A build failure raises: nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "build_all", "lib", "check", "build_dir"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"

#: kernel library name -> (source file, {C entry: argument types})
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SOURCES = {
    "slab_march_display": ("slab_march_display.cu", {
        # payload, params, qscale, zb, wins_masks, n_win, acc,
        # P, G, gi, Dp, Gy, Gx, y0, x0, bd, K, flip, rows, stage_bytes,
        # chan_cells, fmt, bf16, opt, extra, depth, rot_on, rot (host
        # float[9]), bbox, basis_lo, basis_hi, stream
        "vt_march_display": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P, _I, _I, _P, _I, _I, _I, _P],
        # bd, rows, fmt, bf16, opt, smem, out (int[4])
        "vt_march_display_info": [_I, _I, _I, _I, _I, _I, _P],
    }),
    "slab_march": ("slab_march.cu", {
        # payload, pay_f32, ss, sr, sc, params, qscale, zb, ids, n_ids, occ,
        # acc, counts, P, Gz, G, gi, Gy, Gx, y0, x0, bd, flip, fmt, opt,
        # extra, rot_on, rot (host float[9]), bbox, basis_lo, basis_hi,
        # stream
        "vt_march_slabs": [_P, _I, _L, _L, _L, _P, _P, _P, _P, _I, _P, _P,
                           _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P, _I, _P, _I, _I, _I, _P],
        # bd, pay_f32, fmt, opt, out (int[11])
        "vt_march_slabs_info": [_I, _I, _I, _I, _P],
        # payload, pay_f32, ss, sr, sc, params, P, qscale, Gz, Gy, Gx, D,
        # occ, stream
        "vt_march_occupancy": [_P, _I, _L, _L, _L, _P, _I, _P, _I, _I, _I,
                               _I, _P, _P],
        # live, G, perm (int[3], host), occ, stream
        "vt_march_occupancy_live": [_P, _I, _P, _P, _P],
    }),
    "bake_pyramid": ("bake_pyramid.cu", {
        # levels (host void*[L]), masks (host void*[L]), sides (host
        # int[L]), L, G, D, thresh, out, live, stream
        "vt_bake_pyramid": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    }),
    "slab_march_bwd": ("slab_march_bwd.cu", {
        # payload, pay_f32, ss, sr, sc, params, qscale, zb, gacc, aux, ids,
        # occ, gbuf, out, out_bf16, counts, Gz, G, gi, bd, flip, fmt, opt,
        # extra, rot_on, rot (host float[9]), bbox, basis_lo, basis_hi,
        # stream
        "vt_march_slabs_bwd": [_P, _I, _L, _L, _L, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                               _I, _P, _I, _P, _I, _I, _I, _P],
        # bd, pay_f32, fmt, opt, out (int[7])
        "vt_march_slabs_bwd_info": [_I, _I, _I, _I, _P],
    }),
    "warp_build": ("warp_build.cu", {
        # inter, table, P, gi, Wy, Wx, table_f32, planar, stream
        "vt_warp_build": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
        # P, gi, Wy, Wx, table_f32, planar, out (int[8])
        "vt_warp_build_info": [_I, _I, _I, _I, _I, _I, _P],
    }),
    "warp_combine": ("warp_combine.cu", {
        # table, Y0, X0, ry, rx, okm, out, out_u8, table_f32, generic, P,
        # H, W, By, Bx, Wy, Wx, H3, W3, bg, qscale, qshift, stream
        "vt_warp_combine": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                            _P],
    }),
    "warp_display": ("warp_display.cu", {
        # inter, prm, sel, out, n_sel, out_u8, P, gi, H, W, By, Bx, Wy,
        # Wx, bg, qscale, qshift, stream
        "vt_warp_display": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _F, _P],
        # the same, then mesh (P, H, W, 4 f16), stream
        "vt_warp_display_mesh": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _F, _F, _P, _P],
        # By, Bx, Wy, Wx, out_u8, mesh, out (int[4])
        "vt_warp_display_info": [_I, _I, _I, _I, _I, _I, _P],
        # prm, counts, P, L, dims, gi, H, W, stream
        "vt_warp_fit": [_P, _P, _I, _I, _P, _I, _I, _I, _P],
    }),
    "warp_combine_adj": ("warp_combine_adj.cu", {
        # g, ry, rx, okm, Y0, X0, dtbl, P, Hh, Wh, H3, W3, bg, stream
        "vt_warp_combine_adj": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _F, _P],
    }),
    "warp_build_adj": ("warp_build_adj.cu", {
        # dtbl, out, P, gi, Wy, Wx, stream
        "vt_warp_build_adj": [_P, _P, _I, _I, _I, _I, _P],
    }),
    # the measurement probes (volrend_torch/probes/)
    "probe_combine": ("probe_combine.cu", {
        # qgp, ry, rx, okm, out, Hh, Wh, bg, stream
        "vt_probe_combine": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    }),
    "probe_stream": ("probe_stream.cu", {
        # pay, ids, n, n_win, planes, Gy, Gx, out, win_sums, stream
        "vt_probe_stream": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    }),
    "probe_build": ("probe_build.cu", {
        # it, out, gi, Hp, planar, stream
        "vt_probe_build": [_P, _P, _I, _I, _I, _P],
        # gi, out (int[6])
        "vt_probe_build_info": [_I, _P],
    }),
}
# kernel M's training mode and M-bwd are each built three times from their
# source, in parallel, their instantiations split (_FLAGS; VT_TRAIN_SET in
# csrc/slab_common.cuh; slab_march.train_lib picks one): the defaults, then
# "_opt" (SH with options, and RGBA) and "_lobes" (SG and ASG)
for _base in ("slab_march", "slab_march_bwd"):
    _src, _entries = SOURCES[_base]
    _train = {k: v for k, v in _entries.items() if "occupancy" not in k}
    for _suffix in ("_opt", "_lobes"):
        SOURCES[_base + _suffix] = (_src, _train)

# kernel M's display mode is built twice: the variants, and "_resume"
# (VT_DISPLAY_SET in csrc/slab_march_display.cu), the option variants that
# start each pixel from the state the output buffer holds (a z-segment after
# upstream ones), so the defaults' code does not carry it
SOURCES["slab_march_display_resume"] = SOURCES["slab_march_display"]

#: extra nvcc flags of a library (its instantiation set)
_FLAGS = {f"{base}{suffix}": [f"-DVT_TRAIN_SET={n}"]
          for base in ("slab_march", "slab_march_bwd")
          for n, suffix in ((1, "_opt"), (2, "_lobes"))}
_FLAGS["slab_march_display_resume"] = ["-DVT_DISPLAY_SET=1"]

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-lineinfo", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/volrend_torch`` at the root of the checkout; a per-user cache
    directory when the package is installed outside one."""
    root = _CSRC.parent.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "volrend_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "volrend_torch"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("volrend_torch.kernels: nvcc not found (the CUDA "
                           "toolkit is needed to build the kernels)")
    return path


def _target(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers it may
    include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((_CSRC / SOURCES[name][0]).read_bytes())
    for hdr in sorted(_CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(_NVCC_FLAGS + _FLAGS.get(name, [])).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    process per source, all started together. Returns {name: nvcc log}
    (the ``-Xptxas -v`` register/shared-memory report, after a first line
    ``nvcc seconds: <wall time>``) for the libraries built by this call;
    raises if any build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _) in SOURCES.items():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        logf = out.with_suffix(".log")
        with open(logf, "w") as fh:
            procs[name] = (subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, *_FLAGS.get(name, []), "-o", str(tmp),
                 str(_CSRC / src)],
                stdout=fh, stderr=subprocess.STDOUT), tmp, out, logf)
    t0 = time.perf_counter()
    secs, pending = {}, set(procs)
    while pending:
        for name in list(pending):
            if procs[name][0].poll() is not None:
                secs[name] = time.perf_counter() - t0
                pending.discard(name)
        time.sleep(0.05)
    logs, failed = {}, []
    for name, (proc, tmp, out, logf) in procs.items():
        log = f"nvcc seconds: {secs[name]:.1f}\n" + logf.read_text()
        logf.write_text(log)
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    if name not in _LIBS:
        if not _target(name).exists():
            build_all()
        cdll = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SOURCES[name][1].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        cdll.vt_error_string.argtypes = [ctypes.c_int]
        cdll.vt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = cdll
    return _LIBS[name]


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = lib(name).vt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
