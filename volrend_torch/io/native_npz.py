"""ctypes bridge to the native npz loader (``native/npz_loader.cpp``; the
counterpart of ``volrend_tpu/io/native_npz.py``).

The shared library is compiled by ``g++`` at first use into the port's
build directory (``utils/native.py``, as ``utils/png.py`` builds its
encoder); nothing is written under ``native/``. Where that build fails
``numpy.load`` reads instead, as in the reference; ``native_error()`` says why the native loader
is missing. Reading a file is host code, not a kernel.

``load_npz(path)`` returns a dict[str, np.ndarray] like ``dict(np.load(p))``
but decodes members with mmap + multithreaded memcpy (STORED) or native
zlib inflate (DEFLATED) — ~10-30x faster than numpy's zipfile path on
multi-GB trees.
"""

from __future__ import annotations

import ast
import ctypes
import os
from typing import Dict, Optional

import numpy as np

from volrend_torch.utils.native import HostLib

__all__ = ["load_npz", "available", "native_error"]

def _bind(lib: ctypes.CDLL) -> None:
    lib.npz_open.restype = ctypes.c_void_p
    lib.npz_open.argtypes = [ctypes.c_char_p]
    lib.npz_error.restype = ctypes.c_char_p
    lib.npz_error.argtypes = [ctypes.c_void_p]
    lib.npz_count.restype = ctypes.c_int
    lib.npz_count.argtypes = [ctypes.c_void_p]
    lib.npz_name.restype = ctypes.c_char_p
    lib.npz_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.npz_member_info.restype = ctypes.c_int
    lib.npz_member_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.npz_read.restype = ctypes.c_int
    lib.npz_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_char_p, ctypes.c_int]
    lib.npz_close.restype = None
    lib.npz_close.argtypes = [ctypes.c_void_p]


_NATIVE = HostLib("npz_loader.cpp", "libvolrend_npz", _bind)


def native_error() -> Optional[str]:
    """Why the native loader is unavailable (None if it built, or was not
    tried yet)."""
    return _NATIVE.error


def _parse_npy_header(buf: bytes):
    """Parse an npy header prefix -> (dtype, shape, fortran, data_offset)."""
    if buf[:6] != b"\x93NUMPY":
        raise ValueError("not an npy member")
    major = buf[6]
    if major == 1:
        hlen = int.from_bytes(buf[8:10], "little")
        off = 10
    else:
        hlen = int.from_bytes(buf[8:12], "little")
        off = 12
    header = buf[off:off + hlen].decode("latin1")
    d = ast.literal_eval(header)
    dtype = np.dtype(d["descr"])
    return dtype, tuple(d["shape"]), bool(d["fortran_order"]), off + hlen


def available() -> bool:
    return _NATIVE.load() is not None


def load_npz(path: str, n_threads: Optional[int] = None
             ) -> Dict[str, np.ndarray]:
    """Load all members of an npz archive into numpy arrays."""
    lib = _NATIVE.load()
    if lib is None:
        with np.load(path, allow_pickle=False) as f:
            return dict(f.items())
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 4)

    h = lib.npz_open(str(path).encode())
    try:
        err = lib.npz_error(h)
        if err:
            raise IOError(f"npz_open({path}): {err.decode()}")
        out: Dict[str, np.ndarray] = {}
        n = lib.npz_count(h)
        for i in range(n):
            name = lib.npz_name(h, i).decode()
            if name.endswith(".npy"):
                name = name[:-4]
            raw = ctypes.c_uint64()
            comp = ctypes.c_uint64()
            method = ctypes.c_int()
            head = ctypes.create_string_buffer(4096)
            got = lib.npz_member_info(h, i, ctypes.byref(raw),
                                      ctypes.byref(comp),
                                      ctypes.byref(method), head, 4096)
            if got < 10:
                raise IOError(f"member {name}: cannot read header")
            dtype, shape, fortran, doff = _parse_npy_header(head.raw[:got])
            full = np.empty(raw.value, np.uint8)
            rc = lib.npz_read(
                h, i, full.ctypes.data_as(ctypes.c_char_p), n_threads)
            if rc != 0:
                raise IOError(f"member {name}: read failed rc={rc}")
            arr = np.frombuffer(full[doff:].data, dtype=dtype)
            arr = arr.reshape(shape, order="F" if fortran else "C")
            out[name] = arr
        return out
    finally:
        lib.npz_close(h)
