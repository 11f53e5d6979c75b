"""PNG writer: the native parallel encoder with a pure-Python fallback (the
counterpart of ``volrend_tpu/utils/png.py``).

Replaces the reference's libpng path (``src/imwrite.cpp:14-79``).
``native/png_writer.cpp`` splits scanlines across threads (pigz-style
chunked deflate, one IDAT per chunk). It is compiled by ``g++`` at first
use into the port's git-ignored build directory (``kernels.build_dir()``),
keyed by a hash of the source and the flags, and bound with ctypes. Where
that build fails (no compiler, no zlib headers, no source beside an
installed package) the pure-Python encoder writes instead, as in the
reference; ``write_png`` returns which encoder wrote the file and
``native_error()`` says why the native one is missing. PNG encoding is host
code, not a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["write_png", "write_png_bytes", "rgba_to_bytes", "read_png",
           "native_error"]

_SRC = Path(__file__).resolve().parents[2] / "native" / "png_writer.cpp"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lz", "-lpthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None


def _target() -> Path:
    from volrend_torch import kernels
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    return kernels.build_dir() / f"libvolrend_png_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The native encoder's library, compiled on a miss (into a file of
    this process's own, then renamed, so concurrent builds never see a
    partial library)."""
    if not _SRC.is_file():
        raise FileNotFoundError(f"{_SRC} not found")
    so = _target()
    if so.is_file():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    out = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed: {out.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ERROR
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except Exception as e:  # any failure: the Python encoder writes
            _ERROR = f"{type(e).__name__}: {e}"
            return None
        lib.png_write.restype = ctypes.c_int
        lib.png_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _LIB = lib
        return _LIB


def native_error() -> Optional[str]:
    """Why the native encoder is unavailable (None if it built, or was not
    tried yet)."""
    return _ERROR


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def rgba_to_bytes(img: np.ndarray) -> np.ndarray:
    """float [H,W,3|4] in [0,1] or uint8 -> uint8 array unchanged shape."""
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def _python_png(img: np.ndarray, level: int) -> bytes:
    """One (H, W, c) uint8 image as PNG bytes: filter None on every
    scanline, one IDAT."""
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = 0  # filter type None per scanline
    raw[:, 1:] = img.reshape(h, w * c)
    comp = zlib.compress(raw.tobytes(), level)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                          0, 0, 0))
            + _chunk(b"IDAT", comp) + _chunk(b"IEND", b""))


def _as_image(img) -> np.ndarray:
    if hasattr(img, "detach"):                      # a tensor
        img = img.detach().cpu().numpy()
    data = rgba_to_bytes(np.asarray(img))
    if data.ndim == 2:
        data = data[..., None]
    return data


def write_png_bytes(fh, img) -> None:
    """Encode an (H, W, {1,3,4}) image as PNG into a file-like object —
    the in-memory single-shot variant of :func:`write_png`. Compression
    level 1, one IDAT."""
    fh.write(_python_png(_as_image(img), 1))


def write_png(path: str, img, level: int = 1, native: bool = True) -> str:
    """Write an (H, W, {1,3,4}) uint8/float image (array or tensor) as PNG;
    returns the encoder that wrote it, ``"native"`` or ``"python"``.

    Uses the native parallel encoder when it builds (``native=False``
    forces the pure-Python path, e.g. for tests); any native failure falls
    through to the Python writer."""
    img = _as_image(img)
    h, w, c = img.shape
    if native and c in (1, 3, 4):
        lib = _lib()
        if lib is not None:
            buf = np.ascontiguousarray(img)
            n_threads = min(os.cpu_count() or 1, 16)
            rc = lib.png_write(
                str(path).encode(), buf.ctypes.data_as(ctypes.c_void_p),
                h, w, c, int(level), n_threads)
            if rc == 0:
                return "native"
    with open(path, "wb") as f:
        f.write(_python_png(img, level))
    return "python"


def read_png(path: str) -> np.ndarray:
    """Tiny PNG reader for round-trip tests (8-bit, non-interlaced,
    filter None only)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(buf):
        (ln,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        payload = buf[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or interlace != 0:
                raise ValueError(f"{path}: only 8-bit, non-interlaced PNGs")
            c = {0: 1, 2: 3, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + ln
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    raw = raw.reshape(h, w * c + 1)
    if not np.all(raw[:, 0] == 0):
        raise ValueError(f"{path}: only filter-None rows are supported")
    return raw[:, 1:].reshape(h, w, c)
