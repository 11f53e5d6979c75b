"""PNG writer: the native parallel encoder with a pure-Python fallback (the
counterpart of ``volrend_tpu/utils/png.py``).

Replaces the reference's libpng path (``src/imwrite.cpp:14-79``).
``native/png_writer.cpp`` splits scanlines across threads (pigz-style
chunked deflate, one IDAT per chunk). It is compiled by ``g++`` at first
use into the port's build directory (``utils/native.py``). Where that
build fails the pure-Python encoder writes instead, as in the reference; ``write_png`` returns which encoder wrote the file and
``native_error()`` says why the native one is missing. PNG encoding is host
code, not a kernel.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Optional

import numpy as np

from volrend_torch.utils.native import HostLib

__all__ = ["write_png", "write_png_bytes", "rgba_to_bytes", "read_png",
           "native_error"]

def _bind(lib: ctypes.CDLL) -> None:
    lib.png_write.restype = ctypes.c_int
    lib.png_write.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]


_NATIVE = HostLib("png_writer.cpp", "libvolrend_png", _bind)


def native_error() -> Optional[str]:
    """Why the native encoder is unavailable (None if it built, or was not
    tried yet)."""
    return _NATIVE.error


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
        lib = _NATIVE.load()
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
