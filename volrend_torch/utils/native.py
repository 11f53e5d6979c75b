"""The port's host libraries built from ``native/*.cpp`` (the PNG encoder,
the npz loader): host code, not kernels.

A library is compiled by ``g++`` at first use into the port's git-ignored
build directory (``kernels.build_dir()``), keyed by a hash of its source
and the flags (into a file of this process's own, then renamed, so
concurrent builds never see a partial library), and bound with ctypes.
Where that fails (no compiler, no zlib headers, no source beside an
installed package) ``HostLib.load`` returns None and ``HostLib.error``
says why: the caller keeps its Python path, as the reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

_NATIVE = Path(__file__).resolve().parents[2] / "native"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lz", "-lpthread")


class HostLib:
    """``native/<source>`` as a ctypes library named ``<stem>_<hash>.so``;
    ``bind`` sets its functions' argtypes and restypes."""

    def __init__(self, source: str, stem: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.src = _NATIVE / source
        self.stem = stem
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False
        #: why the library is unavailable (None if it loaded, or was not
        #: tried yet)
        self.error: Optional[str] = None

    def target(self) -> Path:
        from volrend_torch import kernels
        h = hashlib.sha256(self.src.read_bytes())
        h.update(" ".join(_FLAGS + _LIBS).encode())
        return kernels.build_dir() / f"{self.stem}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """The library's path, compiled on a miss."""
        if not self.src.is_file():
            raise FileNotFoundError(f"{self.src} not found")
        so = self.target()
        if so.is_file():
            return so
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        out = subprocess.run(
            ["g++", *_FLAGS, str(self.src), "-o", str(tmp), *_LIBS],
            capture_output=True, text=True, timeout=120)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed: {out.stderr[-2000:]}")
        os.replace(tmp, so)
        return so

    def load(self) -> Optional[ctypes.CDLL]:
        """The bound library, built and loaded on the first call; None
        (and ``error`` set) where that failed."""
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            try:
                lib = ctypes.CDLL(str(self.build()))
            except Exception as e:  # any failure: the caller's Python path
                self.error = f"{type(e).__name__}: {e}"
                return None
            self._bind(lib)
            self._lib = lib
            return lib
