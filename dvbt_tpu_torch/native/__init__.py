"""Native (C++) host runtime: the SPSC ring buffer that feeds the streaming
receiver, and the MPEG-TS sync search.

The port's own copy of dvbt_tpu/native: ``ringbuffer.cc`` is the JAX
package's source byte for byte (tests/test_torch_isolation.py holds it
so), built on first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``build/dvbt_tpu_torch/`` beside the package, under a file name that
carries a hash of the source and flags, and bound with ctypes.  A failed
build raises with the compiler's message: there is no pure-Python
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..kernels._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "ringbuffer.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P, _U64 = ctypes.c_void_p, ctypes.c_uint64
# C entry points: name -> (argument types, return type)
_SIGNATURES = {
    "ring_create": ([_U64, _U64], _P),
    "ring_destroy": ([_P], None),
    "ring_readable": ([_P], _U64),
    "ring_writable": ([_P], _U64),
    "ring_write": ([_P, _P, _U64], _U64),
    "ring_peek": ([_P, _U64], _P),
    "ring_consume": ([_P, _U64], None),
    "ring_read": ([_P, _P, _U64], _U64),
    "ts_find_sync": ([_P, _U64, ctypes.c_int], ctypes.c_int64),
    "ts_sync_quality": ([_P, _U64], ctypes.c_int32),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libdvbt_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ringbuffer.cc unless a library for it exists; returns its
    path.  Raises RuntimeError with g++'s output if the build fails."""
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native ring buffer cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


class RingBuffer:
    """SPSC ring with zero-copy contiguous reads.

    Typed: ``write``/``peek``/``read`` take and give numpy arrays of
    ``dtype``, and every size is in elements of it.  ``peek(n)`` for n up
    to ``max_read`` returns a view into the ring that stays valid until
    the next ``consume``."""

    def __init__(self, capacity: int, max_read: int, dtype=np.uint8):
        self.dtype = np.dtype(dtype)
        self._lib = library()
        self._h = self._lib.ring_create(capacity * self.dtype.itemsize,
                                        max_read * self.dtype.itemsize)
        if not self._h:
            raise MemoryError(f"ring_create({capacity}, {max_read}) failed")

    def close(self) -> None:
        """Free the ring (also done when the object is collected)."""
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()

    @property
    def readable(self) -> int:
        return int(self._lib.ring_readable(self._h)) // self.dtype.itemsize

    def write(self, arr: np.ndarray) -> int:
        """Copy in as much of ``arr`` as fits; returns elements taken."""
        a = np.ascontiguousarray(arr, self.dtype).view(np.uint8).reshape(-1)
        n = int(self._lib.ring_write(self._h, a.ctypes.data, a.nbytes))
        return n // self.dtype.itemsize

    def peek(self, n: int) -> np.ndarray | None:
        """Zero-copy view of the next n elements (valid until consume), or
        None if fewer are readable or n exceeds max_read."""
        nb = n * self.dtype.itemsize
        p = self._lib.ring_peek(self._h, nb)
        if not p:
            return None
        raw = (ctypes.c_uint8 * nb).from_address(p)
        return np.frombuffer(raw, np.uint8).view(self.dtype)

    def consume(self, n: int) -> None:
        self._lib.ring_consume(self._h, n * self.dtype.itemsize)

    def read(self, n: int) -> np.ndarray:
        """Copy out and consume up to n elements."""
        out = np.empty(n * self.dtype.itemsize, np.uint8)
        got = int(self._lib.ring_read(self._h, out.ctypes.data, out.nbytes))
        return out[:got].view(self.dtype)


def ts_find_sync(buf: np.ndarray, confirm: int = 3) -> int:
    """First offset with ``confirm`` aligned 0x47/0xB8 syncs, or -1."""
    a = np.ascontiguousarray(buf, np.uint8).reshape(-1)
    return int(library().ts_find_sync(a.ctypes.data, len(a), confirm))


def ts_sync_quality(buf: np.ndarray) -> float:
    """Fraction of aligned sync bytes on the 188-byte grid."""
    a = np.ascontiguousarray(buf, np.uint8).reshape(-1)
    return library().ts_sync_quality(a.ctypes.data, len(a)) / 1000.0
