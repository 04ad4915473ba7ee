"""Build the port's CUDA sources into one shared library and load it.

The sources in ``dvbt_tpu_torch/csrc/*.cu`` have a plain C interface, so one
``nvcc`` call builds them in seconds and ``ctypes`` binds them (no PyTorch
headers).  The library is built at first use into ``build/dvbt_tpu_torch/``
beside the package, under a file name that carries a hash of the sources and
flags, so a stale build is never loaded.  A failed build raises with nvcc's
own error output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dvbt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int64
# C entry points: name -> argument types (pointers and the stream as void*,
# lengths as int64 — ctypes would otherwise pass 32-bit ints)
_SIGNATURES = {
    "dvbt_byte_coder": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dvbt_viterbi_punct": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libdvbt_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> tuple[Path, str]:
    """Compile the sources unless a library for them exists.

    Returns (library path, nvcc's diagnostic output — ptxas register and
    shared-memory usage; empty when the library was already built)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    return so, proc.stderr + proc.stdout


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dvbt_error_string.argtypes = [ctypes.c_int]
    lib.dvbt_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        msg = library().dvbt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
