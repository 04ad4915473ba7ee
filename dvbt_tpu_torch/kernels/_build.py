"""Build the port's CUDA sources into one shared library and load it.

The sources in ``dvbt_tpu_torch/csrc/*.cu`` have a plain C interface, so
``nvcc`` builds them in seconds and ``ctypes`` binds them (no PyTorch
headers): one ``nvcc -c`` per source, all started together, then one
link.  The library is built at first use into ``build/dvbt_tpu_torch/``
beside the package, under a file name that carries a hash of the sources
and flags, so a stale build is never loaded.  A failed build raises with nvcc's
own error output: there is no fallback.

``launches`` is the port's one launch count: each kernel wrapper counts
its launches there under the kernel's name (``check``'s ``kernel``), and
whoever wants the launches of a piece of work takes the difference of two
copies of it.
"""

from __future__ import annotations

import collections
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as void*,
# lengths as int64 — ctypes would otherwise pass 32-bit ints).  Each
# returns an int error code (0: success) unless _RESTYPES says otherwise.
# tests/test_torch_build.py holds this table against the sources.
_SIGNATURES = {
    "dvbt_byte_coder": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dvbt_viterbi_punct": [_P, _P, _P, *[_I] * 13, _P, _P],
    "dvbt_viterbi_depunct": [_P, _P, _P, _P, _P, _P, *[_I] * 9, _P, _P],
    "dvbt_rs_decode": [_P, _P, _P, _P, _P, _I, _P],
    "dvbt_rs_encode": [_P, _P, _P, _I, _P],
    "dvbt_demap": [*[_P] * 7, *[_I] * 6, _P],
    "dvbt_acquire": [*[_P] * 4, *[_I] * 9, _P],
    # K4, the halo ring (csrc/ring.cu); void** outputs are passed by byref
    "dvbt_ring_stream_ops": [_I, _P],
    "dvbt_ring_device_uuid": [_I, _P],
    "dvbt_ring_alloc": [_I, _I, _P],
    "dvbt_ring_free": [_P],
    "dvbt_ring_get_handle": [_P, _P],
    "dvbt_ring_open_handle": [_I, _P, _P],
    "dvbt_ring_close_handle": [_P],
    "dvbt_ring_error_word": [_P, _P],
    "dvbt_ring_free_host": [_P],
    "dvbt_ring_shift": [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P],
    "dvbt_ring_send": [_P, _I, _P, _P, _P, _I, _P, _P],
    "dvbt_ring_receive": [_P, _I, _P, _I, _P, _P],
    "dvbt_ring_release": [_P, _I, _P],
    "dvbt_error_string": [_INT],
}
_RESTYPES = {"dvbt_error_string": ctypes.c_char_p}

# kernel name -> launches in this process: byte_coder (K2), viterbi_punct
# (K1), viterbi_depunct (K3), rs_decode, rs_encode, demap, acquire (one a
# call: the fold and the pick), ring_shift (K4, one a call on either of its
# routes)
launches: collections.Counter = collections.Counter()


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
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    # (cmd, output, exit code) once every compile has ended
    done = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    failed = [d for d in done if d[2] != 0]
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append((cmd, proc.stderr + proc.stdout, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, out, code in failed:
        raise RuntimeError(f"nvcc failed (exit {code}): {' '.join(cmd)}\n"
                           f"{out}")
    os.replace(tmp, so)
    return so, "".join(d[1] for d in done)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(code: int, name: str, kernel: str | None = None) -> None:
    """Raise if the entry point ``name`` returned a CUDA error
    (cudaGetLastError); else, where the call launched ``kernel``, count
    one launch of it in ``launches``."""
    if code != 0:
        msg = library().dvbt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
    if kernel is not None:
        launches[kernel] += 1
