"""K4 — the halo ring: shift(x) -> the x of the LEFT neighbour.

Counterpart of dvbt_tpu/parallel/ring.py: ``_shift_kernel`` (a neighbour
barrier, then a remote DMA into the right neighbour's output) built by
``make_ring_shift``.  The contract is exactly ``ppermute(x, [(i, i+1 mod
D)])`` over the ranks of a process group, for any dtype and shape, byte for
byte.

The CUDA kernel is ``csrc/ring.cu``.  Every rank is a process with its own
CUDA context; each ring object allocates, once, a region of flag words and
a receive buffer with ``cudaMalloc`` in the C library (not a torch tensor:
the caching allocator sub-allocates, and an IPC handle names a whole
allocation), the ranks swap the 64-byte IPC handles with an ``all_gather``,
and each rank maps its neighbours' regions.  One launch per shift, on the
current stream: signal both neighbours with the call's sequence number,
wait for both, store the payload into the right neighbour's buffer,
publish, wait for the left neighbour's payload, copy it out into a fresh
tensor.  Every wait is bounded in seconds by the card's global timer; a
timed-out wait makes the kernel return and the wrapper raise.  The bytes
move once each way (HBM on one card, the link across cards); the time is
the barrier's, which on one card waits for the neighbours' contexts to get
their time slices.  ``_to_dma_friendly`` (complex split, word packing for
Mosaic) has no counterpart: the kernel copies raw bytes.

Each call site needs a ring object of its own (its own buffers, flags and
sequence numbers), as each JAX call site takes its own ``collective_id``;
all ranks call a ring in the same order, on the same stream.

The plain version, ``ring_shift_plain``, is ``torch.distributed``
send-to-the-right / receive-from-the-left (staged through the host for
gloo).  Dispatch is by tensor device only: a CPU tensor takes the plain
version, a CUDA tensor K4 (or an error).  ``launches`` counts K4 launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ..kernels import _build
from . import multihost

launches = 0
DEFAULT_TIMEOUT_S = 60.0
_HANDLE_BYTES = 64
_ERRORS = {1: "the neighbour barrier", 2: "the left neighbour's payload"}


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def ring_shift_plain(x: torch.Tensor, group=None) -> torch.Tensor:
    """ppermute(i -> i+1) by send/recv over the group: returns the left
    neighbour's ``x`` (same shape and dtype on every rank)."""
    D = dist.get_world_size(group)
    if D == 1:
        return x.clone()
    r = dist.get_rank(group)
    send = _as_bytes(x).to("cpu", copy=True)
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send,
                   multihost.global_rank(group, (r + 1) % D), group),
        dist.P2POp(dist.irecv, recv,
                   multihost.global_rank(group, (r + D - 1) % D), group),
    ])
    for req in reqs:
        req.wait()
    return recv.to(x.device).view(x.dtype).reshape(x.shape)


class RingShift:
    """One call site of the halo ring over ``group`` (None: the world).

    ``ring(x)`` returns the left neighbour's ``x``; a collective call, made
    by every rank of the group in the same order.  The first call on a CUDA
    tensor sets up the IPC buffers, sized for its payload; a later payload
    must fit them.  ``check()`` waits for the stream and raises if a
    launch timed out (the ring is then of no further use); ``close()``
    (collective) frees the buffers."""

    def __init__(self, group=None, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.group = group
        self.timeout_ns = int(timeout_s * 1e9)
        self.capacity = 0
        self.seq = 0
        self.device = None
        self._base = None          # this rank's region
        self._opened = {}          # group rank -> mapped region
        self._left = self._right = None
        self._err_host = self._err_dev = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return ring_shift_plain(x, self.group)
        if x.device.type != "cuda":
            raise ValueError(f"ring shift: tensor on {x.device}; K4 takes "
                             "CUDA tensors")
        return self._launch(x)

    def _setup(self, device: torch.device, nbytes: int) -> None:
        lib = _build.library()
        D = dist.get_world_size(self.group)
        r = dist.get_rank(self.group)
        torch.cuda.set_device(device)
        self.device = device
        self.capacity = max(nbytes, 16)
        base = ctypes.c_void_p()
        _build.check(lib.dvbt_ring_alloc(device.index, self.capacity,
                                         ctypes.byref(base)),
                     "dvbt_ring_alloc")
        self._base = base.value
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _build.check(lib.dvbt_ring_error_word(ctypes.byref(host),
                                              ctypes.byref(dev)),
                     "dvbt_ring_error_word")
        self._err_host, self._err_dev = host.value, dev.value
        handle = (ctypes.c_ubyte * _HANDLE_BYTES)()
        _build.check(lib.dvbt_ring_get_handle(self._base, handle),
                     "dvbt_ring_get_handle")
        handles = multihost.all_gather(
            torch.tensor(bytearray(handle), dtype=torch.uint8),
            self.group).numpy()

        def region(q: int) -> int:
            if q == r:
                return self._base
            if q not in self._opened:
                ptr = ctypes.c_void_p()
                buf = (ctypes.c_ubyte * _HANDLE_BYTES).from_buffer_copy(
                    handles[q].tobytes())
                _build.check(lib.dvbt_ring_open_handle(
                    device.index, buf, ctypes.byref(ptr)),
                    "dvbt_ring_open_handle")
                self._opened[q] = ptr.value
            return self._opened[q]

        self._left = region((r + D - 1) % D)
        self._right = region((r + 1) % D)

    def _error(self) -> tuple[int, int]:
        word = (ctypes.c_int * 2).from_address(self._err_host)
        return word[0], word[1]

    def check(self) -> None:
        """Wait for the stream; raise if a K4 launch of this ring timed
        out."""
        if self._err_host is None:
            return
        torch.cuda.current_stream(self.device).synchronize()
        self._raise_on_error()

    def _raise_on_error(self) -> None:
        code, seq = self._error()
        if code:
            raise RuntimeError(
                f"ring shift call {seq}: timed out after "
                f"{self.timeout_ns / 1e9:g} s waiting for "
                f"{_ERRORS.get(code, f'code {code}')}")

    def _launch(self, x: torch.Tensor) -> torch.Tensor:
        src = _as_bytes(x)
        n = src.numel()
        if self._base is None:
            self._setup(x.device, n)
        if x.device != self.device:
            raise ValueError(f"ring shift: tensor on {x.device}, ring set up "
                             f"on {self.device}")
        if n > self.capacity:
            raise ValueError(f"ring shift: {n} bytes exceed the ring's "
                             f"{self.capacity}-byte buffers")
        self._raise_on_error()
        out = torch.empty(n, dtype=torch.uint8, device=x.device)
        self.seq += 1
        code = _build.library().dvbt_ring_shift(
            src.data_ptr(), out.data_ptr(), n, self._base, self._left,
            self._right, self.seq, self.timeout_ns, self._err_dev,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(code, "dvbt_ring_shift")
        global launches
        launches += 1
        return out.view(x.dtype).reshape(x.shape)

    def close(self) -> None:
        """Free the buffers (collective: every rank closes its ring)."""
        if self._base is None:
            return
        lib = _build.library()
        torch.cuda.current_stream(self.device).synchronize()
        dist.barrier(group=self.group)     # no neighbour still writes here
        for ptr in self._opened.values():
            _build.check(lib.dvbt_ring_close_handle(ptr),
                         "dvbt_ring_close_handle")
        dist.barrier(group=self.group)     # every mapping of ours is closed
        _build.check(lib.dvbt_ring_free(self._base), "dvbt_ring_free")
        _build.check(lib.dvbt_ring_free_host(self._err_host),
                     "dvbt_ring_free_host")
        self._base = self._err_host = self._err_dev = None
        self._opened = {}


def make_ring_shift(group=None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> RingShift:
    """Returns shift(x) -> x from the LEFT neighbour in ``group`` (the
    contract of ``ppermute(x, [(i, i+1 mod D)])``): K4 on CUDA tensors,
    the plain send/recv version on CPU tensors."""
    return RingShift(group, timeout_s)
