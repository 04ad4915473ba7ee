"""K4 — the halo ring: shift(x) -> the x of the LEFT neighbour.

Counterpart of dvbt_tpu/parallel/ring.py: ``_shift_kernel`` (a neighbour
barrier, then a remote DMA into the right neighbour's output) built by
``make_ring_shift``.  The contract is exactly ``ppermute(x, [(i, i+1 mod
D)])`` over the ranks of a process group, for any dtype and shape, byte for
byte.

The CUDA kernels are ``csrc/ring.cu``.  Every rank is a process with its
own CUDA context; each ring object allocates, once, a region of flag words
and a receive buffer with ``cudaMalloc`` in the C library (not a torch
tensor: the caching allocator sub-allocates, and an IPC handle names a
whole allocation), the ranks swap the 64-byte IPC handles with an
``all_gather``, and each rank maps its neighbours' regions.  A shift, on
the current stream: signal both neighbours with the call's sequence
number, wait for both, a kernel stores the payload into the right
neighbour's buffer, publish, wait for the left neighbour's payload, a
kernel copies it out into a fresh tensor.  Set-up swaps each rank's card
(its UUID) with the handles and picks how the calls wait
(``cards_apart``).  Where ring neighbours share a card, the signals and
waits are the driver's stream memory operations (the library binds the
driver API at set-up and raises if the card lacks 64-bit ones), so the
waits hold no SM: the ranks' time-sliced contexts get the card as soon as
they have work, where a kernel that spun on the flags kept its slice.  A
stream wait has no deadline, so a watchdog thread per ring bounds every
call in seconds: past ``timeout_s`` from the call's start on the card it
writes the error word (the ring's kernels then return at once) and
releases the waits from another stream.  With a card per rank, one kernel
signals, waits on the flags (bounded by the card's timer) and moves the
payload, faster there.  Either way ``check()`` and the next call raise
after a timeout.  The bytes move once each way (HBM on one card, the link across
cards).  ``_to_dma_friendly`` (complex split, word packing for Mosaic)
has no counterpart: the kernels copy raw bytes.

Each call site needs a ring object of its own (its own buffers, flags and
sequence numbers), as each JAX call site takes its own ``collective_id``;
all ranks call a ring in the same order, on the same stream.

The plain version, ``ring_shift_plain``, is ``torch.distributed``
send-to-the-right / receive-from-the-left (staged through the host for
gloo).  Dispatch is by tensor device only: a CPU tensor takes the plain
version, a CUDA tensor K4 (or an error).  ``_build.launches`` counts K4
calls as ``ring_shift``, one a call on either route.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import time

import torch
import torch.distributed as dist

from ..kernels import _build
from . import multihost

DEFAULT_TIMEOUT_S = 60.0
_HANDLE_BYTES = 64
_UUID_BYTES = 16
_ERRORS = {1: "the neighbour barrier", 2: "the left neighbour's payload"}
_RELEASE = 1 << 62   # past every sequence number: releases every wait
_POLL_S = 5e-3       # the watchdog's polling period
_CUDA_ERROR_NOT_SUPPORTED = 801


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


def cards_apart(cards: list) -> bool:
    """True when no two ring neighbours share a card (each entry names a
    rank's card, in rank order).  K4 then waits on the SMs: one kernel that
    spins on the flags, measured ~7x faster than stream-order waits with a
    card per rank.  Where neighbours share a card it waits in stream order:
    a spinning kernel there holds its context's time slice (~9 ms a call
    with 4 ranks on one card, against ~0.8 in stream order)."""
    D = len(cards)
    return D > 1 and all(cards[q] != cards[(q + 1) % D] for q in range(D))


class Watchdog:
    """Bounds the calls of one ring in seconds, on a thread of its own.

    ``watch(seq, begin, sent, end)`` takes three events recorded on the
    ring's stream: before the call, after its send half (barrier, store,
    publish) and after its copy-out.  The thread takes the calls in order:
    once ``begin`` has completed (the call has reached the card) it gives
    ``end`` ``timeout_s``, and past that calls ``expire(seq, code)``, code 1
    if ``sent`` had not completed (the neighbour barrier) else 2 (the left
    neighbour's payload), and again after every further ``timeout_s``
    until ``end`` completes.  Anything with a ``query()`` that returns True
    once done serves as an event.  The thread makes ``device`` (the ring's
    card, None for none) its current device.  If anything on it raises,
    ``expire`` included, the thread stops and keeps the exception in
    ``error`` for the ring to raise."""

    def __init__(self, timeout_s: float, expire, device=None):
        self.timeout_s = timeout_s
        self.error = None
        self._expire = expire
        self._device = device
        self._calls = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def watch(self, seq: int, begin, sent, end) -> None:
        with self._cv:
            self._calls.append((seq, begin, sent, end))
            self._cv.notify()

    def close(self) -> None:
        """Stop once every watched call has completed."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join()

    def _run(self) -> None:
        try:
            if self._device is not None:
                torch.cuda.set_device(self._device)
            self._serve()
        except BaseException as e:  # kept for the ring to raise
            self.error = e

    def _serve(self) -> None:
        while True:
            with self._cv:
                while not self._calls and not self._closed:
                    self._cv.wait()
                if not self._calls:
                    return
                seq, begin, sent, end = self._calls[0]
            while not begin.query():
                time.sleep(_POLL_S)
            deadline = time.monotonic() + self.timeout_s
            while not end.query():
                if time.monotonic() > deadline:
                    self._expire(seq, 2 if sent.query() else 1)
                    deadline += self.timeout_s
                time.sleep(_POLL_S)
            with self._cv:
                self._calls.popleft()


class RingShift:
    """One call site of the halo ring over ``group`` (None: the world).

    ``ring(x)`` returns the left neighbour's ``x``; a collective call, made
    by every rank of the group in the same order.  The first call on a CUDA
    tensor sets up the IPC buffers, sized for its payload; a later payload
    must fit them.  ``check()`` waits for the stream and raises if a
    call timed out (the ring is then of no further use); ``close()``
    (collective) frees the buffers."""

    def __init__(self, group=None, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.group = group
        self.timeout_s = timeout_s
        self.capacity = 0
        self.seq = 0
        self.device = None
        self.on_sms = None         # set up: which way the calls wait
        self._base = None          # this rank's region
        self._opened = {}          # group rank -> mapped region
        self._left = self._right = None
        self._err_host = self._err_dev = None
        self._watchdog = self._release_stream = None

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
        # each rank's IPC handle and card, swapped in one all_gather
        record = (ctypes.c_ubyte * (_HANDLE_BYTES + _UUID_BYTES))()
        _build.check(lib.dvbt_ring_get_handle(self._base, record),
                     "dvbt_ring_get_handle")
        _build.check(lib.dvbt_ring_device_uuid(
            device.index, ctypes.byref(record, _HANDLE_BYTES)),
            "dvbt_ring_device_uuid")
        records = multihost.all_gather(
            torch.tensor(bytearray(record), dtype=torch.uint8),
            self.group).numpy()
        self.on_sms = cards_apart([q[_HANDLE_BYTES:].tobytes()
                                   for q in records])
        if not self.on_sms:
            attrs = (ctypes.c_int64 * 2)()
            code = lib.dvbt_ring_stream_ops(device.index, attrs)
            if code == _CUDA_ERROR_NOT_SUPPORTED:
                raise RuntimeError(
                    f"ring shift: {device} has no 64-bit stream memory "
                    f"operations (CAN_USE_STREAM_MEM_OPS_V1, CAN_USE_64_BIT_"
                    f"STREAM_MEM_OPS = {tuple(attrs)}); K4 waits with them "
                    "where ranks share a card and has no other barrier there")
            _build.check(code, "dvbt_ring_stream_ops")
            self._release_stream = torch.cuda.Stream(device)  # non-blocking
            self._watchdog = Watchdog(self.timeout_s, self._expire,
                                      device)

        def region(q: int) -> int:
            if q == r:
                return self._base
            if q not in self._opened:
                ptr = ctypes.c_void_p()
                buf = (ctypes.c_ubyte * _HANDLE_BYTES).from_buffer_copy(
                    records[q, :_HANDLE_BYTES].tobytes())
                _build.check(lib.dvbt_ring_open_handle(
                    device.index, buf, ctypes.byref(ptr)),
                    "dvbt_ring_open_handle")
                self._opened[q] = ptr.value
            return self._opened[q]

        self._left = region((r + D - 1) % D)
        self._right = region((r + 1) % D)

    def _error(self):
        return (ctypes.c_int * 2).from_address(self._err_host)

    def _expire(self, seq: int, code: int) -> None:
        """The watchdog's action on a call past its deadline: report the
        first such call in the error word (which cannot raise), then
        release its waits."""
        word = self._error()
        if not word[0]:
            word[1] = seq
            word[0] = code
        _build.check(_build.library().dvbt_ring_release(
            self._base, _RELEASE, self._release_stream.cuda_stream),
            "dvbt_ring_release")

    def check(self) -> None:
        """Wait for the stream; raise if a call of this ring timed out, or
        at once if the watchdog failed (the stream may then never drain)."""
        if self._err_host is None:
            return
        self._raise_if_unwatched()
        torch.cuda.current_stream(self.device).synchronize()
        self._raise_on_error()

    def _raise_if_unwatched(self) -> None:
        """Raise if the watchdog failed: a wait may then never end."""
        if self._watchdog is not None and self._watchdog.error is not None:
            raise RuntimeError("ring shift: the watchdog failed, so a wait "
                               "of this ring may never end"
                               ) from self._watchdog.error

    def _raise_on_error(self) -> None:
        self._raise_if_unwatched()
        code, seq = self._error()
        if code:
            raise RuntimeError(
                f"ring shift call {seq}: timed out after "
                f"{self.timeout_s:g} s waiting for "
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
        lib = _build.library()
        stream = torch.cuda.current_stream(x.device)
        if self.on_sms:
            _build.check(lib.dvbt_ring_shift(
                src.data_ptr(), out.data_ptr(), n, self._base, self._left,
                self._right, self.seq, int(self.timeout_s * 1e9),
                self._err_dev, stream.cuda_stream), "dvbt_ring_shift",
                kernel="ring_shift")
        else:
            begin, sent, end = (torch.cuda.Event() for _ in range(3))
            begin.record(stream)
            _build.check(lib.dvbt_ring_send(
                src.data_ptr(), n, self._base, self._left, self._right,
                self.seq, self._err_dev, stream.cuda_stream),
                "dvbt_ring_send")
            sent.record(stream)
            _build.check(lib.dvbt_ring_receive(
                out.data_ptr(), n, self._base, self.seq, self._err_dev,
                stream.cuda_stream), "dvbt_ring_receive",
                kernel="ring_shift")
            end.record(stream)
            self._watchdog.watch(self.seq, begin, sent, end)
        return out.view(x.dtype).reshape(x.shape)

    def close(self) -> None:
        """Free the buffers (collective: every rank closes its ring)."""
        if self._base is None:
            return
        self._raise_if_unwatched()         # else the stream may never drain
        lib = _build.library()
        torch.cuda.current_stream(self.device).synchronize()
        if self._watchdog is not None:
            self._watchdog.close()
        dist.barrier(group=self.group)     # no neighbour still writes here
        for ptr in self._opened.values():
            _build.check(lib.dvbt_ring_close_handle(ptr),
                         "dvbt_ring_close_handle")
        dist.barrier(group=self.group)     # every mapping of ours is closed
        _build.check(lib.dvbt_ring_free(self._base), "dvbt_ring_free")
        _build.check(lib.dvbt_ring_free_host(self._err_host),
                     "dvbt_ring_free_host")
        self._base = self._err_host = self._err_dev = None
        self._watchdog = self._release_stream = None
        self._opened = {}


def make_ring_shift(group=None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> RingShift:
    """Returns shift(x) -> x from the LEFT neighbour in ``group`` (the
    contract of ``ppermute(x, [(i, i+1 mod D)])``): K4 on CUDA tensors,
    the plain send/recv version on CPU tensors."""
    return RingShift(group, timeout_s)
