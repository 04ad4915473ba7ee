"""Streaming receiver: the host lock FSM over the synchronizer and the
locked track + decode step.

Counterpart of dvbt_tpu/models/loopback.py, with the JAX package's FSM
unchanged.  All per-sample work happens in two device functions: ``sync``
(the full search of ops/sync.py, run only when unlocked) and ``track_rx``
(the NCO derotation of ops/sync.make_tracker, with the sample-clock skip
folded into its entry phase, then the carried pilot history re-timed and
the symbol-aligned receive chain of models/rx.py).  The FSM itself is host
Python that moves a stream offset forward and watches the RS
uncorrectable counter to decide when lock is lost, at block granularity.

With ``pipeline=K`` up to K blocks stay in flight on the device: the host
enqueues block N+1 while block N computes and finalizes (device-to-host
fetch, credibility check, sample-clock nudge) K blocks behind, so lock
loss and timing corrections lag K blocks; ``pipeline=0`` (the default) is
fully synchronous.  The timing loop does not discount the skips still in
flight, so under a sample-clock offset it oscillates, and with K > 0 the
swing grows (ROADMAP, queue 3).  On a CUDA device nothing in the locked dispatch reads
the device: samples go through pinned host slots (one per in-flight
block, each with a CUDA event) by asynchronous copies, and the timing
step comes from a small table on the device.  The receiver runs the
symbol-aligned chain with a mux axis of 1; reports carry the JAX
package's shapes.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import native
from ..mode import SYMBOLS_PER_FRAME, DvbtMode
from ..ops import reference_signals as refsig
from ..ops import sync as syncop
from . import rx as rxm

_TWO_PI = 2.0 * np.pi


@dataclasses.dataclass
class StreamReport:
    """One decoded block: packets and the receiver's metrics."""
    packets: np.ndarray          # uint8 (P, 188)
    stream_offset: int           # sample index of the block start
    reacquired: bool
    rs_corrected: np.ndarray
    rs_uncorrectable: np.ndarray
    info: dict                   # sync estimates (only fresh on reacquire)
    packets_lp: np.ndarray | None = None   # hierarchical LP stream
    lp_rs_uncorrectable: np.ndarray | None = None
    timing_tau: float | None = None        # median symbol-timing offset (samp)
    timing_adj: int = 0                    # SCO correction applied after block


class PinnedSlots:
    """Pinned host buffers for the host-to-device copies of in-flight
    blocks: ``put(samples)`` copies into the next slot, once the copy that
    last read it has finished, and starts an asynchronous copy to the
    device on the current stream."""

    def __init__(self, n_slots: int, n: int, device: torch.device):
        self._device = device
        self._slots = [(torch.empty(n, dtype=torch.complex64,
                                    pin_memory=True), torch.cuda.Event())
                       for _ in range(n_slots)]
        self._next = 0

    def put(self, samples: np.ndarray) -> torch.Tensor:
        host, copied = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if not copied.query():   # with a slot per block in flight, done
            copied.synchronize()
        host.numpy()[:] = samples
        out = host.to(self._device, non_blocking=True)
        copied.record()
        return out


class StreamingReceiver:
    """Feed raw baseband samples in arbitrary chunks; get decoded TS blocks.

    The thin host FSM; all math is in the device functions it drives."""

    def __init__(self, mode: DvbtMode, device, n_frames: int | None = None,
                 max_int_cfo: int = syncop.DEFAULT_MAX_INT_CFO,
                 relock_threshold: float = 0.5,
                 sco_tracking: bool = True,
                 pipeline: int = 0,
                 metrics: str = "full"):
        self.mode = mode
        self.device = torch.device(device)
        if n_frames is None:
            n_frames = mode.frames_per_block
        if n_frames % mode.frames_per_block:
            raise ValueError(f"n_frames={n_frames} is not a multiple of "
                             f"{mode.frames_per_block} frames per block")
        self.n_frames = n_frames
        self.block_samples = n_frames * SYMBOLS_PER_FRAME * mode.symbol_len
        self.capture_samples = syncop.min_capture_samples(mode, n_frames)
        self.sync = syncop.make_synchronizer(
            mode, self.capture_samples, n_frames, self.device,
            max_int_cfo=max_int_cfo)
        # metrics="min" leaves the TPS/MER stages out of the decode (the
        # FSM reads only rs_* and timing_tau)
        rx, self.n_packets, _ = rxm.make_receiver(mode, self.device,
                                                  n_frames, metrics=metrics)
        self.rx = rx
        track = syncop.make_tracker(mode, n_frames, self.device)
        retime_tail = refsig.make_chan_tail_retimer(mode, self.device)
        N = mode.fft_len

        def track_rx(rx_state, iq, cfo_frac, cfo_int, phase, adj):
            """The locked step: (state, iq complex64 (1, block_samples),
            cfo_frac, cfo_int, phase, adj, each (1,)) -> (state', phase',
            ts, metrics).  ``adj`` samples were skipped before this block:
            it steps the NCO phase and re-times the pilot history."""
            cfo = cfo_frac + cfo_int.to(torch.float32)
            phase = phase - _TWO_PI * cfo * adj.to(torch.float32) / N
            aligned, phase1 = track(iq, cfo_frac, cfo_int, phase)
            rx_state = dict(rx_state, chan_tail=retime_tail(
                rx_state["chan_tail"], adj))
            rx_state, ts, metrics = rx(rx_state, aligned)
            return rx_state, phase1, ts, metrics

        self.track_rx = track_rx
        self.pipeline = pipeline
        self._inflight: collections.deque = collections.deque()
        self._pending_adj = 0    # SCO samples to skip at the next dispatch
        self._applied_adj = 0    # skip applied between last two dispatches
        self.relock_threshold = relock_threshold
        self._ring = self._new_ring()
        self._stream_pos = 0      # absolute sample index of the ring head
        self.locked = False
        self.cfo_frac = torch.zeros(1, dtype=torch.float32,
                                    device=self.device)
        self.cfo_int = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.phase = torch.zeros(1, dtype=torch.float32, device=self.device)
        self.rx_state = rxm.init_rx_state(mode, 1, self.device)
        self.last_info: dict = {}
        # SCO / fine-timing loop: tau_ref is the timing readout right after
        # (re)acquisition; the controller consumes round(tau - tau_ref)
        # extra/fewer samples after each credible block
        self.sco_tracking = sco_tracking
        self._tau_ref: float | None = None
        self._max_adj = max(1, mode.guard_len // 4)
        # every timing step the controller can take, on the device, so
        # that a dispatch copies no host scalar
        self._adj_table = torch.arange(-self._max_adj, self._max_adj + 1,
                                       dtype=torch.int32, device=self.device)
        self._slots = (PinnedSlots(pipeline + 1, self.block_samples,
                                    self.device)
                       if self.device.type == "cuda" else None)

    def _new_ring(self) -> native.RingBuffer:
        return native.RingBuffer(capacity=4 * self.capture_samples,
                                 max_read=self.capture_samples,
                                 dtype=np.complex64)

    @property
    def stream_position(self) -> int:
        """Absolute sample index of the next sample the receiver will
        consume (block boundaries of the locked stream fall at
        stream_position + k * block_samples)."""
        return self._stream_pos

    def _need(self) -> int:
        return self.block_samples if self.locked else self.capture_samples

    def feed(self, samples: np.ndarray) -> list[StreamReport]:
        """Append samples; decode as many blocks as the buffer allows.

        With ``pipeline > 0`` up to that many blocks stay in flight on the
        device; call :meth:`flush` at end-of-stream to collect them.
        """
        samples = np.asarray(samples, np.complex64)
        out: list[StreamReport] = []
        pos = 0
        while pos < len(samples):
            pos += self._ring.write(samples[pos:])
            while self._ring.readable >= self._need():
                out += self._step()
        while self._ring.readable >= self._need():
            out += self._step()
        return out

    def flush(self) -> list[StreamReport]:
        """Finalize every in-flight block (device-to-host fetch)."""
        out = []
        while self._inflight:
            out.append(self._finalize())
        return out

    def _peek(self, n: int) -> np.ndarray:
        view = self._ring.peek(n)
        if view is None:
            raise RuntimeError(f"the ring cannot give {n} samples")
        return view

    def _consume(self, n: int):
        self._ring.consume(n)
        self._stream_pos += n

    def _to_device(self, view: np.ndarray) -> torch.Tensor:
        """A copy of ring samples on the device, (1, n); the ring may be
        consumed as soon as this returns."""
        if self._slots is not None and len(view) == self.block_samples:
            return self._slots.put(view)[None]
        return torch.from_numpy(np.array(view)).to(self.device)[None]

    def _step(self) -> list[StreamReport]:
        if self.locked:
            self._dispatch()
            out = []
            while len(self._inflight) > self.pipeline:
                out.append(self._finalize())
            return out
        # stale in-flight blocks (dispatched before lock loss was detected)
        # drain before the full search so reports stay in stream order
        out = self.flush()
        out.append(self._acquire())
        return out

    def _dispatch(self) -> None:
        """Locked steady state: enqueue one track + decode step."""
        iq = self._to_device(self._peek(self.block_samples))
        k = self._applied_adj + self._max_adj
        self.rx_state, self.phase, ts, metrics = self.track_rx(
            self.rx_state, iq, self.cfo_frac, self.cfo_int, self.phase,
            self._adj_table[k:k + 1])
        block_off = self._stream_pos
        adj = self._pending_adj
        self._pending_adj = 0
        self._consume(self.block_samples + adj)
        self._applied_adj = adj   # folded into the NEXT dispatch's NCO phase
        self._inflight.append((block_off, False, ts, metrics))

    def _acquire(self) -> StreamReport:
        """Unlocked: full search, then decode the first block synchronously
        through the same step (zero rotation)."""
        capture = self._to_device(self._peek(self.capture_samples))
        aligned, info = self.sync(capture)
        self.cfo_frac = info["cfo_frac"]
        self.cfo_int = info["cfo_int"]
        start = int(info["start"][0])
        self.last_info = {k: v[0].cpu().numpy() for k, v in info.items()}
        # resume the NCO where the sync block's derotation ended.  sync
        # accumulates the fractional rotation from the capture origin but
        # the integer rotation from the block origin (m = 0 at `start`,
        # ops/sync.py); resuming both from the capture origin would leave a
        # phase jump of -2*pi*cfo_int*start/N at the acquire->track seam,
        # which rotates the time estimator's carried pilot history out of
        # frame.
        end = start + self.block_samples
        cfo_frac = float(self.last_info["cfo_frac"])
        cfo_int = float(self.last_info["cfo_int"])
        self.phase = torch.tensor(
            [np.float32((-_TWO_PI * (cfo_frac * end
                                     + cfo_int * self.block_samples)
                         / self.mode.fft_len) % _TWO_PI)],
            dtype=torch.float32, device=self.device)
        block_off = self._stream_pos + start
        self._consume(end)
        self.rx_state = rxm.init_rx_state(self.mode, 1, self.device)
        self.locked = True
        self._pending_adj = 0
        self._applied_adj = 0
        # `aligned` is fully CFO-corrected already: the same step with zero
        # rotation
        zero_f = torch.zeros(1, dtype=torch.float32, device=self.device)
        zero_i = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.rx_state, _, ts, metrics = self.track_rx(
            self.rx_state, aligned, zero_f, zero_i, zero_f, zero_i)
        return self._make_report(block_off, True, ts, metrics)

    def _finalize(self) -> StreamReport:
        return self._make_report(*self._inflight.popleft())

    def _make_report(self, block_off, reacq, ts, metrics) -> StreamReport:
        bad = metrics["rs_uncorrectable"][0].cpu().numpy()
        credible = bad.mean() <= self.relock_threshold

        # --- SCO / fine-timing loop ---------------------------------------
        # corrections accumulate into _pending_adj and take effect at the
        # next dispatch: `pipeline` blocks late at worst, fine for a loop
        # tracking ppm-scale clock drift
        tau_med = None
        adj = 0
        if "timing_tau" in metrics:
            tau_med = float(np.median(metrics["timing_tau"][0].cpu().numpy()))
        if tau_med is not None and credible:
            if reacq or self._tau_ref is None:
                self._tau_ref = tau_med
            elif self.sco_tracking:
                adj = int(round(tau_med - self._tau_ref))
                adj = max(-self._max_adj, min(self._max_adj, adj))
                self._pending_adj = max(-self._max_adj, min(
                    self._max_adj, self._pending_adj + adj))

        if not reacq and not credible:
            self.locked = False  # lock lost: next block does a full search
            self._tau_ref = None
        hier = isinstance(ts, tuple)
        return StreamReport(
            packets=(ts[0] if hier else ts)[0].cpu().numpy(),
            stream_offset=block_off,
            reacquired=reacq,
            rs_corrected=metrics["rs_corrected"][0].cpu().numpy(),
            rs_uncorrectable=bad,
            info=self.last_info,
            packets_lp=ts[1][0].cpu().numpy() if hier else None,
            lp_rs_uncorrectable=(
                metrics["lp_rs_uncorrectable"][0].cpu().numpy()
                if hier else None),
            timing_tau=tau_med,
            timing_adj=adj,
        )

    # --- checkpoint / resume ---------------------------------------------
    def save(self, path: str) -> None:
        """Write the whole receiver state (carried RX state, lock FSM and
        the buffered samples) for a mid-stream resume."""
        from ..utils import checkpoint as ckpt
        self.flush()   # in-flight blocks must land in rx_state first
        # drain in chunks of at most max_read (peek refuses more) and write
        # the samples straight back: content and count stay, only the
        # ring's internal head moves
        chunks = []
        while self._ring.readable:
            chunk = np.array(self._peek(
                min(self._ring.readable, self.capture_samples)))
            self._ring.consume(len(chunk))
            chunks.append(chunk)
        for chunk in chunks:
            wrote = self._ring.write(chunk)
            if wrote != len(chunk):
                raise RuntimeError("the ring lost samples while saving")
        buf = (np.concatenate(chunks) if chunks
               else np.zeros((0,), np.complex64))
        ckpt.save_state(
            path, self.rx_state,
            buf=buf.view(np.float32),
            stream_pos=self._stream_pos,
            locked=self.locked,
            cfo_frac=self.cfo_frac.cpu().numpy(),
            cfo_int=self.cfo_int.cpu().numpy(),
            phase=self.phase.cpu().numpy(),
        )

    def restore(self, path: str) -> None:
        """Load a state written by :meth:`save` into this receiver."""
        from ..utils import checkpoint as ckpt
        state, extra = ckpt.load_state(
            path, rxm.init_rx_state(self.mode, 1, self.device))
        self.rx_state = state
        self._ring.close()
        self._ring = self._new_ring()
        self._ring.write(extra["buf"].view(np.complex64))
        self._stream_pos = int(extra["stream_pos"])
        self.locked = bool(extra["locked"])

        def scalar(key, dtype):
            return torch.as_tensor(extra[key].reshape(1), dtype=dtype,
                                   device=self.device)

        self.cfo_frac = scalar("cfo_frac", torch.float32)
        self.cfo_int = scalar("cfo_int", torch.int32)
        self.phase = scalar("phase", torch.float32)
        self._inflight.clear()
        self._pending_adj = 0
        self._applied_adj = 0
