"""The block path from raw captures, on one transport stream or on the
(HP, LP) pair of a hierarchical configuration: the program's
``models.flowgraph.make_block_receiver`` from the synchronizer to each
stream's descrambler over ``n_mux`` captures a pass, each acquired from
scratch.

The plain reference transmitter makes, for each of ``capture_sets`` sets
of ``n_mux`` captures, a stream from packets of its own drawn from the
seed, a pool a stream, HP first; each capture starts at a delay drawn from
the seed, is turned by a carrier offset uniform over +-``cfo_max``
subcarriers from a phase drawn from the seed, and gets AWGN at the mix's
SNR.  With one stream every draw is ``capture_passes``'s, in its order, so
both drivers make the same captures from a seed and check them alike.
The sets stay on the device and pass p takes set p mod ``capture_sets``,
every pass from the receiver's initial state.

Per pass, on the device: where each capture's decoded block starts must
lie within the guard interval before a frame start (the synchronizer's
timing), the estimated carrier offset within the configuration's
residual of the true one, the TPS bits of each frame (hierarchy and LP
code rate among them) equal the reference's, and each stream's TS after
the outer interleaver's 11-packet warm-up equal that stream's packets sent
from that frame on, with no uncorrectable packet on either stream.

A traced run, after its profiled passes and outside every window, runs
``warm_passes`` passes and then ``trace_passes`` more with a
``dvbt_tpu_torch.utils.telemetry.Recorder`` active (the window that
``stage_window`` runs for ``capture_passes``), and keeps its summary in
the reading under ``stage_window.KEY``, where the ``program_span``
readers look first.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import common, stage_window
from ..reference import tx as reference
from .graph_step import join, streams

# the receiver's uncorrectable flags of each stream, HP first
FLAGS = ("rs_uncorrectable", "lp_rs_uncorrectable")


def make_captures(ctx, rmode: reference.Mode, n_cap: int):
    """(captures complex64 (S, M, n_cap), packets of each stream, HP
    first, uint8 (S, M, P, 188), delays int64 (S, M), offsets float64 (S,
    M)), all on the device."""
    import torch
    mix, dev = ctx.mix, ctx.device
    S, M = mix["capture_sets"], mix["n_mux"]
    gen = common.generator(ctx.seed, dev)
    n_frames = mix["stream_frames"]
    packets = tuple(common.ts_packets(
        gen, (S, M, round(rmode.packets_per_frame(i) * n_frames), 188), dev)
        for i in range(len(rmode.streams)))
    max_delay = n_frames * rmode.frame_len - n_cap
    delays = torch.randint(0, max_delay, (S, M), generator=gen, device=dev)
    cfo = (torch.rand(S, M, generator=gen, device=dev, dtype=torch.float64)
           * 2 - 1) * mix["cfo_max"]
    phase = torch.rand(S, M, generator=gen, device=dev,
                       dtype=torch.float64) * 2 * np.pi
    n = torch.arange(n_cap, device=dev)
    caps = torch.empty(S, M, n_cap, dtype=torch.complex64, device=dev)
    for s in range(S):
        stream = reference.transmit(rmode, join(tuple(p[s] for p in packets)))
        cap = torch.gather(stream, 1, delays[s][:, None] + n)
        cap = cap * torch.exp(1j * (2 * np.pi * cfo[s][:, None] * n
                                    / rmode.fft_len + phase[s][:, None]))
        sigma = (cap.abs().pow(2).mean(-1, keepdim=True)
                 / 10 ** (mix["snr_db"] / 10) / 2).sqrt()
        noise = torch.complex(
            torch.randn(cap.shape, generator=gen, device=dev,
                        dtype=torch.float64),
            torch.randn(cap.shape, generator=gen, device=dev,
                        dtype=torch.float64))
        caps[s] = (cap + sigma * noise).to(torch.complex64)
        del stream, cap, noise
    return caps, packets, delays, cfo


class _Checker:
    """Accumulates, over passes: bad captures, wrong TS packets and
    uncorrectable packets (both summed over the streams), wrong TPS frames,
    the widest timing error and the widest carrier-offset residual.  A
    stream whose TS or flags come in another shape than the receiver's
    packet count is wrong in every packet."""

    def __init__(self, ctx, rmode, packets: tuple, delays, cfo,
                 n_pk: tuple):
        import torch
        dev = delays.device
        self.rmode = rmode
        self.packets, self.delays, self.cfo = packets, delays, cfo
        self.n_pk = n_pk
        self.stream_frames = ctx.mix["stream_frames"]
        self.n_frames = ctx.mix["frames"]
        self.tps = torch.as_tensor(np.stack(
            [reference.tps_bits(rmode, f) for f in range(4)]), device=dev)
        self.d = common.DELAY_PACKETS
        self.fr = torch.arange(self.n_frames, device=dev)
        self.counts = torch.zeros(4, dtype=torch.int64, device=dev)
        self.worst = torch.zeros(2, dtype=torch.float64, device=dev)

    def _stream(self, s: int, i: int, k0, ts, flags):
        """(wrong TS packets, uncorrectable packets) (M, n - d) of stream
        i, capture set s, whose decoded block starts at frame k0."""
        import torch
        d, n = self.d, self.n_pk[i]
        M = k0.shape[0]
        if tuple(ts.shape) != (M, n, 188) or tuple(flags.shape) != (M, n):
            every = torch.ones(M, n - d, dtype=torch.bool, device=k0.device)
            return every, every
        pk = self.packets[i][s]
        P = pk.shape[1]
        # frame k0's first packet: P packets fill stream_frames frames
        first = torch.div(k0 * P, self.stream_frames, rounding_mode="floor")
        idx = (first[:, None] + torch.arange(n - d, device=k0.device)
               ).clamp(0, P - 1)
        want = torch.gather(pk, 1, idx[..., None].expand(*idx.shape, 188))
        return (ts[:, d:] != want).any(-1), flags[:, d:]

    def __call__(self, s: int, ts, info) -> None:
        import torch
        with common.check_scope():
            flen, G = self.rmode.frame_len, self.rmode.guard_len
            at = self.delays[s] + info["start"].to(torch.int64)
            k0 = torch.div(at + flen - 1, flen, rounding_mode="floor")
            timing = k0 * flen - at              # in [0, G] when right
            est = info["cfo_int"].to(torch.float64) + info["cfo_frac"].to(
                torch.float64)
            resid = (est - self.cfo[s]).abs()
            tps_want = self.tps[(k0[:, None] + self.fr) % 4]
            bad_tps = (info["tps_bits"][..., 1:].to(torch.int64)
                       != tps_want[..., 1:]).any(-1)
            off_grid = (timing < 0) | (timing > G)
            bad = bad_tps.any(-1) | off_grid
            n_ts = n_rs = 0
            for i, t in enumerate(streams(ts)):
                bad_ts, bad_rs = self._stream(s, i, k0, t, info[FLAGS[i]])
                bad = bad | bad_ts.any(-1) | bad_rs.any(-1)
                n_ts = n_ts + bad_ts.sum()
                n_rs = n_rs + bad_rs.sum()
            self.counts += torch.stack([bad.sum(), n_ts, n_rs,
                                        bad_tps.sum()])
            err = torch.where(off_grid, float(flen), timing.to(
                torch.float64))
            self.worst.copy_(torch.maximum(self.worst, torch.stack(
                [err.max(), resid.max()])))


def telemetry(rx, state0, caps, warm: int, passes: int, device) -> dict:
    """The summary of ``passes`` passes with a recorder active, after
    ``warm`` passes without, each followed by a synchronize and
    ``collect()``: ``stage_window._capture``'s window."""
    from dvbt_tpu_torch.utils.telemetry import Recorder
    rec = Recorder(device)
    for p in range(warm + passes):
        with rec if p >= warm else contextlib.nullcontext():
            rx(state0, caps[p % caps.shape[0]])
        common.sync(device)
        rec.collect()
    return rec.summary()


def run(ctx) -> dict:
    import torch
    from dvbt_tpu_torch import DvbtMode
    from dvbt_tpu_torch.models import flowgraph

    cfg, mix = ctx.config, ctx.mix
    dev = torch.device(ctx.device)
    rmode = reference.mode_from(cfg)
    n_cap = mix["capture_symbols"] * rmode.symbol_len
    mode = DvbtMode(**cfg["mode"])
    rx, n_pk = flowgraph.make_block_receiver(mode, dev, n_cap, mix["frames"])
    state0 = flowgraph.init_block_rx_state(mode, mix["n_mux"], dev)
    caps, packets, delays, cfo = make_captures(ctx, rmode, n_cap)
    S = caps.shape[0]
    check = _Checker(ctx, rmode, packets, delays, cfo, streams(n_pk))
    flight = common.InFlight(dev)

    passes = 0

    def one():
        nonlocal passes
        _, ts, info = rx(state0, caps[passes % S])
        check(passes % S, ts, info)
        passes += 1
        flight.mark()

    for _ in range(mix["warm_passes"]):
        one()
    out: dict = {}
    if ctx.trace:
        from .. import trace as tr
        tr.warm_profiler(one)
    common.sync(dev)
    check.counts.zero_()
    check.worst.zero_()
    first = passes
    if ctx.trace:
        ctx.start_window()
        with tr.profiled(dev) as h:
            for _ in range(mix["trace_passes"]):
                one()
        n = passes - first
        t = h["trace"]
        out["reading"] = {
            "kind": "capture", "units": n,
            "ranges": {k: v / n for k, v in t.range_us().items()}}
        out["trace"] = t
    else:
        t0 = ctx.start_window()
        deadline = t0 + ctx.seconds
        while True:
            one()
            if time.perf_counter() >= deadline:
                break
        common.sync(dev)
        elapsed = time.perf_counter() - t0
        n = passes - first
        out["metrics"] = {"capture_msps": n * mix["n_mux"] * n_cap / elapsed
                          / 1e6}
        common.log(f"captures: {n} passes in {elapsed:.3f} s")
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if ctx.trace:
        out["reading"][stage_window.KEY] = telemetry(
            rx, state0, caps, mix["warm_passes"], mix["trace_passes"], dev)
    bad, bad_ts, bad_rs, bad_tps = (int(x) for x in check.counts.cpu())
    timing, resid = (float(x) for x in check.worst.cpu())
    out["checks"] = [
        common.Check("ts_bad_packets", bad_ts, 0),
        common.Check("rs_uncorrectable", bad_rs, 0),
        common.Check("tps_bad_frames", bad_tps, 0),
        common.Check("timing_err", timing, rmode.guard_len),
        common.Check("cfo_residual", resid, cfg["checks"]["cfo_residual"])]
    out["attempted"] = n * mix["n_mux"]
    out["failed"] = bad
    return out
