"""The monitoring receiver on a stream: one mux fed to the program's
``StreamingReceiver`` in host blocks, as a capture file is read.

The stream comes from the plain reference transmitter: one packet set
from the seed, sent in every block, so that past its first block the
transmitter's output is periodic in blocks.  One period is made, delayed
by a number of samples drawn from the seed, turned by the mix's carrier
offset (a whole number of cycles a block, so the stream stays periodic)
from a phase drawn from the seed, and given AWGN at the mix's SNR: a pool
of ``noise_copies`` noisy periods on the host, fed in turn.  The feeder
makes nothing inside the window and does not slow when the receiver does.

Per block, the time from the host block holding its last sample being
handed to ``feed`` to the return of the report that carries its TS is
its latency.  Every report's TS is compared, as it returns, with the
packet set continued cyclically from the first report's first packet;
only the counts are kept, so that the host's memory does not grow with
the window.
"""

from __future__ import annotations

import time
from fractions import Fraction

import numpy as np

from .. import common
from ..reference import tx as reference


def make_stream(ctx, rmode: reference.Mode, n_pk: int, block: int):
    """(packet set uint8 (n_pk, 188) numpy, [complex64 numpy periods],
    delay, carrier offset)."""
    import torch
    dev = ctx.device
    mix = ctx.mix
    gen = common.generator(ctx.seed, dev)
    pk = common.ts_packets(gen, (1, n_pk, 188), dev)
    cfo = Fraction(mix["cfo_subcarriers"])
    turns = cfo * block / rmode.fft_len
    if turns.denominator != 1:
        raise ValueError(f"a carrier offset of {cfo} subcarriers turns "
                         f"{turns} cycles a block: the stream would not "
                         "be periodic")
    delay = int(torch.randint(0, block, (1,), generator=gen, device=dev))
    phase0 = float(torch.rand(1, generator=gen, device=dev,
                              dtype=torch.float64)) * 2 * np.pi
    period = reference.transmit(rmode, torch.cat([pk, pk], dim=1))[0, block:]
    n = torch.arange(block, dtype=torch.float64, device=dev)
    clean = torch.roll(period, delay) * torch.exp(
        1j * (2 * np.pi * float(cfo) * n / rmode.fft_len + phase0))
    sigma = (clean.abs().pow(2).mean()
             / 10 ** (mix["snr_db"] / 10) / 2).sqrt()
    periods = []
    for _ in range(mix["noise_copies"]):
        noise = torch.complex(
            torch.randn(block, generator=gen, device=dev, dtype=torch.float64),
            torch.randn(block, generator=gen, device=dev, dtype=torch.float64))
        periods.append((clean + sigma * noise).to(torch.complex64)
                       .cpu().numpy())
    return pk[0].cpu().numpy(), periods, delay, float(cfo)


class Tally:
    """Each report as it returns: its packets that differ from the set
    continued cyclically from the first report's first packet, its
    uncorrectable packets and whether it re-acquired.  Keeps only the
    counts, the stream offset and the return time of each report."""

    def __init__(self, packets: np.ndarray):
        self.n_pk = len(packets)
        self.ring = np.concatenate([packets, packets])
        self.where = {p.tobytes(): i for i, p in enumerate(packets)}
        self.pos: int | None = None
        self.got: list = []          # (stream offset, return time)
        self.ts_bad = self.rs_bad = self.relocks = self.failed = 0

    def wrong(self, pk: np.ndarray) -> int:
        if self.pos is None:
            self.pos = self.where.get(pk[0].tobytes(), -1)
        if self.pos < 0:
            return len(pk)
        n = len(pk)
        idx = (self.pos + np.arange(n)) % self.n_pk
        want = (self.ring[self.pos:self.pos + n] if n <= self.n_pk
                else self.ring[idx])
        self.pos = (self.pos + n) % self.n_pk
        flat, ref = pk.reshape(-1), want.reshape(-1)
        if flat.size % 8 == 0 and np.array_equal(flat.view(np.uint64),
                                                 ref.view(np.uint64)):
            return 0
        return int((pk != want).any(-1).sum())

    def add(self, r, t_ret: float) -> None:
        bad = self.wrong(r.packets)
        rs = int(r.rs_uncorrectable.sum())
        self.ts_bad += bad
        self.rs_bad += rs
        self.relocks += bool(r.reacquired)
        self.failed += bool(r.reacquired) or rs > 0 or bad > 0
        self.got.append((r.stream_offset, t_ret))


def block_latencies(got: list, handed: dict, block: int, first: int) -> list:
    """Seconds from the hand-over of the host block that holds a report's
    last sample to the report's return, for every report of a block handed
    over at host block ``first`` or later.  ``got``: [(stream offset,
    return time)]; ``handed``: host block index -> time it was handed to
    feed."""
    out = []
    for offset, t_ret in got:
        j = (offset + block - 1) // block
        if j >= first:
            out.append(t_ret - handed[j])
    return out


def run(ctx) -> dict:
    import torch
    from dvbt_tpu_torch import DvbtMode
    from dvbt_tpu_torch.models.loopback import StreamingReceiver
    from torch.profiler import record_function

    cfg, mix = ctx.config, ctx.mix
    if cfg["receiver"]["demap"] != "hard":
        raise ValueError("StreamingReceiver has no demap option: the "
                         "stream cells take a hard-demap configuration")
    dev = torch.device(ctx.device)
    rmode = reference.mode_from(cfg)
    n_frames = mix["frames"]
    block = n_frames * reference.SYMBOLS_PER_FRAME * rmode.symbol_len
    n_pk = round(rmode.packets_per_frame() * n_frames)
    packets, periods, delay, cfo = make_stream(ctx, rmode, n_pk, block)
    srx = StreamingReceiver(DvbtMode(**cfg["mode"]), dev, n_frames,
                            pipeline=mix["pipeline"],
                            metrics=cfg["receiver"]["metrics"])
    common.log(f"stream: delay {delay} samples, CFO {cfo:.6f} subcarriers, "
               f"{len(periods)} noisy periods of {block} samples")

    j = 0
    warm: list = []
    while not any(r.reacquired for r in warm):
        if j >= mix["acquire_blocks"]:
            raise RuntimeError(f"no lock in {j} blocks")
        warm += srx.feed(periods[j % len(periods)])
        j += 1
    for _ in range(mix["warm_blocks"]):
        warm += srx.feed(periods[j % len(periods)])
        j += 1
    common.sync(dev)

    handed: dict = {}
    tally = Tally(packets)
    took: list = []         # seconds each feed call took
    j0 = j
    out: dict = {}

    def feed():
        nonlocal j
        t_call = time.perf_counter()
        with record_function("harness.feed"):
            reps = srx.feed(periods[j % len(periods)])
        t_ret = time.perf_counter()
        handed[j] = t_call
        took.append(t_ret - t_call)
        for r in reps:
            tally.add(r, t_ret)
        j += 1

    if ctx.trace:
        from .. import trace as tr
        tr.warm_profiler(feed)
        common.sync(dev)
        j0, handed, tally, took = j, {}, Tally(packets), []
        ctx.start_window()
        with tr.profiled(dev) as h:
            for _ in range(mix["trace_blocks"]):
                feed()
        t = h["trace"]
        n = mix["trace_blocks"]
        out["reading"] = {
            "kind": "stream", "units": n,
            "ranges": {k: v / n for k, v in t.range_us().items()}}
        out["trace"] = t
    else:
        t0 = ctx.start_window()
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline:
            feed()
    reps = srx.flush()
    t_end = time.perf_counter()
    for r in reps:
        tally.add(r, t_end)
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if not ctx.trace:
        lat = block_latencies(tally.got, handed, block, j0)
        out["metrics"] = {
            "rx_msps": (j - j0) * block / (t_end - ctx.window_start) / 1e6,
            "rx_block_p95_ms": float(np.percentile(lat, 95)) * 1e3}
        q = np.percentile(took, [10, 50, 90]) * 1e3
        common.log(f"stream: {j - j0} blocks fed, {len(lat)} latencies, "
                   f"median {np.median(lat) * 1e3:.3f} ms; a feed call "
                   f"took {q[0]:.2f}, {q[1]:.2f}, {q[2]:.2f} ms (10th, "
                   "50th, 90th percentile)")

    relocks = tally.relocks + (not srx.locked)
    est = float(srx.cfo_int.cpu()[0]) + float(srx.cfo_frac.cpu()[0])
    out["checks"] = [
        common.Check("ts_bad_packets", tally.ts_bad, 0),
        common.Check("rs_uncorrectable", tally.rs_bad, 0),
        common.Check("relocks", relocks, 0),
        common.Check("cfo_residual", abs(est - cfo),
                     cfg["checks"]["cfo_residual"])]
    out["attempted"] = len(tally.got)
    out["failed"] = tally.failed
    return out
