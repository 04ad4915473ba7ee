#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dvbt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dvbt_tpu_torch/csrc, checks each against its
plain PyTorch version on the card (K1 and K3, the Viterbi decoders, on hard
and graded soft values at every rate, an all-erasure block, blocks shorter
than one window body, a ragged last window, a body whose decisions spill
to device memory, 1 to 8 muxes, the flagship and time-sharded shapes; and
K2, the inner coder, at every rate's 8K byte count, 1 to 8 muxes, rows
that are not a multiple of 16 bytes, the time-sharded shape, two blocks
with the carried state, and a numpy reference of the mother code; both
at the hierarchical shapes: 8K alpha=2 HP 2/3 and LP 3/4 at 1 and 4
frames, 2K alpha=2 HP 1/2 and LP 3/4; K1 also on the soft receiver's own
CSI-weighted metrics under Annex B P1 at 20 dB, where the whole receiver's
TS must equal that of a receiver whose demap stage is the plain version;
K3 at each stream's
time-sharded halo shape; and the RS decoder, byte for byte with its
messages, counts and flags, at every receive path's packet count and odd
ones, noiseless, with 1-8 and 9-16 byte errors a packet and a mix, then
its time at the flagship step's packets, noiseless and with 8 errors;
and the RS encoder, byte for byte, at every transmit path's packet count,
2K frames and odd ones, on random, all-zero, all-0xFF and TS packets, then
its time at the flagship step's packets; and the demap kernel at the
flagship step's 8 x 272 symbol rows, UK hard and hierarchical alpha=2 hard
exact on cells at 20 dB and on the decision boundaries, DE soft with CSI
within one level on a stated share, then its times; and the acquisition
kernel at the capture cells' 8 x 409 8K symbols at 22 and 28 dB and at
every transmission and guard, theta equal to the plain version's and to
the true timing, cfo_frac within 1e-6 subcarrier, the same bits twice,
then its time),
checks the 8K transmitter against the golden snapshot, then drives the
flagship slice (MODE_8K_UK: 8K, 64-QAM, rate 2/3, GI 1/32; 8 muxes x 4
frames per step) TX -> RX and checks that every mux returns its
transport stream byte-exact.  Then it drives the block-level receive
path: 8 raw captures, each with its own delay, CFO and AWGN at 30 dB,
through the registry's blocks from the synchronizer to the descrambler
(K3 decodes), and checks each mux's sync estimates against the
impairments, its TS byte-exact from the detected frame on, and its TPS
bits.  Then the BER path (apps.ber_sweep.run_point on the card: three
MODE_8K_UK points, soft under P1 at 20 dB, hard at 19 dB and soft at 16
dB, each within 15% of the JAX package's curve in docs/ for each of 8
seeds, and the other demap at each point outside it; ms per BER block on
the host clock and its device busy time from one profiler trace), the
hierarchical configuration (8K 64-QAM alpha=2, HP 2/3 + LP 3/4, 8 muxes
x 4 frames, noiseless, both streams byte-exact, K1 and K2 twice a step)
and the 2K alpha=2 soft point at 6 dB within 25% of its curve for each
of 4 seeds, hard metrics there outside it.  Then the streaming receiver
(models.loopback.StreamingReceiver, MODE_8K_UK, one-frame blocks): a raw
stream with a delay and a 0.31-subcarrier CFO through pipeline=4, locked
and byte-exact; the sample-clock loop held at 2 ppm (pipeline=0) and its
limits read at 2 ppm with pipeline=4 and at 40 ppm; a checkpoint resume,
byte-identical; AutoStreamingReceiver told only "8k" on a MODE_8K_UK and
an 8K alpha=2 capture, each detected and byte-exact; a profiled tracked
block (1 mux x 8 frames, 0.31-subcarrier CFO, K1 and K2 also checked at
that shape); the tx and rx apps through files.  Then
timings (with the flagship step's device time per stage, hard and soft
demap), and the parallel package: 4 rank processes on the one
card (spawned, gloo between them) check K4, the halo ring over CUDA IPC,
against its plain send/recv version and that lone calls time out and
raise (one whose caller synchronises the stream first), on each of K4's
two routes (waits in stream order, the one-card choice; one kernel that
waits on the SMs, the choice with a card per rank), run the dryrun at
MODE_8K_UK (mux-DP over 4 x 2 muxes; the time-sharded loopback over 8
one-frame blocks, equal to the single-process streaming chain; the K4 halo
path equal to the send/recv one; the same three stages with the soft
receiver and with the hierarchical configuration, three halos a step,
each on both of K4's routes), and time K4 and the sharded step with
either halo.  Then the graph step the benchmark drives
(dvbt_tpu_torch.bench): the flagship step captured into one CUDA graph
against the eager step over 4 carried steps, byte for byte.  Last,
the validation tools (dvbt_tpu_torch.tools): the 25 modes of
mode_grid_hw.GRID (2K constellation x rate at GI 1/4, a guard sweep, 8K
spot modes, 2K alpha=4 and 8K alpha=2), 2 carried blocks each at 1 mux,
byte-exact with no RS correction, K1's and K2's calls there replayed
through the kernels and their plain versions; and ber_hw's four BER
points (2K and 8K AWGN hard, 2K F1 hard, 2K P1 soft) over 8 seeds under
ber_curves' limit rule.
Every phase raises on failure (nonzero exit).  The last line is one JSON
object {"ok": true, "device": {...}}; the line before it is the card's
name and power limit from nvidia-smi, and before that a JSON line with
each kernel's launches on the main path (and on every other path, each
counted alone), error and times.

Needs a CUDA device: without one it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RATES = ("1/2", "2/3", "3/4", "5/6", "7/8")
BENCH_STEPS = 4      # carried steps of the graph step against the eager one
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and int32 operations/s
# derived as 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (boost clock); the
# data sheet gives no int32 rate
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
# Viterbi ACS: two adds and one min that also gives the decision a
# state-step (Hopper's DPX VIMNMX keeps the smaller sum and sets a
# predicate).  Path-metric differences fit 16 bits, so the fastest ACS
# arithmetic is the packed 16-bit rate: two halves per int32 lane operation
# (VIMNMX.S16x2).  The bound counts the same operations whether a kernel
# packs or not.
OPS_PER_STATE_STEP = 3
PACKED16_OPS_S = 2 * INT32_OPS_S
# the BER points at full width (MODE_8K_UK, 4 blocks each): (demap, Annex B
# profile, SNR dB, the JAX package's curve in docs/).  The noise is the
# port's own, so a point must lie within BER_TOL of the curve's
# ber_post_viterbi for each of BER_SEEDS, and its packet error rate at most
# PER_MAX where the curve reads 0.  Planted faults show what the tolerance
# catches: the other demap at the same point must fall outside it, and the
# point FAULT_DB lower is read
BER_POINTS = (("soft", "P1", 20.0, "ber_8k_64qam_23_p1_soft"),
              ("hard", None, 19.0, "ber_8k_64qam_23_hard"),
              ("soft", None, 16.0, "ber_8k_64qam_23_soft"))
BER_BLOCKS = 4
BER_SEEDS = tuple(range(8))
BER_TOL = 0.15
PER_MAX = 0.005
FAULT_DB = 0.25
# the hierarchical 2K point: 2K 16-QAM alpha=2, HP 1/2, LP 3/4, soft, 6 dB,
# against docs/ber_2k_16qam_hier_a2_soft.jsonl (8 blocks there) within
# HIER_BER_TOL, over HIER_BER_BLOCKS blocks for each of HIER_BER_SEEDS
HIER_BER_TOL = 0.25
HIER_BER_BLOCKS = 32
HIER_BER_SEEDS = tuple(range(4))
# the streaming phase: raw 8K streams of STREAM_BLOCKS one-frame blocks
# with a delay and a carrier offset of STREAM_CFO subcarrier, fed in
# ragged chunks of STREAM_CHUNK samples.  The sample-clock loop is held at
# STREAM_PPM with pipeline=0: the time channel estimator of MODE_8K_UK
# follows a block-wise timing correction up to ~2 ppm (5 ppm leaves ~40%
# of the packets of every block uncorrectable, in the JAX package's
# receiver as in the port's), and with blocks in flight the loop's
# correction comes late and it oscillates.  Both limits are read at
# READ_PPM and at STREAM_PPM with pipeline=4 and printed, not held.
STREAM_BLOCKS = 24
STREAM_DELAY = 3001
STREAM_CFO = 0.31
STREAM_CHUNK = 1_000_003
STREAM_PPM = 2.0
READ_PPM = 40.0
TRACKED_FRAMES = 8
# the RS decoder's error classes: (fewest, most) byte errors a packet
RS_ERRORS = {"noiseless": (0, 0), "1-8 errors": (1, 8),
             "9-16 errors": (9, 16), "mix 0-16": (0, 16)}
# the soft demap kernel sums each row's |H|^2 in another order than
# torch.mean, so a metric on a rounding boundary may move one level: the
# share of metrics that may differ from the plain version's
DEMAP_SOFT_SHARE = 1e-4
DEMAP_ROWS = (8, 4 * 68)   # the flagship step's muxes and symbols
# the acquisition kernel against its plain version: both sum in float64,
# in other orders, so theta must be equal and cfo_frac within ACQ_CFO_TOL
# subcarrier; at the capture cells' shape (ACQ_MUX captures of
# ACQ_SYMBOLS 8K symbols, GI 1/32) at each of ACQ_SNRS dB, and at every
# (transmission, guard) at the streaming receiver's one-frame capture for
# 1 and ACQ_MUX captures
ACQ_CFO_TOL = 1e-6
ACQ_MUX, ACQ_SYMBOLS = 8, 409
ACQ_SNRS = (22.0, 28.0)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(n_bytes: float, n_ops: float,
          ops_s: float = INT32_OPS_S) -> tuple[float, str]:
    """(least ms the card could take, what sets it): each input read and
    each output written once over HBM, or the operations at the card's
    peak rate for their type (ops_s), whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / ops_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def viterbi_ops(n_mux: int, n_bits: int, body: int, ov: int,
                per_state_step: int = OPS_PER_STATE_STEP) -> float:
    """ACS operations of the overlapped-window decode: windows x steps x
    64 states x per_state_step."""
    n_win = -(-n_bits // body)
    return float(n_mux * n_win * (body + 2 * ov) * 64 * per_state_step)


def hier_2k():
    """The hierarchical 2K BER point's mode: 2K 16-QAM alpha=2, HP 1/2, LP
    3/4."""
    from dvbt_tpu_torch.mode import DvbtMode

    return DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4")


def ratio_to(r: dict, ref: dict, key: str = "ber_post_viterbi") -> float:
    """A BER point's ``key`` over the docs/ curve's."""
    return (r[key] or 0.0) / ref[key]


def doc_point(name: str, snr: float) -> dict:
    """The line of docs/<name>.jsonl (the JAX package's BER curve) at
    ``snr`` dB."""
    for line in (ROOT / "docs" / f"{name}.jsonl").read_text().splitlines():
        d = json.loads(line)
        if d["snr_db"] == snr:
            return d
    raise KeyError(f"{name} has no point at {snr} dB")


def counted(fn) -> tuple:
    """(fn(), a Counter of each kernel's launches during it): the
    difference of the port's launch count across fn()."""
    import torch

    from dvbt_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    before = _build.launches.copy()
    out = fn()
    torch.cuda.synchronize()
    return out, _build.launches - before


def rs_phase(card: str, dev) -> tuple[dict, dict, tuple]:
    """The RS decoder kernel against its plain version on the card, byte
    for byte (messages, n_corrected, uncorrectable), at the shape of every
    path that decodes: the UK and DE head-end steps and the capture pass (8
    muxes x 4 frames), 2K BER blocks of one frame, the hierarchical 8K HP
    and LP streams (8 muxes x 4 frames) and 2K ones (a frame), and odd
    sizes (1, 3, 65 packets; codewords not 16-byte aligned); each under
    RS_ERRORS: noiseless, 1-8 byte errors a packet, 9-16, and a mix of
    0-16, with a synchronize after each case.  Then the kernel's time at
    the UK step's 32,256 packets, noiseless and with 8 errors a packet,
    beside the plain version's.  Returns (the mismatching packets of each
    case, {error class: (kernel ms, plain ms)}, (bound ms, what sets
    it))."""
    import torch

    from dvbt_tpu_torch import MODE_8K_UK
    from dvbt_tpu_torch.coder_bench import profiler_ms
    from dvbt_tpu_torch.kernels import rs as krs
    from dvbt_tpu_torch.mode import DvbtMode
    from dvbt_tpu_torch.ops import reed_solomon
    from dvbt_tpu_torch.parallel.ring_bench import HIER_8K
    from dvbt_tpu_torch.viterbi_bench import event_ms

    gen = torch.Generator(device=dev).manual_seed(2028)
    encode = reed_solomon.make_rs_encoder(dev)
    decode = reed_solomon.make_rs_decoder(dev)
    plain = krs.make_rs_decoder_plain(dev)

    def codewords(lead, lo, hi):
        """Codewords of random messages with lo..hi byte errors (random
        nonzero values at distinct random positions) in each, and the
        errors a packet."""
        msg = torch.randint(0, 256, lead + (188,), generator=gen,
                            dtype=torch.uint8, device=dev)
        cw = encode(msg).reshape(-1, 204)
        n = cw.shape[0]
        n_err = torch.randint(lo, hi + 1, (n, 1), generator=gen, device=dev)
        rank = torch.rand(n, 204, generator=gen, device=dev).argsort(
            -1).argsort(-1)
        val = torch.randint(1, 256, (n, 204), generator=gen,
                            dtype=torch.uint8, device=dev)
        cw = cw ^ torch.where(rank < n_err, val, 0).to(torch.uint8)
        return cw.reshape(lead + (204,)), msg, n_err.reshape(lead)

    de = DvbtMode("8k", "16qam", "2/3", "1/4")
    h2k = hier_2k()
    shapes = {
        "UK head-end step and capture pass": (8, MODE_8K_UK.packets_per_block
                                              * 4),
        "DE head-end step": (8, de.packets_per_block * 4),
        "2K QPSK 1/2 BER block": (1, DvbtMode("2k", "qpsk",
                                              "1/2").packets_per_block),
        "2K 64-QAM 7/8 BER block": (1, DvbtMode("2k", "64qam",
                                                "7/8").packets_per_block),
        **{f"8K alpha=2 {s.upper()} step":
           (8, HIER_8K.stream_packets_per_block(s) * 4) for s in ("hp", "lp")},
        **{f"2K alpha=2 {s.upper()} block": (
            1, h2k.stream_packets_per_block(s)) for s in ("hp", "lp")},
        "1 packet": (1,), "3 packets": (3,), "65 packets": (65,),
    }
    cases = {}
    for name, lead in shapes.items():
        for cls, (lo, hi) in RS_ERRORS.items():
            cw, msg, n_err = codewords(lead, lo, hi)
            if name == "65 packets":      # a view 204 bytes in: not aligned
                cw = torch.cat([cw[:1], cw]).reshape(-1)[204:].reshape(
                    cw.shape)
                require(cw.data_ptr() % 16 != 0, "the unaligned case is "
                        "16-byte aligned")
            got = decode(cw)
            want = plain(cw)
            torch.cuda.synchronize()
            diff = ((got[0] != want[0]).any(-1) | (got[1] != want[1])
                    | (got[2] != want[2]))
            key = f"{name} {tuple(cw.shape)}, {cls}"
            cases[key] = int(diff.sum())
            require(cases[key] == 0, f"RS kernel at {key}: {cases[key]} "
                    "packets differ from the plain version")
            ok = n_err <= 8
            require(bool((got[1][ok] == n_err[ok]).all()
                         and (got[0][ok] == msg[ok]).all()
                         and not got[2][ok].any()),
                    f"RS kernel at {key} did not correct up to 8 errors")
    print(f"[rs] the RS kernel exact against its plain version in every "
          f"case (packets differing): {cases} ({card})", flush=True)

    # the kernel's own device time by the profiler (a call's host issue
    # may take longer than the kernel: CUDA events over back-to-back calls
    # then time the host, and are printed beside it)
    lead = shapes["UK head-end step and capture pass"]
    n_pk = lead[0] * lead[1]
    times, events = {}, {}
    for cls, (lo, hi) in (("noiseless", (0, 0)), ("8 errors", (8, 8))):
        cw, _, _ = codewords(lead, lo, hi)
        p1 = event_ms(lambda: plain(cw), 1)
        a = profiler_ms(lambda: decode(cw), 100, "rs_decode_kernel")
        b = profiler_ms(lambda: decode(cw), 100, "rs_decode_kernel")
        events[cls] = event_ms(lambda: decode(cw), 100)
        p2 = event_ms(lambda: plain(cw), 1)
        torch.cuda.synchronize()
        times[cls] = ((a + b) / 2, (p1 + p2) / 2)
    # bytes: each codeword read, each message, count and flag written once;
    # operations: the syndromes' 204 x 16 GF multiply-adds a packet, one
    # int32 operation each
    t_bound = bound(n_pk * (204 + 188 + 4 + 1), n_pk * 204 * 16)
    for cls, (ms, plain_ms) in times.items():
        print(f"[time] RS decode kernel at {n_pk} packets, {cls}: "
              f"{ms:.4f} ms by the profiler (bound {t_bound[0]:.4f} ms, "
              f"{t_bound[1]}; {t_bound[0] / ms:.1%} of it; events over "
              f"back-to-back calls {events[cls]:.4f} ms), plain "
              f"{plain_ms:.3f} ms ({card})", flush=True)
    return cases, times, t_bound


def rs_encode_phase(card: str, dev) -> tuple[dict, tuple, tuple]:
    """The RS encode kernel against its plain version on the card, byte for
    byte, at the shape of every path that encodes: the UK and DE head-end
    steps (8 muxes x 4 frames: 32,256 and 21,504 packets), the
    hierarchical HP and LP streams (10,752 and 24,192), 2K one-frame
    blocks (252 and 63 packets) and ragged counts (1, 3, 65 packets;
    messages not 16-byte aligned), each with random, all-zero, all-0xFF
    and TS packets (sync byte 0x47), with a synchronize after each case.
    Then the kernel's time at the UK step's 32,256 packets by the
    profiler, beside its bound and the plain version's time.  Returns
    (the mismatching packets of each case, (kernel ms, plain ms), (bound
    ms, what sets it))."""
    import torch

    from dvbt_tpu_torch import MODE_8K_UK, make_ts_packets
    from dvbt_tpu_torch.coder_bench import profiler_ms
    from dvbt_tpu_torch.kernels import rs as krs
    from dvbt_tpu_torch.mode import DvbtMode
    from dvbt_tpu_torch.ops import reed_solomon
    from dvbt_tpu_torch.parallel.ring_bench import HIER_8K
    from dvbt_tpu_torch.viterbi_bench import event_ms

    gen = torch.Generator(device=dev).manual_seed(2029)
    encode = reed_solomon.make_rs_encoder(dev)
    plain = krs.make_rs_encoder_plain(dev)
    kinds = {
        "random": lambda lead: torch.randint(
            0, 256, lead + (188,), generator=gen, dtype=torch.uint8,
            device=dev),
        "zeros": lambda lead: torch.zeros(lead + (188,), dtype=torch.uint8,
                                          device=dev),
        "all 0xFF": lambda lead: torch.full(lead + (188,), 0xFF,
                                            dtype=torch.uint8, device=dev),
        "TS packets": lambda lead: torch.as_tensor(make_ts_packets(
            math.prod(lead), seed=5).reshape(lead + (188,)), device=dev),
    }
    de = DvbtMode("8k", "16qam", "2/3", "1/4")
    shapes = {
        "UK head-end step": (8, MODE_8K_UK.packets_per_block * 4),
        "DE head-end step": (8, de.packets_per_block * 4),
        **{f"8K alpha=2 {s.upper()} step":
           (8, HIER_8K.stream_packets_per_block(s) * 4) for s in ("hp", "lp")},
        "2K 64-QAM 2/3 frame": (1, DvbtMode("2k", "64qam",
                                            "2/3").packets_per_block),
        "2K QPSK 1/2 frame": (1, DvbtMode("2k", "qpsk",
                                          "1/2").packets_per_block),
        "1 packet": (1,), "3 packets": (3,), "65 packets": (65,),
    }
    cases = {}
    for name, lead in shapes.items():
        for kind, make in kinds.items():
            msg = make(lead)
            if name == "65 packets":      # a view 188 bytes in: not aligned
                msg = torch.cat([msg[:1], msg]).reshape(-1)[188:].reshape(
                    msg.shape)
                require(msg.data_ptr() % 16 != 0, "the unaligned case is "
                        "16-byte aligned")
            got = encode(msg)
            want = plain(msg)
            torch.cuda.synchronize()
            key = f"{name} {tuple(msg.shape)}, {kind}"
            cases[key] = int((got != want).any(-1).sum())
            require(got.shape == want.shape and cases[key] == 0,
                    f"RS encode kernel at {key}: {cases[key]} packets "
                    "differ from the plain version")
    n_cases = len(cases)
    print(f"[rs_encode] the RS encode kernel exact against its plain "
          f"version in all {n_cases} cases ({card})", flush=True)

    lead = shapes["UK head-end step"]
    n_pk = math.prod(lead)
    msg = kinds["random"](lead)
    p1 = event_ms(lambda: plain(msg), 3)
    a = profiler_ms(lambda: encode(msg), 100, "rs_encode_kernel")
    b = profiler_ms(lambda: encode(msg), 100, "rs_encode_kernel")
    events = event_ms(lambda: encode(msg), 100)
    p2 = event_ms(lambda: plain(msg), 3)
    torch.cuda.synchronize()
    times = ((a + b) / 2, (p1 + p2) / 2)
    # bytes: each message read and each codeword written once; operations:
    # the LFSR's 188 x 16 GF multiply-adds a packet, one int32 operation
    # each
    t_bound = bound(n_pk * (188 + 204), n_pk * 188 * 16)
    print(f"[time] RS encode kernel at {n_pk} packets: {times[0]:.4f} ms by "
          f"the profiler (runs {a:.4f}, {b:.4f}; bound {t_bound[0]:.4f} ms, "
          f"{t_bound[1]}; {t_bound[0] / times[0]:.1%} of it; events over "
          f"back-to-back calls {events:.4f} ms), plain {times[1]:.3f} ms "
          f"({card})", flush=True)
    require(times[0] <= 10 * t_bound[0],
            f"the RS encode kernel takes {times[0]:.4f} ms, over 10x its "
            f"bound {t_bound[0]:.4f} ms")
    return cases, times, t_bound


def demap_phase(card: str, dev) -> tuple[dict, dict, dict]:
    """The demap kernel (the receiver's demap_deinterleave stage) against
    its plain version on the card at the flagship step's shape, 8 muxes x
    272 symbols: UK hard (8K 64-QAM), hierarchical alpha=2 hard (HP and LP
    out of one launch) and DE soft with CSI (8K 16-QAM).  Inputs: random
    cells through a 4-tap channel per mux with AWGN at 20 dB, equalized by
    the true channel; the hard cases also on cells at the decision
    boundaries (round half to even).  Hard metrics must be exact; soft
    ones within one level on at most DEMAP_SOFT_SHARE of the metrics.
    Then each case's kernel time by the profiler beside its bytes bound
    and the plain version's time by events.  Returns (each case's largest
    |difference| and share of differing metrics, (kernel ms, plain ms) a
    setup, (bound ms, what sets it) a setup)."""
    import torch

    from dvbt_tpu_torch import MODE_8K_UK
    from dvbt_tpu_torch.coder_bench import profiler_ms
    from dvbt_tpu_torch.kernels import demap as kdemap
    from dvbt_tpu_torch.mode import DvbtMode
    from dvbt_tpu_torch.ops import mapper
    from dvbt_tpu_torch.parallel.ring_bench import HIER_8K
    from dvbt_tpu_torch.viterbi_bench import event_ms

    n_mux, n_sym = DEMAP_ROWS
    gen = torch.Generator(device=dev).manual_seed(2030)
    setups = {"UK hard": (MODE_8K_UK, "hard"),
              "hier alpha=2 hard": (HIER_8K, "hard"),
              "DE soft CSI": (DvbtMode("8k", "16qam", "2/3", "1/4"), "soft")}

    def noisy(mode):
        """(X, H): equalized cells at 20 dB through a 4-tap channel."""
        K = mode.n_carriers
        pts = torch.as_tensor(mode.constellation_table().astype("complex64"),
                              device=dev)
        cells = pts[torch.randint(0, pts.numel(), (n_mux, n_sym, K),
                                  generator=gen, device=dev)]
        k = torch.arange(K, device=dev, dtype=torch.float32)
        delay = torch.rand(n_mux, 4, generator=gen, device=dev) * 64
        gain = torch.randn(n_mux, 4, 2, generator=gen, device=dev)
        gain = torch.complex(gain[..., 0], gain[..., 1]) / 2
        H = (gain[:, :, None] * torch.polar(
            torch.ones_like(delay[:, :, None] * k),
            -2 * math.pi * delay[:, :, None] * k / mode.fft_len)).sum(1)
        H = H[:, None].expand(n_mux, n_sym, K).contiguous()
        nz = torch.randn(n_mux, n_sym, K, 2, generator=gen, device=dev)
        noise = torch.complex(nz[..., 0], nz[..., 1]) * math.sqrt(0.01 / 2)
        return (cells * H + noise) / H, H

    def boundaries(mode):
        """Cells whose axes sit on the hard demapper's decision
        boundaries, |z| = (2 n + 1 + alpha) / scale, and on 0."""
        scale, alpha, m, _, _ = mapper._axis_tables(mode)
        lv = torch.arange(-1, m, device=dev, dtype=torch.float32)
        edges = torch.where(lv < 0, 0.0, (2 * lv + 1 + alpha) / scale)
        pick = torch.randint(0, lv.numel(), (n_mux, n_sym, mode.n_carriers,
                                             2), generator=gen, device=dev)
        sign = torch.randint(0, 2, pick.shape, generator=gen, device=dev)
        z = edges[pick] * (1 - 2 * sign)
        return torch.complex(z[..., 0], z[..., 1]).contiguous(), None

    cases, times, bounds = {}, {}, {}
    for name, (mode, demap) in setups.items():
        kernel = kdemap.make_demap_deinterleave(mode, dev, demap)
        plain = kdemap.make_demap_deinterleave_plain(mode, dev, demap)
        kinds = {"20 dB": noisy(mode)}
        if demap == "hard":
            kinds["boundaries"] = boundaries(mode)
        for kind, (X, H) in kinds.items():
            got, want = kernel(X, H), plain(X, H)
            torch.cuda.synchronize()
            require([g.shape for g in got] == [w.shape for w in want],
                    f"demap {name} {kind}: shapes {[g.shape for g in got]}")
            diff = torch.cat([(g.int() - w.int()).abs().reshape(-1)
                              for g, w in zip(got, want)])
            share = float((diff > 0).double().mean())
            key = f"{name}, {kind}"
            cases[key] = {"max_abs_err": int(diff.max()), "share": share}
            print(f"[demap] {key}: {len(got)} stream(s), "
                  f"{diff.numel()} metrics, {int((diff > 0).sum())} differ "
                  f"(share {share:.3g}, limit "
                  f"{0 if demap == 'hard' else DEMAP_SOFT_SHARE}), largest "
                  f"|difference| {int(diff.max())} ({card})", flush=True)
            if demap == "hard":
                require(share == 0, f"the demap kernel at {key} differs "
                                    "from its plain version")
            else:
                require(int(diff.max()) <= 1 and share <= DEMAP_SOFT_SHARE,
                        f"the demap kernel at {key}: share {share}, largest "
                        f"|difference| {int(diff.max())}")
        X, H = kinds["20 dB"]
        p1 = event_ms(lambda: plain(X, H), 3)
        a = profiler_ms(lambda: kernel(X, H), 100, "demap_kernel")
        b = profiler_ms(lambda: kernel(X, H), 100, "demap_kernel")
        p2 = event_ms(lambda: plain(X, H), 3)
        torch.cuda.synchronize()
        times[name] = ((a + b) / 2, (p1 + p2) / 2)
        # bytes: the carriers (and the channel estimate, soft) read once,
        # every stream's metrics written once
        n_out = sum(g.numel() for g in kernel(X, H))
        bounds[name] = bound(X.numel() * 8 * (2 if demap == "soft" else 1)
                             + n_out, 0)
        print(f"[time] demap kernel, {name}, {n_mux} x {n_sym} rows: "
              f"{times[name][0]:.4f} ms by the profiler (runs {a:.4f}, "
              f"{b:.4f}; bound {bounds[name][0]:.4f} ms, {bounds[name][1]}; "
              f"{bounds[name][0] / times[name][0]:.1%} of it), plain "
              f"{times[name][1]:.3f} ms ({card})", flush=True)
    return cases, times, bounds


def ofdm_captures(mode, n_mux: int, n_samples: int, snr_db: float, gen,
                  dev) -> tuple:
    """(captures complex64 (n_mux, n_samples), delays (n_mux,)): OFDM
    symbols of random QPSK carriers through the port's modulator, each
    capture from its own delay in [0, L), turned by its own carrier offset
    within +-4 subcarriers and phase, with AWGN at snr_db of its power."""
    import torch

    from dvbt_tpu_torch.ops import ofdm

    L, N, K = mode.symbol_len, mode.fft_len, mode.n_carriers
    n_sym = n_samples // L + 2
    iq = torch.randint(0, 2, (n_mux, n_sym, K, 2), generator=gen,
                       device=dev).to(torch.float32) * 2 - 1
    stream = ofdm.make_ofdm_modulator(mode, dev)(
        torch.complex(iq[..., 0], iq[..., 1]) / math.sqrt(2))
    del iq
    delay = torch.randint(0, L, (n_mux,), generator=gen, device=dev)
    cap = torch.gather(stream, 1, delay[:, None]
                       + torch.arange(n_samples, device=dev))
    del stream
    cfo = (torch.rand(n_mux, generator=gen, device=dev,
                      dtype=torch.float64) * 2 - 1) * 4
    phase = torch.rand(n_mux, generator=gen, device=dev,
                       dtype=torch.float64) * 2 * math.pi
    n = torch.arange(n_samples, device=dev, dtype=torch.float64)
    cap = cap * torch.polar(torch.ones_like(n), 2 * math.pi * cfo[:, None]
                            * n / N + phase[:, None]).to(torch.complex64)
    sigma = (cap.abs().pow(2).mean(-1, keepdim=True)
             / 10 ** (snr_db / 10)).sqrt()
    noise = torch.randn(cap.shape, generator=gen, device=dev,
                        dtype=torch.complex64)       # unit power
    return (cap + sigma * noise).contiguous(), delay


def acquire_phase(card: str, dev) -> tuple[dict, tuple, tuple]:
    """The acquisition kernel (the synchronizer's ofdm_sym_acquisition
    block) against its plain version on the card: at the capture cells'
    shape (8 x 409 8K GI 1/32 symbols) at 22 and 28 dB, and at every
    (transmission, guard) at the streaming receiver's one-frame capture for
    1 and 8 captures; OFDM captures with their own delay, carrier offset
    and phase.  theta must equal the plain version's and the true timing,
    cfo_frac lie within ACQ_CFO_TOL of the plain version's; two calls give
    the same bits; one call launches it once.  Then its time at the cells'
    shape by the profiler (the fold and the pick summed) beside its bytes
    bound and the plain version's by events.  Returns (each case's largest
    |cfo_frac difference|, (kernel ms, plain ms), (bound ms, what sets
    it))."""
    import torch

    from dvbt_tpu_torch.coder_bench import profiler_ms
    from dvbt_tpu_torch.kernels import acquire as kacquire
    from dvbt_tpu_torch.mode import DvbtMode
    from dvbt_tpu_torch.ops import sync as syncop
    from dvbt_tpu_torch.viterbi_bench import event_ms

    gen = torch.Generator(device=dev).manual_seed(2031)
    cell = DvbtMode("8k", "64qam", "2/3", "1/32")
    setups = [(f"cells' shape, {snr:g} dB", cell, ACQ_MUX,
               ACQ_SYMBOLS * cell.symbol_len, snr) for snr in ACQ_SNRS]
    for t in ("2k", "8k"):
        for g in ("1/4", "1/8", "1/16", "1/32"):
            mode = DvbtMode(t, "qpsk", "1/2", g)
            n = syncop.min_capture_samples(mode, 1)
            setups += [(f"{t} {g}, {m} x {n}", mode, m, n, 22.0)
                       for m in (1, ACQ_MUX)]
    cases = {}
    for name, mode, n_mux, n, snr in setups:
        caps, delay = ofdm_captures(mode, n_mux, n, snr, gen, dev)
        kernel = kacquire.make_symbol_acquisition(mode, n)
        plain = kacquire.make_symbol_acquisition_plain(mode, n)
        (th_k, cfo_k), launches = counted(lambda: kernel(caps))
        th_p, cfo_p = plain(caps)
        torch.cuda.synchronize()
        require(dict(launches) == {"acquire": 1},
                f"acquisition {name}: launches {dict(launches)}")
        require(torch.equal(th_k, th_p), f"acquisition {name}: theta "
                f"{th_k.tolist()} against the plain version's "
                f"{th_p.tolist()}")
        require(torch.equal(th_k.long(), (-delay) % mode.symbol_len),
                f"acquisition {name}: theta {th_k.tolist()} for delays "
                f"{delay.tolist()}")
        err = float((cfo_k.double() - cfo_p.double()).abs().max())
        require(err <= ACQ_CFO_TOL, f"acquisition {name}: cfo_frac off the "
                                    f"plain version's by {err}")
        cases[name] = err
        print(f"[acquire] {name}: theta equal, cfo_frac within {err:.3g} "
              f"(limit {ACQ_CFO_TOL:g}) ({card})", flush=True)
        if name == setups[0][0]:
            again = kernel(caps)
            require(torch.equal(again[0], th_k) and torch.equal(
                again[1].view(torch.int32), cfo_k.view(torch.int32)),
                "acquisition: two calls differ")
            cell_caps, cell_kernel, cell_plain = caps, kernel, plain
        del caps
    p1 = event_ms(lambda: cell_plain(cell_caps), 3)
    runs = [sum(profiler_ms(lambda: cell_kernel(cell_caps), 50, k)
                for k in ("acquire_fold_kernel", "acquire_pick_kernel"))
            for _ in range(2)]
    p2 = event_ms(lambda: cell_plain(cell_caps), 3)
    times = (sum(runs) / 2, (p1 + p2) / 2)
    bnd = bound(cell_caps.numel() * 8, 0)
    print(f"[time] acquisition kernel, {ACQ_MUX} x {cell_caps.shape[-1]} "
          f"samples: {times[0]:.4f} ms by the profiler (runs "
          f"{runs[0]:.4f}, {runs[1]:.4f}; bound {bnd[0]:.4f} ms, {bnd[1]}; "
          f"{bnd[0] / times[0]:.1%} of it), plain {times[1]:.3f} ms, the same "
          f"bits twice ({card})", flush=True)
    return cases, times, bnd


def k1_on_receiver_metrics(dev) -> tuple[int, float]:
    """K1 against its plain version on the soft receiver's own inputs: two
    MODE_8K_UK blocks (one frame each) through Annex B P1 and AWGN at 20
    dB into the CSI-weighted soft receiver, whose K1 calls are recorded
    (metrics, carried tail) and replayed through K1 and the plain version.
    The same blocks also go through a receiver whose demap stage is the
    plain version: its TS, flags and corrections must equal the kernel
    receiver's byte for byte.  Returns the largest |difference| and the
    share of graded metrics (not 0 or 15)."""
    import torch

    from dvbt_tpu_torch import MODE_8K_UK, make_ts_packets
    from dvbt_tpu_torch.kernels import demap as kdemap
    from dvbt_tpu_torch.kernels import viterbi as kvit
    from dvbt_tpu_torch.models import channel
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm

    mode = MODE_8K_UK
    tx, n_pk, _ = txm.make_transmitter(mode, dev)
    rx, _, _ = rxm.make_receiver(mode, dev, demap="soft", metrics="min")
    make = kdemap.make_demap_deinterleave
    kdemap.make_demap_deinterleave = kdemap.make_demap_deinterleave_plain
    try:
        rx_plain, _, _ = rxm.make_receiver(mode, dev, demap="soft",
                                           metrics="min")
    finally:
        kdemap.make_demap_deinterleave = make
    taps = channel.annex_b_taps("P1")
    gen = torch.Generator(device=dev).manual_seed(2027)
    tst = txm.init_tx_state(mode, 1, dev)
    rst = rxm.init_rx_state(mode, 1, dev)
    seen, blocks = [], []
    kernel = kvit.viterbi_punct

    def record(coded, tail, n_bits, rate, body):
        seen.append((coded.clone(), tail.clone(), n_bits, rate, body))
        return kernel(coded, tail, n_bits, rate, body)

    kvit.viterbi_punct = record
    try:
        for b in range(2):
            tst, iq = tx(tst, torch.as_tensor(make_ts_packets(
                n_pk, seed=40 + b), device=dev)[None])
            blocks.append(channel.awgn(gen, channel.multipath(iq, taps),
                                       20.0))
            rst, ts, met = rx(rst, blocks[-1])
            blocks[-1] = (blocks[-1], ts, met)
    finally:
        kvit.viterbi_punct = kernel
    require(len(seen) == 2, f"the soft receiver called K1 {len(seen)} "
                            "times over 2 blocks")
    rst = rxm.init_rx_state(mode, 1, dev)
    for b, (iq, ts, met) in enumerate(blocks):
        (rst, ts_p, met_p), launches = counted(lambda: rx_plain(rst, iq))
        require(launches.get("demap", 0) == 0,
                f"the plain receiver launched the demap kernel: {launches}")
        require(torch.equal(ts, ts_p) and all(
            torch.equal(met[k], met_p[k])
            for k in ("rs_uncorrectable", "rs_corrected")),
                f"the soft receiver's TS or RS flags of block {b} differ "
                "between the demap kernel and its plain version")
    err, graded = 0, []
    for blk, (coded, tail, n_bits, rate, body) in enumerate(seen):
        got = kernel(coded, tail, n_bits, rate, body)
        want = kvit.viterbi_punct_plain(coded, tail, n_bits, rate, body)
        err = max(err, int((got.int() - want.int()).abs().max()))
        require(torch.equal(got, want), f"K1 on the soft receiver's metrics, "
                f"block {blk}, differs from its plain version")
        graded.append(float(((coded > 0) & (coded < 15)).float().mean()))
    return err, min(graded)


def ber_phase(card: str, dev) -> dict:
    """The BER path at full width through apps.ber_sweep.run_point on the
    card: BER_POINTS at MODE_8K_UK over BER_SEEDS, each within BER_TOL of
    its docs/ curve; the planted faults; then ms per 8K BER block, hard
    and soft, on the host clock and from one profiler trace.  Returns K1's
    and K2's launches over the points and seeds."""
    from dvbt_tpu_torch import MODE_8K_UK, profile_slice
    from dvbt_tpu_torch.apps import ber_sweep
    from dvbt_tpu_torch.kernels import _build

    mode = MODE_8K_UK

    def points():
        return [(point, seed, ber_sweep.run_point(
            mode, point[2], BER_BLOCKS, seed, demap=point[0],
            profile=point[1], device=dev))
            for point in BER_POINTS for seed in BER_SEEDS]

    t0 = time.perf_counter()
    results, launches = counted(points)
    secs = time.perf_counter() - t0
    for point in BER_POINTS:
        demap, profile, snr, doc = point
        ref = doc_point(doc, snr)
        runs = [(seed, r) for p, seed, r in results if p == point]
        ratios = [ratio_to(r, ref) for _, r in runs]
        print(f"[ber] 8K 64-QAM 2/3 {demap} {profile or 'AWGN'} {snr} dB, "
              f"{BER_BLOCKS} blocks ({runs[0][1]['packets']} packets) a "
              f"seed, seeds {BER_SEEDS}: ber_post_viterbi "
              f"{[r['ber_post_viterbi'] for _, r in runs]}, docs/{doc} "
              f"{ref['ber_post_viterbi']}; ratios "
              f"{[round(x, 4) for x in ratios]}, largest |ratio - 1| "
              f"{max(abs(x - 1) for x in ratios):.4f} (tolerance {BER_TOL})"
              f"; per {[r['per'] for _, r in runs]} (docs {ref['per']}) "
              f"({card})", flush=True)
        for (seed, r), ratio in zip(runs, ratios):
            require(r["device"] == "gpu", f"BER point ran on {r['device']}")
            require(abs(ratio - 1) <= BER_TOL,
                    f"{demap} {profile} {snr} dB seed {seed}: "
                    f"ber_post_viterbi {r['ber_post_viterbi']} is not within "
                    f"{BER_TOL:.0%} of docs/{doc} ({ref['ber_post_viterbi']})")
            require(ref["per"] != 0 or r["per"] <= PER_MAX,
                    f"{demap} {profile} {snr} dB seed {seed}: per {r['per']}"
                    f" > {PER_MAX}")
    n = len(BER_POINTS) * len(BER_SEEDS) * BER_BLOCKS
    require(launches == {"viterbi_punct": n, "byte_coder": n,
                         "rs_decode": n, "rs_encode": 2 * n, "demap": n},
            f"the BER path did not launch K1, K2, the demap and the RS "
            f"decoder once a block and the RS encoder twice (TX, pre-RS "
            f"errors): {launches}")
    print(f"[ber] {len(results)} points in {secs:.2f} s with the build, "
          f"launches {launches}", flush=True)
    # planted faults, seed 0: the other demap (must fall outside BER_TOL),
    # and the same chain FAULT_DB lower (read only)
    for demap, profile, snr, doc in BER_POINTS:
        ref = doc_point(doc, snr)
        other = "hard" if demap == "soft" else "soft"
        for what, f_demap, f_snr in ((f"{other} demap", other, snr),
                                     (f"{FAULT_DB} dB lower", demap,
                                      snr - FAULT_DB)):
            r = ber_sweep.run_point(mode, f_snr, BER_BLOCKS, demap=f_demap,
                                    profile=profile, device=dev)
            ratio = ratio_to(r, ref)
            print(f"[ber] planted fault at {demap} {profile or 'AWGN'} {snr} "
                  f"dB, {what}: ber_post_viterbi {r['ber_post_viterbi']}, "
                  f"ratio to docs/{doc} {ratio:.4f} (tolerance {BER_TOL}); "
                  f"per {r['per']} ({card})", flush=True)
            require(f_demap == demap or abs(ratio - 1) > BER_TOL,
                    f"the {what} fault at {demap} {profile} {snr} dB falls "
                    f"inside the tolerance: ratio {ratio}")
    ms = {"hard": [], "soft": []}
    for demap in ("hard", "soft", "soft", "hard"):     # chains built above
        t0 = time.perf_counter()
        ber_sweep.run_point(mode, 19.0, BER_BLOCKS, demap=demap, device=dev)
        ms[demap].append((time.perf_counter() - t0) / BER_BLOCKS * 1e3)
    for demap, runs in ms.items():
        print(f"[time] BER block, 8K 64-QAM 2/3 {demap}, AWGN (TX, channel, "
              f"RX, host copies; 1 mux x 1 frame; runs of {BER_BLOCKS} "
              f"blocks, hard, soft, soft, hard): "
              f"{', '.join(f'{t:.3f}' for t in runs)} ms ({card})",
              flush=True)
    # the device's share of a BER block: one trace of run_point calls
    for demap in ("hard", "soft"):
        prof = profile_slice._profile(
            lambda: ber_sweep.run_point(mode, 19.0, BER_BLOCKS, demap=demap,
                                        device=dev),
            card, _build.BUILD_DIR / f"ber_{demap}_trace.json")
        print(f"[time] BER block, 8K 64-QAM 2/3 {demap}, AWGN, profiled "
              f"({profile_slice.PROFILED_STEPS} runs of {BER_BLOCKS} blocks, "
              f"one trace): device busy {prof['busy'] / BER_BLOCKS:.4f} ms, "
              f"wall {prof['wall'] / BER_BLOCKS:.4f} ms a block, idle share "
              f"{prof['idle']:.4f} ({card})", flush=True)
    return launches


def hierarchical_phase(card: str, dev) -> dict:
    """Hierarchical at full width: ring_bench.HIER_8K (8K 64-QAM alpha=2,
    HP 2/3, LP 3/4), 8 muxes x 4 frames, 2 noiseless TX -> RX steps: both
    streams byte-exact, K1 and K2 launched twice a step; the step's time;
    then the 2K alpha=2 soft point at 6 dB against its docs/ curve.
    Returns the launches of both."""
    import numpy as np
    import torch

    from dvbt_tpu_torch import make_ts_packets
    from dvbt_tpu_torch.apps import ber_sweep
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm
    from dvbt_tpu_torch.ops.outer_interleaver import DELAY_PACKETS
    from dvbt_tpu_torch.parallel.ring_bench import HIER_8K

    mode, n_mux, n_frames, n_steps = HIER_8K, 8, 4, 2
    tx, n_pk, _ = txm.make_transmitter(mode, dev, n_frames)
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames, metrics="min")
    sent = [make_ts_packets(n * n_mux * n_steps, seed=31 + k).reshape(
        n_steps, n_mux, n, 188) for k, n in enumerate(n_pk)]
    packets = [torch.as_tensor(x, device=dev) for x in sent]
    st = {"tx": txm.init_tx_state(mode, n_mux, dev),
          "rx": rxm.init_rx_state(mode, n_mux, dev)}

    def step(s):
        st["tx"], iq = tx(st["tx"], tuple(p[s] for p in packets))
        st["rx"], ts, m = rx(st["rx"], iq)
        return ts, m

    def run():
        return [step(s) for s in range(n_steps)]

    outs, launches = counted(run)
    require(launches == {"viterbi_punct": 2 * n_steps,
                         "byte_coder": 2 * n_steps, "rs_decode": 2 * n_steps,
                         "rs_encode": 2 * n_steps, "demap": n_steps},
            f"the hierarchical step did not launch K1, K2 and the RS decoder "
            f"and encoder twice and the demap once: {launches}")
    for k, key in enumerate(("rs_uncorrectable", "lp_rs_uncorrectable")):
        got = np.concatenate([ts[k].cpu().numpy() for ts, _ in outs], axis=1)
        want = sent[k].transpose(1, 0, 2, 3).reshape(n_mux, -1, 188)
        require(np.array_equal(got[:, DELAY_PACKETS:],
                               want[:, :-DELAY_PACKETS]),
                f"hierarchical {('HP', 'LP')[k]} TS differs from the packets "
                "sent")
        bad = torch.cat([m[key] for _, m in outs], dim=1)[:, DELAY_PACKETS:]
        require(not bool(bad.any()), f"hierarchical {key} after warm-up")
    for _ in range(2):
        step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"[hier] 8K 64-QAM alpha=2 HP 2/3 ({n_pk[0]} packets) + LP 3/4 "
          f"({n_pk[1]}), {n_mux} muxes x {n_frames} frames x {n_steps} "
          f"steps: both streams byte-exact after {DELAY_PACKETS} packets, "
          f"rs_uncorrectable 0, launches {launches}", flush=True)
    print(f"[time] hierarchical TX+RX step, {n_mux} muxes x {n_frames} "
          f"frames: {step_ms:.3f} ms/step ({card})", flush=True)

    mode2 = hier_2k()
    ref = doc_point("ber_2k_16qam_hier_a2_soft", 6.0)
    runs, launches2 = counted(lambda: [ber_sweep.run_point(
        mode2, 6.0, HIER_BER_BLOCKS, seed, demap="soft", device=dev)
        for seed in HIER_BER_SEEDS])
    ratios = [ratio_to(r, ref) for r in runs]
    print(f"[ber] 2K 16-QAM alpha=2 soft 6 dB, {HIER_BER_BLOCKS} blocks a "
          f"seed, seeds {HIER_BER_SEEDS}: HP ber_post_viterbi "
          f"{[r['ber_post_viterbi'] for r in runs]}, docs "
          f"{ref['ber_post_viterbi']}; ratios {[round(x, 4) for x in ratios]}"
          f", largest |ratio - 1| {max(abs(x - 1) for x in ratios):.4f} "
          f"(tolerance {HIER_BER_TOL}); per {[r['per'] for r in runs]}, "
          f"lp_per {[r['lp_per'] for r in runs]} (docs {ref['per']}, "
          f"{ref['lp_per']}); launches {launches2} ({card})", flush=True)
    for seed, r, ratio in zip(HIER_BER_SEEDS, runs, ratios):
        require(abs(ratio - 1) <= HIER_BER_TOL and r["per"] <= PER_MAX,
                f"2K alpha=2 soft 6 dB seed {seed}: {r} against docs {ref}")
        require(r["lp_per"] >= 0.99, f"the LP stream decoded at 6 dB: {r}")
    n = 2 * HIER_BER_BLOCKS * len(HIER_BER_SEEDS)
    require(launches2 == {"viterbi_punct": n, "byte_coder": n,
                          "rs_decode": n, "rs_encode": 2 * n,
                          "demap": n // 2},
            f"the 2K hierarchical point's launches: {launches2}")
    # planted fault, seed 0: hard metrics where soft are expected
    r = ber_sweep.run_point(mode2, 6.0, HIER_BER_BLOCKS, demap="hard",
                            device=dev)
    ratio = ratio_to(r, ref)
    print(f"[ber] planted fault at 2K alpha=2 soft 6 dB, hard demap: HP "
          f"ber_post_viterbi {r['ber_post_viterbi']}, ratio {ratio:.4f} "
          f"(tolerance {HIER_BER_TOL}); per {r['per']} ({card})", flush=True)
    require(abs(ratio - 1) > HIER_BER_TOL,
            f"the hard-demap fault at 2K alpha=2 6 dB falls inside the "
            f"tolerance: ratio {ratio}")
    return {"hierarchical_8k": launches, "hierarchical_2k_ber": launches2}


def validation_phase(card: str, dev) -> tuple[dict, dict, dict]:
    """The on-card validation tools: tools.mode_grid_hw.GRID in full (25
    modes x 2 carried blocks, 1 mux), each byte-exact with no RS
    correction, K1's and K2's calls recorded and replayed through the
    kernels and their plain versions (every shape the grid runs: 2K and 8K
    blocks, rate 7/8 at GI 1/16, the alpha=4 LP stream); then tools.ber_hw's
    four points over BER_SEEDS under tools.ber_curves' limit rule.
    Returns the launches on each, and K1's and K2's parity cases."""
    import torch

    from dvbt_tpu_torch.kernels import coder as kcoder
    from dvbt_tpu_torch.kernels import viterbi as kvit
    from dvbt_tpu_torch.tools import ber_curves, ber_hw, mode_grid_hw

    t_phase = time.perf_counter()
    k1, k2 = kvit.viterbi_punct, kcoder.byte_coder
    k1_calls, k2_calls = [], []

    def record_k1(coded, tail, n_bits, rate, body):
        k1_calls.append((coded.clone(), tail.clone(), n_bits, rate, body))
        return k1(coded, tail, n_bits, rate, body)

    def record_k2(state6, stream, rate):
        k2_calls.append((state6.clone(), stream.clone(), rate))
        return k2(state6, stream, rate)

    def grid():
        return {name: mode_grid_hw.run_mode(mode, dev)
                for name, mode in mode_grid_hw.GRID}

    kvit.viterbi_punct, kcoder.byte_coder = record_k1, record_k2
    try:
        results, grid_launches = counted(grid)
    finally:
        kvit.viterbi_punct, kcoder.byte_coder = k1, k2
    t_grid = time.perf_counter() - t_phase
    for name, r in results.items():
        print(f"[grid] {name:18s} {json.dumps(r)} ({card})", flush=True)
    green = [name for name, r in results.items()
             if r["byte_exact"] and r["rs_corrected"] == 0]
    require(len(green) == len(mode_grid_hw.GRID) == 25,
            f"mode grid: {len(green)}/25 green: {results}")
    n = sum(2 * len(m.streams) for _, m in mode_grid_hw.GRID)
    require(grid_launches == {"viterbi_punct": n, "byte_coder": n,
                              "rs_decode": n, "rs_encode": n,
                              "demap": 2 * len(mode_grid_hw.GRID)},
            f"the mode grid did not launch K1, K2 and the RS decoder and "
            f"encoder once a block and stream, the demap once a block: "
            f"{grid_launches}")
    # every recorded call through the kernel, as the grid made it, and its
    # plain version: the calls of one shape stacked on the mux axis into
    # one plain call (its rows are independent; each plain call is a few
    # thousand small launches)
    k1_cases, k2_cases = {}, {}
    shapes = {}
    for coded, tail, n_bits, rate, body in k1_calls:
        shapes.setdefault((n_bits, rate, body), []).append((coded, tail))
    for (n_bits, rate, body), calls in shapes.items():
        got = torch.cat([k1(c, t, n_bits, rate, body) for c, t in calls])
        want = kvit.viterbi_punct_plain(
            torch.cat([c for c, _ in calls]),
            torch.cat([t for _, t in calls]), n_bits, rate, body)
        key = f"mode grid, rate {rate}, {n_bits} bits"
        k1_cases[key] = int((got.int() - want.int()).abs().max())
        require(torch.equal(got, want), f"K1 at the grid's {key} differs "
                                        "from its plain version")
    for state6, stream, rate in k2_calls:
        st_k, got = k2(state6, stream, rate)
        st_p, want = kcoder.byte_coder_plain(state6, stream, rate)
        key = f"mode grid, rate {rate}, {stream.shape[-1]} bytes"
        k2_cases[key] = max(k2_cases.get(key, 0),
                            int((got.int() - want.int()).abs().max()))
        require(torch.equal(got, want) and torch.equal(st_k, st_p),
                f"K2 at the grid's {key} differs from its plain version")
    print(f"[grid] {len(green)}/25 modes byte-exact with rs_corrected 0 in "
          f"{t_grid:.2f} s; launches {grid_launches}; K1 exact on "
          f"{len(k1_calls)} recorded calls at {len(shapes)} shapes, K2 on "
          f"{len(k2_calls)} at {len(k2_cases)} ({card})", flush=True)

    t0 = time.perf_counter()
    lines, ber_launches = counted(lambda: ber_hw.run(dev, BER_SEEDS))
    for line in lines:
        print(f"[ber_hw] {json.dumps(line)}", flush=True)
        require(line["device"] == "gpu" and line["pass"],
                f"ber_hw {line['curve']} {line['snr_db']} dB misses "
                f"ber_curves' rule over seeds {BER_SEEDS}: {line}")
    n = sum(p[2] for p in ber_hw.POINTS) * len(BER_SEEDS)
    require(ber_launches == {"viterbi_punct": n, "byte_coder": n,
                             "rs_decode": n, "rs_encode": 2 * n,
                             "demap": n},
            f"ber_hw did not launch K1, K2, the demap and the RS decoder "
            f"once a block and the RS encoder twice: {ber_launches}")
    print(f"[ber_hw] {len(lines)} points within ber_curves' rule "
          f"(spread_k {ber_curves.SPREAD_K}, floor {ber_curves.REL_FLOOR}) "
          f"over seeds {BER_SEEDS} in {time.perf_counter() - t0:.2f} s; "
          f"launches {ber_launches}; the validation phase took "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return ({"mode_grid": grid_launches, "ber_hw": ber_launches},
            k1_cases, k2_cases)


def _stream_check(reports, packets, n_pk, block_samples, delay, ppm,
                  what: str) -> int:
    """Hard checks of one streaming run: lock at the first report and
    held, no uncorrectable packet after it, the TS the packets sent from
    the locked block on.  Returns the packets compared."""
    from dvbt_tpu_torch.ops import sync as syncop
    from dvbt_tpu_torch.ops.outer_interleaver import DELAY_PACKETS
    import numpy as np

    require(len(reports) >= 3 and reports[0].reacquired,
            f"{what}: no lock ({len(reports)} reports)")
    reacq = sum(bool(r.reacquired) for r in reports[1:])
    bad = sum(int(r.rs_uncorrectable.sum()) for r in reports[1:])
    require(reacq == 0 and bad == 0, f"{what}: {reacq} re-acquisitions, "
            f"{bad} uncorrectable packets after lock")
    f = 1.0 + ppm * 1e-6
    k0 = round(((reports[0].stream_offset + delay) / f
                + syncop.DEFAULT_BACKOFF) / block_samples)
    out = np.concatenate([r.packets for r in reports])[DELAY_PACKETS:]
    want = packets[k0 * n_pk:]
    n = min(len(out), len(want))
    require(n >= (len(reports) - 1) * n_pk and np.array_equal(
        out[:n], want[:n]), f"{what}: the TS differs from the packets sent")
    return n


def streaming_phase(card: str, dev, mode=None, hier=None,
                    frames: int = TRACKED_FRAMES,
                    app_args: tuple = ()) -> dict:
    """The streaming receiver at full width (MODE_8K_UK; the rehearsal on
    the CPU passes 2K modes): models.loopback.StreamingReceiver with
    pipeline=4 on a raw stream with a delay and CFO, then the sample-clock
    loop at STREAM_PPM (held) and its limits (read), a checkpoint resume,
    AutoStreamingReceiver on a single-stream and an alpha=2 capture, a
    profiled tracked block, and the tx and rx apps through files.  Returns
    each kernel's launches on the streaming drive."""
    import tempfile

    import numpy as np
    import torch

    from dvbt_tpu_torch import MODE_8K_UK, make_ts_packets
    from dvbt_tpu_torch import profile_slice
    from dvbt_tpu_torch.io import ts as tsio
    from dvbt_tpu_torch.models import auto, channel
    from dvbt_tpu_torch.models import tx as txm
    from dvbt_tpu_torch.models.loopback import StreamingReceiver
    from dvbt_tpu_torch.ops import sync as syncop
    from dvbt_tpu_torch.ops.outer_interleaver import DELAY_PACKETS
    from dvbt_tpu_torch.parallel.ring_bench import HIER_8K

    mode = mode or MODE_8K_UK
    hier = hier or HIER_8K
    t_phase = time.perf_counter()

    def tx_stream(m, n_blocks, seed):
        """[packets per stream], packets a block per stream, complex64
        stream at STREAM_CFO (numpy)."""
        tx, n_pk, _ = txm.make_transmitter(m, dev)
        n_pk = n_pk if m.hierarchical else (n_pk,)
        pks = [make_ts_packets(n * n_blocks, seed=seed + k)
               for k, n in enumerate(n_pk)]
        st = txm.init_tx_state(m, 1, dev)
        chunks = []
        for b in range(n_blocks):
            arg = [torch.as_tensor(p[b * n:(b + 1) * n], device=dev)[None]
                   for p, n in zip(pks, n_pk)]
            st, iq = tx(st, tuple(arg) if m.hierarchical else arg[0])
            chunks.append(iq)
        iq = channel.apply_cfo(torch.cat(chunks, dim=-1), STREAM_CFO,
                               m.fft_len)
        return pks, n_pk, iq[0].cpu().numpy()

    def feed(srx, stream):
        reports = []
        for pos in range(0, len(stream), STREAM_CHUNK):
            reports += srx.feed(stream[pos:pos + STREAM_CHUNK])
        return reports + srx.flush()

    (pk,), (n_pk,), clean = tx_stream(mode, STREAM_BLOCKS, 41)
    stream = clean[STREAM_DELAY:]

    # the streaming drive: pipeline=4, launches counted alone; nothing in
    # a locked dispatch may wait for the device (PyTorch's sync debug
    # mode raises on any op that would)
    srx = StreamingReceiver(mode, dev, pipeline=4)
    dispatch = srx._dispatch

    def dispatch_without_syncs():
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch()
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")

    srx._dispatch = dispatch_without_syncs
    reports, launches = counted(lambda: feed(srx, stream))
    n = _stream_check(reports, pk, n_pk, srx.block_samples, STREAM_DELAY,
                      0.0, "pipeline=4")
    require(launches["viterbi_punct"] == launches["rs_decode"]
            == launches["demap"] == len(reports),
            f"the streaming drive launched K1 {launches['viterbi_punct']}, "
            f"the RS decoder {launches['rs_decode']} and the demap "
            f"{launches['demap']} times for {len(reports)} blocks")
    print(f"[stream] {mode.transmission} {mode.constellation} "
          f"{mode.code_rate}, {STREAM_BLOCKS} one-frame blocks, delay "
          f"{STREAM_DELAY}, CFO {STREAM_CFO}, chunks of {STREAM_CHUNK}, "
          f"pipeline=4: locked at {reports[0].stream_offset} (cfo_int "
          f"{int(reports[0].info['cfo_int'])}, cfo_frac "
          f"{float(reports[0].info['cfo_frac']):.5f}), {len(reports)} "
          f"blocks, no re-acquisition, rs_uncorrectable 0 after lock, TS "
          f"byte-exact over {n} packets, no device sync in a locked "
          f"dispatch, launches {launches}", flush=True)

    # the sample-clock loop: held at STREAM_PPM (pipeline=0), its limits read
    for ppm, pipeline, hold in ((STREAM_PPM, 0, True),
                                (STREAM_PPM, 4, False),
                                (READ_PPM, 0, False)):
        s = channel.resample_ppm(clean, ppm)[STREAM_DELAY:]
        srx = StreamingReceiver(mode, dev, pipeline=pipeline)
        reps = feed(srx, s)
        adj = sum(r.timing_adj for r in reps)
        drift = len(s) * ppm * 1e-6
        bad = [int(r.rs_uncorrectable.sum()) for r in reps[1:]]
        reacq = sum(bool(r.reacquired) for r in reps[1:])
        taus = [r.timing_tau for r in reps]
        print(f"[stream] {ppm:+g} ppm, pipeline={pipeline} "
              f"({'held' if hold else 'read'}): {len(reps)} blocks, "
              f"timing_adj total {adj} for a drift of {drift:.1f} samples, "
              f"timing_tau {min(taus):.2f}..{max(taus):.2f}, "
              f"re-acquisitions {reacq}, uncorrectable packets after lock "
              f"{sum(bad)} of {sum(len(r.rs_uncorrectable) for r in reps[1:])}"
              f" (per block {bad})", flush=True)
        if hold:
            _stream_check(reps, pk, n_pk, srx.block_samples, STREAM_DELAY,
                          ppm, f"{ppm} ppm")
            require(adj > 0 and abs(adj - drift) < 0.25 * drift + 6,
                    f"{ppm} ppm: timing_adj total {adj}, drift {drift}")

    # checkpoint: saved mid-stream, restored into a new receiver
    half = len(stream) // 2
    a = StreamingReceiver(mode, dev, pipeline=4)
    got = [r.packets for r in feed(a, stream[:half])]
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/rx.npz"
        a.save(path)
        del a
        b = StreamingReceiver(mode, dev, pipeline=4)
        b.restore(path)
        got += [r.packets for r in feed(b, stream[half:])]
    require(len(got) == len(reports) and all(
        np.array_equal(g, r.packets) for g, r in zip(got, reports)),
        "the resumed stream differs from the uninterrupted one")
    print(f"[stream] checkpoint at sample {half} (pipeline=4): "
          f"{len(got)} blocks byte-identical to the uninterrupted run",
          flush=True)

    # mode detection: told only the transmission mode
    for m, (pks, n_pks, s) in ((mode, ([pk], [n_pk], stream)),
                               (hier, tx_stream(hier, 8, 43))):
        if m is hier:
            s = s[STREAM_DELAY:]
        arx = auto.AutoStreamingReceiver(m.transmission, dev)
        reps = feed(arx, s)
        got_m = arx.detected_mode
        fields = ("transmission", "constellation", "code_rate", "guard",
                  "alpha") + (("code_rate_lp",) if m.hierarchical else ())
        require(all(getattr(got_m, f) == getattr(m, f) for f in fields),
                f"detected {got_m}, sent {m}")
        n = _stream_check(reps, pks[0], n_pks[0], arx.block_samples,
                          STREAM_DELAY, 0.0, f"auto {m}")
        if m.hierarchical:
            lp = np.concatenate([r.packets_lp for r in reps])
            k0 = round((reps[0].stream_offset + STREAM_DELAY
                        + syncop.DEFAULT_BACKOFF) / arx.block_samples)
            want = pks[1][k0 * n_pks[1]:]
            n_lp = min(len(lp) - DELAY_PACKETS, len(want))
            require(np.array_equal(lp[DELAY_PACKETS:][:n_lp], want[:n_lp])
                    and not any(r.lp_rs_uncorrectable.any()
                                for r in reps[1:]),
                    "auto alpha=2: the LP stream differs")
        print(f"[stream] auto-detected {got_m} (guard scores "
              f"{ {k: round(v, 4) for k, v in arx.detect_info['guard_scores'].items()} }"
              f"): TS byte-exact over {n} packets"
              f"{', LP too' if m.hierarchical else ''}", flush=True)

    # tracked blocks, one profiled
    prof = profile_slice._stream(dev, card, frames, mode)
    print(f"[time] tracked block ({frames} frames, pipeline=4), profiled "
          f"({profile_slice.PROFILED_STEPS} blocks, one trace): device busy "
          f"{prof['busy']:.4f} ms, wall {prof['wall']:.4f} ms a block, idle "
          f"share {prof['idle']:.4f} ({card})", flush=True)

    # the apps, through files
    n_app = 4
    with tempfile.TemporaryDirectory() as td:
        app_pk = make_ts_packets(n_pk * n_app, seed=44)
        tsio.write_ts_file(f"{td}/in.ts", app_pk)
        flags = ["-t", mode.transmission, "-c", mode.constellation, "-r",
                 mode.code_rate, "-g", mode.guard, *app_args]
        t0 = time.perf_counter()
        for app, io in (("tx", ["--in", f"{td}/in.ts", "--out",
                                f"{td}/air.iq"]),
                        ("rx", ["--in", f"{td}/air.iq", "--out",
                                f"{td}/out.ts"])):
            proc = subprocess.run(
                [sys.executable, "-m", f"dvbt_tpu_torch.apps.{app}", *io,
                 *flags], cwd=ROOT, capture_output=True, text=True,
                timeout=300)
            require(proc.returncode == 0, f"apps.{app} exited "
                    f"{proc.returncode}: {proc.stderr[-2000:]}")
            print(f"[stream] apps.{app}: {proc.stderr.strip()}", flush=True)
        got = tsio.read_ts_file(f"{td}/out.ts")
        b0 = (len(app_pk) - len(got) - DELAY_PACKETS) // n_pk
        require(len(got) > n_pk and np.array_equal(
            got, app_pk[b0 * n_pk:][:len(got)]),
            "apps.tx -> apps.rx: the TS differs from the input")
    print(f"[stream] apps.tx -> apps.rx through files: {len(got)} packets "
          f"equal to the input in {time.perf_counter() - t0:.1f} s; the "
          f"streaming phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"streaming": launches}


def parallel_phase(card: str) -> tuple[dict, dict]:
    """Phase 7: 4 ranks on the one card (ring_bench.rank_main: K4 against
    its plain version and lone calls that must time out, on both routes,
    the dryrun at the flagship mode, its soft and hierarchical variants on
    each of K4's routes, K4 and step timings); returns K4's entry of the
    kernels line and every kernel's launches on each dryrun."""
    import os

    from dvbt_tpu_torch.kernels import _build
    from dvbt_tpu_torch.parallel import multihost, ring_bench, sharding

    n_ranks = 4
    out_path = _build.BUILD_DIR / f"parallel_{os.getpid()}.json"
    out_path.unlink(missing_ok=True)
    t0 = time.time()
    multihost.launch(ring_bench.rank_main, n_ranks, args=(str(out_path),),
                     timeout_s=300, deadline_s=900)
    res = json.loads(out_path.read_text())
    routes = {r["waits"]: r for r in res["routes"]}
    print(f"[parallel] {n_ranks} ranks on one card in "
          f"{time.time() - t0:.1f} s: K4 byte-exact against its plain "
          f"version on {res['payloads']} over 4 calls each, waiting "
          f"{sorted(routes)}; dryrun stages "
          f"{ {k: round(v['seconds'], 2) for k, v in res['dryrun'].items()} }"
          f", launches {res['launches']}; lone calls raised: "
          f"{[r['timeout_error'] for r in res['routes']]}", flush=True)
    require(sorted(routes) == ["in stream order", "on the SMs"],
            f"K4 was not checked on both routes: {sorted(routes)}")
    for waits, r in routes.items():
        require(r["k4_err"] == 0, f"K4 waiting {waits} differs: {r}")
        require(len(r["timeout_error"]) == 2,
                f"not both lone K4 calls waiting {waits} raised: {r}")
    require(res["launches"]["ring_shift"] > 0,
            f"the time-sharded path did not launch K4: {res['launches']}")
    require(res["launches"]["viterbi_depunct"] > 0,
            f"the halo recompute did not launch K3: {res['launches']}")
    for key, t in res["times"].items():
        require(t["waits"] == "in stream order",
                f"K4 with 4 ranks on one card waited {t['waits']}")
        print(f"[time] ring_shift {key} halo {t['bytes']} B, 4 ranks on one "
              f"card (includes the neighbour barrier across time-sliced "
              f"contexts, waited {t['waits']}): K4 {t['k4']:.4f} ms, "
              f"plain send/recv "
              f"{t['plain']:.4f} ms, runs {t['runs']} ({card})",
              flush=True)
    print(f"[time] time-sharded step, 4 ranks x 1 frame, host clock: "
          f"{res['step_ms']} ms ({card})", flush=True)
    by_path = {"dryrun": res["launches"]}
    steps = n_ranks * sharding.N_STEPS
    for v in res["variants"]:
        n_streams = 2 if v["name"] == "hierarchical" else 1
        # 4 x steps: each stream's TX and RX in the mux-DP stage, both
        # time-sharded stages and rank 0's streaming reference; 2 x (steps
        # - 1): the halo state recomputed (K3 decode, RS re-encode) in
        # both time-sharded stages on every block but the first (its
        # demap is the plain composition); the demap once an RX call
        want = {"ring_shift": (n_streams + 1) * steps, "demap": 4 * steps,
                "viterbi_depunct": n_streams * 2 * (steps - 1),
                "viterbi_punct": n_streams * 4 * steps,
                "byte_coder": n_streams * 4 * steps,
                "rs_decode": n_streams * 4 * steps,
                "rs_encode": n_streams * (4 * steps + 2 * (steps - 1))}
        print(f"[parallel] dryrun {v['name']} ({v['demap']} demap), K4 "
              f"waiting {v['waits']}: stages "
              f"{ {k: round(x['seconds'], 2) for k, x in v['dryrun'].items()} }"
              f" s, launches {v['launches']} ({card})", flush=True)
        require(v["launches"] == want,
                f"dryrun {v['name']} waiting {v['waits']}: launches "
                f"{v['launches']}, expected {want}")
        by_path[f"dryrun_{v['name']}"] = v["launches"]
    require(sorted((v["name"], v["waits"]) for v in res["variants"]) == [
        (n, w) for n in ("hierarchical", "soft")
        for w in ("in stream order", "on the SMs")],
        "the soft and hierarchical dryruns did not run on both K4 routes")
    iq = res["times"]["iq"]
    t_bound, by = bound(2 * iq["bytes"], 0)
    return {"name": "ring_shift", "route": "cuda",
            "source": "dvbt_tpu_torch/csrc/ring.cu",
            "replaces": "dvbt_tpu/parallel/ring.py:30",
            "launches": res["launches"]["ring_shift"],
            "max_abs_err": res["k4_err"], "ms": iq["k4"],
            "plain_ms": iq["plain"], "bound_ms": t_bound,
            "bound_by": by, "library_ms": None}, by_path


def bench_phase(dev) -> tuple[dict, dict]:
    """Phase 8: the graph step the benchmark drives (dvbt_tpu_torch.bench).
    The flagship step captured into a CUDA graph and the eager step run
    BENCH_STEPS carried steps from the same initial state and packets: TS,
    rs_uncorrectable and every carried-state leaf byte-identical, the TS
    the packets sent.  Returns each kernel's launches in one replay of the
    graph, and over the carried steps (one capture and its replays, and
    the eager steps)."""
    import numpy as np
    import torch

    from dvbt_tpu_torch import MODE_8K_UK, bench, make_ts_packets
    from dvbt_tpu_torch.kernels import _build
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm
    from dvbt_tpu_torch.ops.outer_interleaver import DELAY_PACKETS

    mode, n_mux, n_frames = MODE_8K_UK, 8, 4
    torch.cuda.synchronize()
    before = _build.launches.copy()
    t0 = time.time()
    graphed = bench.make_step(mode, dev, n_mux, n_frames, graph=True)
    t_capture = time.time() - t0
    eager = bench.make_step(mode, dev, n_mux, n_frames, graph=False)
    n_pk = graphed.n_packets
    sent = make_ts_packets(n_pk * n_mux * BENCH_STEPS, seed=13).reshape(
        BENCH_STEPS, n_mux, n_pk, 188)
    packets = torch.as_tensor(sent, device=dev)

    def carried(step):
        """[[(name, tensor)] of each step's outputs and carried state]."""
        tst = txm.init_tx_state(mode, n_mux, dev)
        rst = rxm.init_rx_state(mode, n_mux, dev)
        out = []
        for s in range(BENCH_STEPS):
            tst, rst, ts, bad = step(tst, rst, packets[s])
            out.append([(n, t.clone()) for n, t in (
                [("ts", ts), ("rs_uncorrectable", bad)]
                + bench.state_leaves(tst, rst))])
        return out

    got, want = carried(graphed), carried(eager)
    torch.cuda.synchronize()
    launches = _build.launches - before
    require(graphed.captured == bench.CAPTURED_LAUNCHES,
            f"the captured step launched {graphed.captured}, not "
            f"{bench.CAPTURED_LAUNCHES}")
    require(launches.keys() == bench.CAPTURED_LAUNCHES.keys(),
            f"the graph and eager steps launched {launches}")
    for s, (g_out, e_out) in enumerate(zip(got, want)):
        for (name, g), (_, e) in zip(g_out, e_out):
            require(g.dtype == e.dtype and g.shape == e.shape and torch.equal(
                g.reshape(-1).view(torch.uint8),
                e.reshape(-1).view(torch.uint8)),
                f"step {s}: {name} of the graph step differs from the eager "
                "step's")
    ts = torch.cat([o[0][1] for o in got], dim=1).cpu().numpy()
    flat = sent.transpose(1, 0, 2, 3).reshape(n_mux, -1, 188)
    require(np.array_equal(ts[:, DELAY_PACKETS:], flat[:, :-DELAY_PACKETS]),
            "the graph step's TS differs from the packets sent")
    bad = torch.cat([o[1][1] for o in got], dim=1)[:, DELAY_PACKETS:]
    require(not bool(bad.any()), "the graph step has uncorrectable packets "
                                 "after warm-up")
    n_leaves = len(got[0]) - 2
    print(f"[bench] CUDA graph step captured in {t_capture:.2f} s (build, "
          f"2 eager warm-up steps, capture), launches in the capture "
          f"{graphed.captured}; {BENCH_STEPS} carried steps byte-identical "
          f"to the eager step (TS, rs_uncorrectable, {n_leaves} state "
          f"leaves), TS the packets sent; launches {launches}", flush=True)
    return dict(graphed.captured), launches


def main() -> None:
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print(card_line(), flush=True)

    import numpy as np

    sys.path.insert(0, str(ROOT))
    from dvbt_tpu_torch import (MODE_8K_UK, bench, coder_bench,
                                make_ts_packets, profile_slice)
    from dvbt_tpu_torch.mode import SYMBOLS_PER_FRAME, DvbtMode
    from dvbt_tpu_torch.kernels import _build
    from dvbt_tpu_torch.kernels import coder as kcoder
    from dvbt_tpu_torch.kernels import viterbi as kvit
    from dvbt_tpu_torch.models import flowgraph
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm
    from dvbt_tpu_torch.ops import inner_coder
    from dvbt_tpu_torch.ops import reference_signals as refs
    from dvbt_tpu_torch.ops import sync as syncop
    from dvbt_tpu_torch.ops import viterbi as vops
    from dvbt_tpu_torch.ops.outer_interleaver import DELAY_PACKETS
    from dvbt_tpu_torch.parallel import time_sharding as tsh
    from dvbt_tpu_torch.parallel.ring_bench import HIER_8K
    from dvbt_tpu_torch.utils import puncture
    from dvbt_tpu_torch.utils.cplx import cis
    from dvbt_tpu_torch.viterbi_bench import event_ms, main_path_inputs

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2024)
    mode = MODE_8K_UK
    rate = mode.code_rate
    flag_bytes = mode.packets_per_block * 4 * 204       # per mux, 4 frames
    flag_bits = flag_bytes * 8

    # --- 1. build --------------------------------------------------------
    t0 = time.time()
    so, log = _build.build()
    _build.library()
    print(f"[build] {so.name} in {time.time() - t0:.2f} s", flush=True)
    for line in log.splitlines():
        if "entry function" in line or "registers" in line:
            print(f"[build] {line.strip()}")

    # --- 2. K2 against its plain version and a numpy reference -----------
    # every case exact, over 2 blocks with the carried state6; each case's
    # largest |difference| goes into the kernels line
    def k2_blocks(n_mux, n_bytes, r, n_blocks=2) -> int:
        st_k = torch.as_tensor(rng.integers(0, 2, (n_mux, 6), dtype=np.uint8),
                               device=dev)
        st_p = st_k.clone()
        err = 0
        for blk in range(n_blocks):
            stream = torch.as_tensor(
                rng.integers(0, 256, (n_mux, n_bytes), dtype=np.uint8),
                device=dev)
            st_k, got = kcoder.byte_coder(st_k, stream, r)
            st_p, want = kcoder.byte_coder_plain(st_p, stream, r)
            err = max(err, int((got.int() - want.int()).abs().max()))
            require(torch.equal(got, want) and torch.equal(st_k, st_p),
                    f"K2 rate {r}, {n_mux} x {n_bytes} bytes, block {blk} "
                    "differs from its plain version")
        return err

    k2_cases = {}
    for r in RATES:     # each rate at its own 8K 64-QAM 4-frame byte count
        nb = DvbtMode("8k", "64qam", r, "1/32").packets_per_block * 4 * 204
        k2_cases[f"rate {r}, 3 x {nb} bytes"] = k2_blocks(3, nb, r)
    k2_cases[f"flagship rate, 1 and 8 x {flag_bytes} bytes"] = max(
        k2_blocks(m, flag_bytes, rate) for m in (1, 8))
    k2_cases["5 rates, 3 x 15960 bytes (rows not a multiple of 16 B)"] = max(
        k2_blocks(3, 3 * 5 * 7 * 8 * 19, r) for r in RATES)
    k2_cases["rate 2/3, 3 x 1001 bytes (a ragged unit, rows of output "
             "not 16-byte aligned)"] = k2_blocks(3, 1001, "2/3")
    frame_bytes = mode.packets_per_block * 204
    k2_cases[f"time-sharded step, 1 x {frame_bytes} bytes"] = k2_blocks(
        1, frame_bytes, rate)
    stream = torch.as_tensor(rng.integers(0, 256, (8, flag_bytes),
                                          dtype=np.uint8), device=dev)
    state0 = torch.zeros(8, 6, dtype=torch.uint8, device=dev)
    _, k2_out = kcoder.byte_coder(state0, stream, rate)
    ref = coder_bench.numpy_mother_code(
        np.unpackbits(stream[0].cpu().numpy()), rate)
    k2_cases["numpy mother-code reference, mux 0 of 8"] = int(np.abs(
        k2_out[0].cpu().numpy().astype(int) - ref.astype(int)).max())
    # the hierarchical configuration's two coders: 8K alpha=2, 4 frames,
    # HP rows at 2/3, LP rows at 3/4
    for part, r in (("hp", HIER_8K.code_rate), ("lp", HIER_8K.code_rate_lp)):
        nb = HIER_8K.stream_packets_per_block(part) * 4 * 204
        k2_cases[f"8K alpha=2 {part.upper()} rate {r}, 1 and 8 x {nb} "
                 "bytes"] = max(k2_blocks(m, nb, r) for m in (1, 8))
    # and the 2K alpha=2 BER point's, one block a call
    h2k = hier_2k()
    for part, r in (("hp", h2k.code_rate), ("lp", h2k.code_rate_lp)):
        nb = h2k.stream_packets_per_block(part) * 204
        k2_cases[f"2K alpha=2 {part.upper()} rate {r}, 1 and 8 x {nb} "
                 "bytes"] = max(k2_blocks(m, nb, r) for m in (1, 8))
    # the streaming receiver's tracked block: 1 mux x 8 frames
    tracked_bytes = mode.packets_per_block * TRACKED_FRAMES * 204
    k2_cases[f"tracked block, 1 x {tracked_bytes} bytes ({TRACKED_FRAMES} "
             "frames)"] = k2_blocks(1, tracked_bytes, rate)
    k2_err = max(k2_cases.values())
    require(k2_err == 0, f"K2 differs from its plain version or the numpy "
                         f"reference: {k2_cases}")
    print(f"[K2] exact in every case {k2_cases}", flush=True)

    # --- 3. K1 and K3 against their plain versions -----------------------
    # every case exact; each case's largest |difference| goes into the
    # kernels line
    gen = torch.Generator(device=dev).manual_seed(2025)
    zeros6 = torch.zeros(8, 6, dtype=torch.uint8, device=dev)

    def soft_coded(n_mux, n_bits, r, kind):
        """Coded soft values of random info bits: "hard" is 0/15 with 2%
        flipped (ties are common), "graded" the sent value 0/15 plus
        integer noise -9..9 clipped to 0..15 (every branch metric 0..30)."""
        info = torch.randint(0, 256, (n_mux, n_bits // 8), generator=gen,
                             dtype=torch.uint8, device=dev)
        _, bits = kcoder.byte_coder_plain(zeros6[:n_mux], info, r)
        soft = bits.int() * 15
        if kind == "hard":
            flips = torch.rand(soft.shape, generator=gen, device=dev) < 0.02
            soft = torch.where(flips, 15 - soft, soft)
        else:
            soft = soft + torch.randint(-9, 10, soft.shape, generator=gen,
                                        device=dev, dtype=torch.int32)
        return soft.clamp(0, 15).to(torch.uint8).contiguous()

    def k1_blocks(n_mux, n_bits, r, body, ov, kind, n_blocks=2) -> int:
        """Blocks of soft values through the decoder (K1) with its carried
        tail, each held against the plain version on the same inputs;
        output bytes and tail must be exact.  Returns the largest
        |difference|."""
        dec = vops.make_viterbi_decoder(n_bits, r, body, ov)
        depunct = inner_coder.make_depuncture(n_bits, r)
        st_k = vops.init_state(n_mux, ov, dev)
        tail_p = torch.zeros(n_mux, 4, ov, dtype=torch.uint8, device=dev)
        err = 0
        for blk in range(n_blocks):
            coded = soft_coded(n_mux, n_bits, r, kind)
            st_k, got = dec(st_k, coded)
            want = kvit.viterbi_punct_plain(coded, tail_p, n_bits, r, body)
            tail_p = torch.stack(depunct(coded), dim=-2)[..., -ov:]
            err = max(err, int((got.int() - want.int()).abs().max()))
            require(torch.equal(got, want), f"K1 {kind} rate {r} n_bits "
                    f"{n_bits} body {body} block {blk} differs from its "
                    "plain version")
            require(torch.equal(torch.stack([st_k[k] for k in
                                             ("x", "y", "xm", "ym")], -2),
                                tail_p), f"K1 rate {r} tail differs")
        return err

    k1_cases = {}
    for kind in ("hard", "graded"):
        k1_cases[f"{kind}, 5 rates, body 512"] = max(
            k1_blocks(2, 8 * puncture.pattern(r).period * 480 * 4, r,
                      *kvit.punct_geometry(r, 512, 96), kind) for r in RATES)
        # the receiver's own geometry at the flagship shape
        k1_cases[f"{kind}, flagship 8 muxes"] = k1_blocks(
            8, flag_bits, rate, vops.DEFAULT_BODY,
            vops.effective_overlap(rate), kind)
    ov78 = vops.effective_overlap("7/8")
    k1_cases["graded, n_bits 448 < body, 1 and 3 muxes"] = max(
        k1_blocks(m, 448, "7/8", vops.DEFAULT_BODY, ov78, "graded")
        for m in (1, 3))
    k1_cases["graded, ragged last window (5600 bits)"] = k1_blocks(
        1, 5600, "7/8", vops.DEFAULT_BODY, ov78, "graded")
    require(kvit.window_geometry(2, 12288, 4096, 128).spill,
            "K1 at body 4096 keeps its decisions in shared memory")
    k1_cases["graded, body 4096 (decisions spill), 2 muxes"] = k1_blocks(
        2, 12288, rate, 4096, 128, "graded")
    # the timed inputs: K1 at the flagship shape, K3 at the block path's
    vin = main_path_inputs(dev)
    require(vin.n_bits == flag_bits and vin.k3_body == kvit.auto_body(
        flag_bits), "the timed Viterbi inputs are not the main path's shape")
    # the hierarchical decoders: 8K alpha=2 (HP 2/3, LP 3/4) at one frame
    # (the dryrun's) and 4 frames (the hierarchical step's), and the 2K
    # alpha=2 BER point's (HP 1/2, LP 3/4, one block of 2 frames)
    for hmode, n_frames_k in ((HIER_8K, 1), (HIER_8K, 4), (h2k, 1)):
        for part in ("hp", "lp"):
            r = hmode.code_rate if part == "hp" else hmode.code_rate_lp
            nb = hmode.stream_packets_per_block(part) * n_frames_k * 204 * 8
            k1_cases[f"graded, {hmode.transmission.upper()} alpha=2 "
                     f"{part.upper()} rate {r}, {nb} bits, 1 and 8 muxes"] = \
                max(k1_blocks(m, nb, r, vops.DEFAULT_BODY,
                              vops.effective_overlap(r), "graded")
                    for m in (1, 8))
    for kind in ("hard", "graded"):
        k1_cases[f"{kind}, tracked block, 1 mux x {tracked_bytes * 8} bits "
                 f"({TRACKED_FRAMES} frames)"] = k1_blocks(
            1, tracked_bytes * 8, rate, vops.DEFAULT_BODY,
            vops.effective_overlap(rate), kind)
    rx_err, graded = k1_on_receiver_metrics(dev)
    k1_cases["the soft receiver's CSI-weighted metrics, 8K P1 20 dB, 2 "
             f"blocks ({graded:.1%} graded)"] = rx_err
    k1_out = vin.k1()
    k1_cases["noiseless, flagship 8 muxes"] = int(
        (k1_out.int() - vin.k1_plain().int()).abs().max())
    require(torch.equal(k1_out, vin.info),
            "K1 noiseless flagship decode wrong")
    k1_err = max(k1_cases.values())
    require(k1_err == 0, f"K1 differs from its plain version: {k1_cases}")
    print(f"[K1] exact against its plain version in every case "
          f"{k1_cases}; decodes 8 x {flag_bits} noiseless bits", flush=True)

    def k3_blocks(n_mux, n_bits, r, body, ov, kind, n_blocks=2) -> int:
        """Blocks of depunctured soft values through the viterbi_decoder
        block (K3) with its carried state, each held against the plain
        version on the same inputs and tail; bits and state must be exact.
        "hard"/"graded" as soft_coded (graded also puts noise where the
        mask says the bit was not sent); "erasure": random values, every
        mask 0, so every metric ties and the bits must all be 0; "random":
        random values and masks (any n_bits)."""
        dec = kvit.make_viterbi_decoder(n_bits, body, ov)
        st_k = kvit.init_state(n_mux, dev, ov)
        tail_p = torch.zeros(n_mux, 4, ov, dtype=torch.uint8, device=dev)
        err = 0
        for blk in range(n_blocks):
            if kind in ("hard", "graded"):
                steps = [s.contiguous() for s in inner_coder.make_depuncture(
                    n_bits, r)(soft_coded(n_mux, n_bits, r, kind))]
                if kind == "graded":     # 0 where not sent: add noise
                    for s, known in zip(steps[:2], steps[2:]):
                        s.add_(torch.randint(0, 16, s.shape, generator=gen,
                                             device=dev, dtype=torch.uint8)
                               * (1 - known))
            else:
                steps = [torch.randint(0, 16 if k < 2 else 2,
                                       (n_mux, n_bits), generator=gen,
                                       dtype=torch.uint8, device=dev)
                         for k in range(4)]
                if kind == "erasure":
                    steps[2].zero_()
                    steps[3].zero_()
            st_k, got = dec(st_k, *steps)
            want = kvit.viterbi_depunct_plain(*steps, tail_p, body)
            tail_p = torch.cat([tail_p, torch.stack(steps, dim=-2)],
                               dim=-1)[..., -ov:].contiguous()
            err = max(err, int((got.int() - want.int()).abs().max()))
            require(torch.equal(got, want), f"K3 {kind} n_bits {n_bits} "
                    f"body {body} block {blk} differs from its plain version")
            require(kind != "erasure" or not got.any(),
                    "K3 all-erasure block decoded a 1 bit")
            require(torch.equal(torch.stack([st_k[k] for k in
                                             ("x", "y", "xm", "ym")], -2),
                                tail_p), f"K3 {kind} state differs")
        return err

    k3_body = kvit.auto_body(flag_bits)
    k3_cases = {}
    for kind in ("hard", "graded"):
        k3_cases[f"{kind}, 5 rates, body 512"] = max(
            k3_blocks(2, 8 * puncture.pattern(r).period * 480 * 4, r, 512,
                      96, kind) for r in RATES)
        # at 8K, body 4096: 4352 steps a window, 17 renormalisations
        k3_cases[f"{kind}, flagship 8 muxes, body {k3_body}"] = k3_blocks(
            8, flag_bits, rate, k3_body, kvit.DEFAULT_OVERLAP, kind)
    k3_cases["all-erasure, 2 muxes"] = k3_blocks(
        2, 6144, rate, 512, 96, "erasure")
    k3_cases["random, n_bits 100 < body, 1 and 8 muxes"] = max(
        k3_blocks(m, 100, rate, 1024, 128, "random") for m in (1, 8))
    k3_cases["random, ragged last window (5000 bits)"] = k3_blocks(
        1, 5000, rate, 1024, 128, "random")
    # each stream's halo decode in the dryruns, at its own rate, body and
    # overlap (an LP halo need not hold whole bytes: then random values)
    for hmode in (mode, HIER_8K):
        for part, (n_info, r, body, ov) in tsh.halo_decode_shapes(
                hmode).items():
            k3_cases[f"time-sharded halo, {hmode.transmission.upper()} "
                     f"{hmode.constellation} alpha={hmode.alpha} "
                     f"{part.upper()} rate {r} "
                     f"({n_info} bits, body {body}, overlap {ov})"] = \
                k3_blocks(1, n_info, r, body, ov,
                          "graded" if n_info % 8 == 0 else "random")
    k3_out = vin.k3()
    k3_cases["noiseless, flagship 8 muxes"] = int(
        (k3_out.int() - vin.k3_plain().int()).abs().max())
    info_bits = torch.as_tensor(np.unpackbits(vin.info.cpu().numpy(),
                                              axis=-1), device=dev)
    require(torch.equal(k3_out, info_bits), "K3 noiseless decode wrong")
    k3_err = max(k3_cases.values())
    require(k3_err == 0, f"K3 differs from its plain version: {k3_cases}")
    print(f"[K3] exact against its plain version in every case "
          f"{k3_cases}; decodes 8 x {flag_bits} noiseless bits", flush=True)

    # --- 3b. the RS decoder against its plain version, and its time ------
    rs_cases, rs_times, rs_bound = rs_phase(card_line(), dev)
    enc_cases, enc_times, enc_bound = rs_encode_phase(card_line(), dev)
    demap_cases, demap_times, demap_bounds = demap_phase(card_line(), dev)
    acq_cases, acq_times, acq_bound = acquire_phase(card_line(), dev)

    # --- 4. transmitter against the golden 8K snapshot -------------------
    want = np.load(ROOT / "tests" / "golden" / "tx_8k_64qam_23.npz")
    tx1, n_pk1, _ = txm.make_transmitter(mode, dev, n_frames=1)
    pk = torch.as_tensor(make_ts_packets(n_pk1, seed=7), device=dev)[None]
    st = txm.init_tx_state(mode, 1, dev)
    st, iq = tx1(st, pk)
    _, iq2 = tx1(st, pk)
    L = mode.symbol_len
    iq, iq2 = iq[0].cpu().numpy(), iq2[0].cpu().numpy()
    err = max(np.abs(iq[:4 * L] - want["iq_head"]).max(),
              np.abs(iq2[:2 * L] - want["iq2_head"]).max())
    power = float(np.mean(np.abs(iq) ** 2))
    require(err <= 2e-5, f"TX differs from the golden snapshot: {err}")
    require(abs(power / float(want["power"]) - 1) <= 1e-3,
            f"TX power {power} vs golden {float(want['power'])}")
    print(f"[tx] 8K golden snapshot: max |diff| {err:.3e} (atol 2e-5), "
          f"power {power:.6f}", flush=True)

    # --- 5. the flagship slice: 8 muxes x 4 frames, TX -> RX --------------
    n_mux, n_frames, n_steps = 8, 4, 3
    tx, n_pk, n_samp = txm.make_transmitter(mode, dev, n_frames)
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames, metrics="min")
    sent = make_ts_packets(n_pk * n_mux * n_steps, seed=11).reshape(
        n_steps, n_mux, n_pk, 188)
    packets = torch.as_tensor(sent, device=dev)
    tst = txm.init_tx_state(mode, n_mux, dev)
    rst = rxm.init_rx_state(mode, n_mux, dev)
    torch.cuda.synchronize()
    before = _build.launches.copy()
    outs, bad, taus = [], [], []
    for s in range(n_steps):
        tst, iq = tx(tst, packets[s])
        rst, ts, met = rx(rst, iq)
        outs.append(ts.cpu().numpy())
        bad.append(met["rs_uncorrectable"].cpu().numpy())
        taus.append(met["timing_tau"].cpu().numpy())
    torch.cuda.synchronize()
    launches = _build.launches - before
    require(launches == {k: n_steps for k in bench.CAPTURED_LAUNCHES},
            f"the main path did not launch K1, K2 and the RS decoder and "
            f"encoder once a step: {launches}")
    out = np.concatenate(outs, axis=1)                    # (mux, pk, 188)
    flat_sent = sent.transpose(1, 0, 2, 3).reshape(n_mux, -1, 188)
    require(out.shape == flat_sent.shape, f"TS shape {out.shape}")
    for m in range(n_mux):
        require(np.array_equal(out[m, DELAY_PACKETS:],
                               flat_sent[m, :-DELAY_PACKETS]),
                f"mux {m}: decoded TS differs from the packets sent")
    n_bad = int(np.concatenate(bad, axis=1)[:, DELAY_PACKETS:].sum())
    require(n_bad == 0, f"{n_bad} uncorrectable packets after warm-up")
    tau = np.concatenate(taus, axis=1)
    require(np.isfinite(tau).all() and np.abs(tau).max() < 0.5,
            f"timing_tau off on a symbol-aligned stream: {np.abs(tau).max()}")
    print(f"[slice] {mode.transmission} {mode.constellation} {rate}: "
          f"{n_mux} muxes x {n_frames} frames x {n_steps} steps, TS "
          f"byte-exact after {DELAY_PACKETS} packets, rs_uncorrectable 0, "
          f"launches {launches}", flush=True)

    # --- 5b. the block path from raw captures: 8 muxes x 4 frames ---------
    # each mux: its own delay, CFO (integer + fractional subcarriers) and
    # carrier phase, then AWGN at 30 dB of its measured signal power
    delays = (2113, 3371, 4099, 1523, 2777, 3901, 1009, 4519)
    cfos = (2.3, -1.6, 0.7, -3.2, 1.4, -0.3, 4.1, -2.6)
    n_cap = syncop.min_capture_samples(mode, n_frames)
    frame_len = SYMBOLS_PER_FRAME * mode.symbol_len
    n_tx = -(-(max(delays) + n_cap) // n_samp)       # TX steps to cover
    blk_sent = make_ts_packets(n_pk * n_mux * n_tx, seed=12).reshape(
        n_tx, n_mux, n_pk, 188)
    tst = txm.init_tx_state(mode, n_mux, dev)
    chunks = []
    for s in range(n_tx):
        tst, iq = tx(tst, torch.as_tensor(blk_sent[s], device=dev))
        chunks.append(iq)
    tx_stream = torch.cat(chunks, dim=-1)
    imp_gen = torch.Generator(device=dev).manual_seed(2026)
    n_idx = torch.arange(n_cap, dtype=torch.float32, device=dev)
    capture = torch.stack([tx_stream[m, d:d + n_cap]
                           for m, d in enumerate(delays)])
    cfo_t = torch.tensor(cfos, dtype=torch.float32, device=dev)
    phase0 = torch.rand(n_mux, generator=imp_gen, device=dev) * 2 * np.pi
    capture = capture * cis(2 * np.pi * cfo_t[:, None] * n_idx / mode.fft_len
                            + phase0[:, None])
    p_sig = (capture.abs() ** 2).mean(-1, keepdim=True)
    noise = torch.randn(capture.shape, generator=imp_gen, device=dev,
                        dtype=torch.complex64)     # unit power
    capture = capture + noise * torch.sqrt(p_sig / 10 ** (30.0 / 10))
    blk_rx, blk_pk = flowgraph.make_block_receiver(mode, dev, n_cap, n_frames)
    blk_state = flowgraph.init_block_rx_state(mode, n_mux, dev)
    require(blk_pk == n_pk, f"block path packets {blk_pk} != {n_pk}")
    (_, blk_ts, blk_info), blk_launches = counted(
        lambda: blk_rx(blk_state, capture))
    require(blk_launches == {"viterbi_depunct": 1, "rs_decode": 1,
                             "acquire": 1},
            f"the block path did not launch K3, the RS decoder and the "
            f"acquisition once: {blk_launches}")
    inf = {k: v.cpu().numpy() for k, v in blk_info.items()}
    blk_ts = blk_ts.cpu().numpy()
    flat_blk = blk_sent.transpose(1, 0, 2, 3).reshape(n_mux, -1, 188)
    for m, (d, cfo) in enumerate(zip(delays, cfos)):
        require(int(inf["theta"][m]) == (-d) % mode.symbol_len,
                f"mux {m}: theta {inf['theta'][m]} for delay {d}")
        require(int(inf["cfo_int"][m]) == round(cfo),
                f"mux {m}: cfo_int {inf['cfo_int'][m]} for CFO {cfo}")
        require(abs(float(inf["cfo_frac"][m]) - (cfo - round(cfo))) < 0.01,
                f"mux {m}: cfo_frac {inf['cfo_frac'][m]} for CFO {cfo}")
        abs_start = d + int(inf["start"][m]) + syncop.DEFAULT_BACKOFF
        require(abs_start % frame_len == 0,
                f"mux {m}: start {inf['start'][m]} is not a frame start")
        k0 = abs_start // frame_len
        want = flat_blk[m, k0 * (n_pk // n_frames):][:n_pk - DELAY_PACKETS]
        require(np.array_equal(blk_ts[m, DELAY_PACKETS:], want),
                f"mux {m}: block-path TS differs from the packets sent")
        for f in range(n_frames):
            require(np.array_equal(inf["tps_bits"][m, f],
                                   refs.expected_tps_bits(mode, k0 + f)),
                    f"mux {m} frame {f}: TPS bits differ")
    n_bad = int(inf["rs_uncorrectable"][:, DELAY_PACKETS:].sum())
    require(n_bad == 0, f"block path: {n_bad} uncorrectable packets after "
                        "warm-up")
    print(f"[blocks] {n_mux} captures of {n_cap} samples, delays {delays}, "
          f"CFO {cfos} subcarriers, AWGN 30 dB: sync estimates match, TS "
          f"byte-exact from the detected frame after {DELAY_PACKETS} "
          f"packets, rs_uncorrectable 0, TPS bits exact, launches "
          f"{blk_launches}", flush=True)

    # --- 5c. the BER path, 5d. hierarchical, both at full width ----------
    card = card_line()
    ber_launches = ber_phase(card, dev)
    hier_launches = hierarchical_phase(card, dev)

    # --- 5e. the streaming receiver, its apps and a tracked block ---------
    stream_launches = streaming_phase(card, dev)

    # --- 6. timings ------------------------------------------------------
    for _ in range(2):
        tst, iq = tx(tst, packets[0])
        rst, ts, met = rx(rst, iq)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        tst, iq = tx(tst, packets[0])
        rst, ts, met = rx(rst, iq)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    msps = n_mux * n_samp / step_s / 1e6
    print(f"[time] slice TX+RX {n_mux} x {n_samp} samples: "
          f"{step_s * 1e3:.3f} ms/step, {msps:.3f} Msamples/s ({card})",
          flush=True)

    for _ in range(2):
        blk_rx(blk_state, capture)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        blk_rx(blk_state, capture)
    torch.cuda.synchronize()
    blk_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"[time] block path {n_mux} x {n_cap} samples: {blk_ms:.3f} ms per "
          f"capture ({card})", flush=True)

    # K2: the device's time by the profiler (events time the host here)
    k2_t = coder_bench.time_shape(8, flag_bytes, dev)
    k2_frame = coder_bench.time_shape(1, frame_bytes, dev)
    times = {"coder": (k2_t["ms"], k2_t["plain_ms"])}
    for key, t in (("8 muxes, flagship shape", k2_t),
                   ("1 mux x 1 frame, time-sharded shape", k2_frame)):
        runs = [(round(r["ms"], 6), round(r["events_ms"], 4))
                for r in t["runs"]]
        print(f"[time] coder at {key}: kernel {t['ms']:.6f} ms (each run by "
              f"the profiler, and by events the host's issue: {runs}), "
              f"plain {t['plain_ms']:.3f} ms ({card})", flush=True)
    for name, kern, plain, reps, preps in (("viterbi", vin.k1, vin.k1_plain,
                                            5, 1),
                                           ("viterbi_depunct", vin.k3,
                                            vin.k3_plain, 3, 1)):
        p1 = event_ms(plain, preps)
        a = event_ms(kern, reps)
        b = event_ms(kern, reps)
        p2 = event_ms(plain, preps)
        times[name] = ((a + b) / 2, (p1 + p2) / 2)
        print(f"[time] {name} at 8 muxes, flagship shape: kernel "
              f"{times[name][0]:.3f} ms, plain {times[name][1]:.3f} ms "
              f"({card})", flush=True)

    # the flagship step's device time per stage with each demap
    stages = {demap: profile_slice._slice(dev, card, demap)["stages"]
              for demap in ("hard", "soft")}
    print(f"[time] demap_deinterleave stage of the flagship step (8 muxes x "
          f"4 frames): hard {stages['hard']['demap_deinterleave']:.3f}, soft "
          f"{stages['soft']['demap_deinterleave']:.3f} device ms/step; "
          f"viterbi_decode (K1) hard {stages['hard']['viterbi_decode']:.3f}, "
          f"soft {stages['soft']['viterbi_decode']:.3f} ({card})", flush=True)

    # --- 7. parallel: 4 ranks on the card, K4 and the time-sharded path ---
    k4_entry, dryrun_launches = parallel_phase(card)

    # --- 8. the CUDA graph step the benchmark drives ----------------------
    per_replay, bench_launches = bench_phase(dev)

    # --- 9. the validation tools: the 25-mode grid and ber_hw's points -----
    # after every timing: with this phase before them, the profiler once
    # saw only 126 of K2's 200 launches in coder_bench
    valid_launches, k1_grid, k2_grid = validation_phase(card, dev)
    k1_cases.update(k1_grid)
    k2_cases.update(k2_grid)
    k1_err, k2_err = max(k1_cases.values()), max(k2_cases.values())

    imported = sorted(k for k in sys.modules
                      if k.split(".")[0] in ("jax", "jaxlib", "dvbt_tpu"))
    require(not imported, f"JAX or the JAX package was imported: {imported}")
    # bounds at the timed shapes: each input read and each output written
    # once; ACS operations for the Viterbi decoders; K2's taps as
    # bit-sliced int32 XORs (5 per coded bit, 32 bits a word)
    k1_shape = (8, flag_bits, vin.k1_body, vin.k1_tail.shape[-1])
    k3_shape = (8, flag_bits, vin.k3_body, vin.k3_tail.shape[-1])
    k1_bytes = vin.coded.numel() + k1_out.numel() + vin.k1_tail.numel()
    k1_ops = viterbi_ops(*k1_shape)
    k3_bytes = (sum(t.numel() for t in vin.k3_steps) + vin.k3_tail.numel()
                + k3_out.numel())
    k3_ops = viterbi_ops(*k3_shape)
    times["rs_decode"] = rs_times["noiseless"]
    times["rs_encode"] = enc_times
    times["demap"] = demap_times["UK hard"]
    times["acquire"] = acq_times
    bounds = {
        "rs_decode": rs_bound,
        "rs_encode": enc_bound,
        "demap": demap_bounds["UK hard"],
        "acquire": acq_bound,
        "viterbi": bound(k1_bytes, k1_ops, PACKED16_OPS_S),
        "coder": bound(stream.numel() + k2_out.numel() + state0.numel(),
                       k2_out.numel() * 5 / 32),
        "viterbi_depunct": bound(k3_bytes, k3_ops, PACKED16_OPS_S),
    }
    for key, n_bytes, n_ops, shape in (
            ("viterbi", k1_bytes, k1_ops, k1_shape),
            ("viterbi_depunct", k3_bytes, k3_ops, k3_shape)):
        print(f"[bound] {key}: {n_ops:.4g} ACS operations, "
              f"{bounds[key][0]:.4f} ms at the packed 16-bit rate; with a "
              f"separate compare and select (4 operations a state-step) at "
              f"the int32 rate "
              f"{bound(n_bytes, viterbi_ops(*shape, 4))[0]:.4f} ms",
              flush=True)

    # each kernel's launches on each path, every path counted alone
    by_path = {"slice": launches, "block_path": blk_launches,
               "ber": ber_launches, **hier_launches, **stream_launches,
               **valid_launches, **dryrun_launches, "bench": bench_launches}

    def entry(name, key, source, replaces, launches_, err, cases=None):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches_,
             "max_abs_err": err, "ms": times[key][0],
             "plain_ms": times[key][1], "bound_ms": bounds[key][0],
             "bound_by": bounds[key][1], "library_ms": None}
        if cases is not None:
            e["cases"] = cases      # max_abs_err of each parity case
        if name in per_replay:      # launches in one replay of the graph
            e["launches_per_graph_replay"] = per_replay[name]
        return e

    kernels = [
        entry("viterbi_punct", "viterbi", "dvbt_tpu_torch/csrc/viterbi.cu",
              "dvbt_tpu/kernels/viterbi_pallas.py:238",
              launches["viterbi_punct"],
              k1_err, k1_cases),
        entry("byte_coder", "coder", "dvbt_tpu_torch/csrc/coder.cu",
              "dvbt_tpu/kernels/coder_pallas.py:44", launches["byte_coder"],
              k2_err, k2_cases),
        entry("viterbi_depunct", "viterbi_depunct",
              "dvbt_tpu_torch/csrc/viterbi.cu",
              "dvbt_tpu/kernels/viterbi_pallas.py:71",
              blk_launches["viterbi_depunct"], k3_err, k3_cases),
        k4_entry,
        {**entry("rs_decode", "rs_decode", "dvbt_tpu_torch/csrc/rs.cu",
                 None, launches["rs_decode"], max(rs_cases.values()),
                 rs_cases),
         "ms_8_errors": rs_times["8 errors"][0],
         "plain_ms_8_errors": rs_times["8 errors"][1]},
        entry("rs_encode", "rs_encode", "dvbt_tpu_torch/csrc/rs.cu", None,
              launches["rs_encode"], max(enc_cases.values()), enc_cases),
        # ms and bound of the UK hard setup, every setup's beside them;
        # each case's largest |difference| and share of differing metrics
        {**entry("demap", "demap", "dvbt_tpu_torch/csrc/demap.cu", None,
                 launches["demap"],
                 max(c["max_abs_err"] for c in demap_cases.values()),
                 demap_cases),
         "ms_by_case": demap_times, "bound_ms_by_case": {
             k: b[0] for k, b in demap_bounds.items()}},
        # the largest |cfo_frac difference| of each case (theta equal)
        entry("acquire", "acquire", "dvbt_tpu_torch/csrc/acquire.cu", None,
              blk_launches["acquire"], max(acq_cases.values()), acq_cases),
    ]
    for k in kernels:
        k["launches_by_path"] = {path: c[k["name"]] for path, c in
                                 by_path.items() if c.get(k["name"])}
        print(f"[bound] {k['name']}: {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), kernel at {k['bound_ms'] / k['ms']:.1%} "
              f"of it ({card})", flush=True)
        require(k["bound_ms"] <= k["ms"],
                f"{k['name']} reads above its bound: {k}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
