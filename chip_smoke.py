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
with the carried state, and a numpy reference of the mother code), checks
the 8K transmitter against the golden snapshot, then drives the flagship
slice (MODE_8K_UK: 8K, 64-QAM, rate 2/3, GI 1/32; 8 muxes x 4 frames per
step) TX -> RX and checks that every mux returns
its transport stream byte-exact.  Then it drives the block-level receive
path: 8 raw captures, each with its own delay, CFO and AWGN at 30 dB,
through the registry's blocks from the synchronizer to the descrambler
(K3 decodes), and checks each mux's sync estimates against the
impairments, its TS byte-exact from the detected frame on, and its TPS
bits.  Then timings, and the parallel package: 4 rank processes on the one
card (spawned, gloo between them) check K4, the halo ring over CUDA IPC,
against its plain send/recv version and that lone calls time out and
raise (one whose caller synchronises the stream first), on each of K4's
two routes (waits in stream order, the one-card choice; one kernel that
waits on the SMs, the choice with a card per rank), run the dryrun at
MODE_8K_UK (mux-DP over 4 x 2 muxes; the time-sharded loopback over 8
one-frame blocks, equal to the single-process streaming chain; the K4 halo
path equal to the send/recv one), and time K4 and the sharded step with
either halo.
Every phase raises on failure (nonzero exit).  The last line is one JSON
object {"ok": true, "device": {...}}; the line before it is the card's
name and power limit from nvidia-smi, and before that a JSON line with
each kernel's launches on the main path, error and times.

Needs a CUDA device: without one it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DELAY_PACKETS = 11   # outer interleaver + deinterleaver: 2244 bytes
RATES = ("1/2", "2/3", "3/4", "5/6", "7/8")
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


def numpy_mother_code(bits, rate: str, order, period: int):
    """Independent reference: x/y by convolution with G1=171o, G2=133o
    taps over b[n..n-6] from a zero state, then Table-3 puncturing."""
    import numpy as np
    n = len(bits)
    g1 = np.array([1, 1, 1, 1, 0, 0, 1], np.uint8)
    g2 = np.array([1, 0, 1, 1, 0, 1, 1], np.uint8)
    x = np.convolve(bits, g1)[:n] % 2
    y = np.convolve(bits, g2)[:n] % 2
    pairs = np.stack([x, y], axis=1).reshape(n // period, 2 * period)
    return pairs[:, np.asarray(order)].reshape(-1).astype(np.uint8)


def parallel_phase(card: str) -> dict:
    """Phase 7: 4 ranks on the one card (ring_bench.rank_main: K4 against
    its plain version and lone calls that must time out, on both routes,
    the dryrun at the flagship mode, K4 and step timings); returns K4's
    entry of the kernels line."""
    import os

    from dvbt_tpu_torch.kernels import _build
    from dvbt_tpu_torch.parallel import multihost, ring_bench

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
    iq = res["times"]["iq"]
    t_bound, by = bound(2 * iq["bytes"], 0)
    return {"name": "ring_shift", "route": "cuda",
            "source": "dvbt_tpu_torch/csrc/ring.cu",
            "replaces": "dvbt_tpu/parallel/ring.py:30",
            "launches": res["launches"]["ring_shift"],
            "max_abs_err": res["k4_err"], "ms": iq["k4"],
            "plain_ms": iq["plain"], "bound_ms": t_bound,
            "bound_by": by, "library_ms": None}


def main() -> None:
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print(card_line(), flush=True)

    import numpy as np

    sys.path.insert(0, str(ROOT))
    from dvbt_tpu_torch import MODE_8K_UK, coder_bench, make_ts_packets
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
    ref = numpy_mother_code(np.unpackbits(stream[0].cpu().numpy()), rate,
                            puncture.pattern(rate).order,
                            puncture.pattern(rate).period)
    k2_cases["numpy mother-code reference, mux 0 of 8"] = int(np.abs(
        k2_out[0].cpu().numpy().astype(int) - ref.astype(int)).max())
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
    k3_cases["graded, time-sharded halo (24192 bits, body 1024)"] = \
        k3_blocks(1, 24192, rate, 1024, kvit.DEFAULT_OVERLAP, "graded")
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
    kcoder.launches = 0
    kvit.launches = 0
    outs, bad, taus = [], [], []
    for s in range(n_steps):
        tst, iq = tx(tst, packets[s])
        rst, ts, met = rx(rst, iq)
        outs.append(ts.cpu().numpy())
        bad.append(met["rs_uncorrectable"].cpu().numpy())
        taus.append(met["timing_tau"].cpu().numpy())
    torch.cuda.synchronize()
    launches = {"coder": kcoder.launches, "viterbi": kvit.launches}
    require(launches["coder"] > 0 and launches["viterbi"] > 0,
            f"the main path did not launch both kernels: {launches}")
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
    torch.cuda.synchronize()
    kvit.depunct_launches = 0
    _, blk_ts, blk_info = blk_rx(blk_state, capture)
    torch.cuda.synchronize()
    blk_launches = {"viterbi_depunct": kvit.depunct_launches}
    require(blk_launches["viterbi_depunct"] > 0,
            f"the block path did not launch K3: {blk_launches}")
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

    # --- 6. timings ------------------------------------------------------
    card = card_line()
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

    # --- 7. parallel: 4 ranks on the card, K4 and the time-sharded path ---
    k4_entry = parallel_phase(card)

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
    bounds = {
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

    def entry(name, key, source, replaces, launches_, err, cases=None):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches_,
             "max_abs_err": err, "ms": times[key][0],
             "plain_ms": times[key][1], "bound_ms": bounds[key][0],
             "bound_by": bounds[key][1], "library_ms": None}
        if cases is not None:
            e["cases"] = cases      # max_abs_err of each parity case
        return e

    kernels = [
        entry("viterbi_punct", "viterbi", "dvbt_tpu_torch/csrc/viterbi.cu",
              "dvbt_tpu/kernels/viterbi_pallas.py:238", launches["viterbi"],
              k1_err, k1_cases),
        entry("byte_coder", "coder", "dvbt_tpu_torch/csrc/coder.cu",
              "dvbt_tpu/kernels/coder_pallas.py:44", launches["coder"],
              k2_err, k2_cases),
        entry("viterbi_depunct", "viterbi_depunct",
              "dvbt_tpu_torch/csrc/viterbi.cu",
              "dvbt_tpu/kernels/viterbi_pallas.py:71",
              blk_launches["viterbi_depunct"], k3_err, k3_cases),
        k4_entry,
    ]
    for k in kernels:
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
