#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dvbt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dvbt_tpu_torch/csrc, checks each against its
plain PyTorch version on the card (K1 and K3, the Viterbi decoders, and K2,
the inner coder), checks the 8K transmitter against the golden snapshot,
then drives the flagship slice (MODE_8K_UK: 8K, 64-QAM, rate 2/3, GI 1/32;
8 muxes x 4 frames per step) TX -> RX and checks that every mux returns
its transport stream byte-exact.  Then it drives the block-level receive
path: 8 raw captures, each with its own delay, CFO and AWGN at 30 dB,
through the registry's blocks from the synchronizer to the descrambler
(K3 decodes), and checks each mux's sync estimates against the
impairments, its TS byte-exact from the detected frame on, and its TPS
bits.  Ends with timings.
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
OPS_PER_STATE_STEP = 4   # Viterbi ACS: two adds, a compare, a select


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, what sets it): each input read and
    each output written once over HBM, or the operations at the int32
    peak, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / INT32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def viterbi_ops(n_mux: int, n_bits: int, body: int, ov: int) -> float:
    """ACS operations of the overlapped-window decode: windows x steps x
    64 states x OPS_PER_STATE_STEP."""
    n_win = -(-n_bits // body)
    return float(n_mux * n_win * (body + 2 * ov) * 64 * OPS_PER_STATE_STEP)


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


def main() -> None:
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    print(card_line(), flush=True)

    import numpy as np

    sys.path.insert(0, str(ROOT))
    from dvbt_tpu_torch import MODE_8K_UK, make_ts_packets
    from dvbt_tpu_torch.mode import SYMBOLS_PER_FRAME
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
    for r in RATES:
        n_bytes = 3 * 5 * 7 * 8 * 19
        st_k = torch.as_tensor(rng.integers(0, 2, (3, 6), dtype=np.uint8),
                               device=dev)
        st_p = st_k.clone()
        for blk in range(2):
            stream = torch.as_tensor(
                rng.integers(0, 256, (3, n_bytes), dtype=np.uint8),
                device=dev)
            st_k, got = kcoder.byte_coder(st_k, stream, r)
            st_p, want = kcoder.byte_coder_plain(st_p, stream, r)
            require(torch.equal(got, want) and torch.equal(st_k, st_p),
                    f"K2 rate {r} block {blk} differs from its plain version")
    stream = torch.as_tensor(rng.integers(0, 256, (8, flag_bytes),
                                          dtype=np.uint8), device=dev)
    state0 = torch.zeros(8, 6, dtype=torch.uint8, device=dev)
    _, k2_out = kcoder.byte_coder(state0, stream, rate)
    _, k2_plain = kcoder.byte_coder_plain(state0, stream, rate)
    k2_err = int((k2_out.int() - k2_plain.int()).abs().max())
    require(k2_err == 0, "K2 differs from its plain version at 8 x "
                         f"{flag_bytes} bytes")
    ref = numpy_mother_code(np.unpackbits(stream[0].cpu().numpy()), rate,
                            puncture.pattern(rate).order,
                            puncture.pattern(rate).period)
    require(np.array_equal(k2_out[0].cpu().numpy(), ref),
            "K2 differs from the numpy mother-code reference")
    print(f"[K2] exact at all 5 rates over 2 blocks, and at 8 x {flag_bytes}"
          " bytes (plain + numpy reference)", flush=True)

    # --- 3. K1 against its plain version ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(2025)
    zeros6 = torch.zeros(8, 6, dtype=torch.uint8, device=dev)

    def k1_two_noisy_blocks(n_mux, n_bits, r, body, ov) -> int:
        """Two blocks of hard soft values (0/15, 2% flipped, so ties are
        common) through the decoder (K1) with its carried tail, each held
        against the plain version on the same inputs; output bytes and
        tail must be exact.  Returns the largest |difference|."""
        dec = vops.make_viterbi_decoder(n_bits, r, body, ov)
        depunct = inner_coder.make_depuncture(n_bits, r)
        st_k = vops.init_state(n_mux, ov, dev)
        tail_p = torch.zeros(n_mux, 4, ov, dtype=torch.uint8, device=dev)
        err = 0
        for blk in range(2):
            info = torch.randint(0, 256, (n_mux, n_bits // 8), generator=gen,
                                 dtype=torch.uint8, device=dev)
            _, soft = kcoder.byte_coder_plain(zeros6[:n_mux], info, r)
            soft = soft * 15
            flips = torch.rand(soft.shape, generator=gen, device=dev) < 0.02
            coded = torch.where(flips, 15 - soft, soft).contiguous()
            st_k, got = dec(st_k, coded)
            want = kvit.viterbi_punct_plain(coded, tail_p, n_bits, r, body)
            tail_p = torch.stack(depunct(coded), dim=-2)[..., -ov:]
            err = max(err, int((got.int() - want.int()).abs().max()))
            require(torch.equal(got, want), f"K1 rate {r} body {body} "
                    f"block {blk} differs from its plain version")
            require(torch.equal(torch.stack([st_k[k] for k in
                                             ("x", "y", "xm", "ym")], -2),
                                tail_p), f"K1 rate {r} tail differs")
        return err

    for r in RATES:
        n_bits = 8 * puncture.pattern(r).period * 480 * 4
        k1_two_noisy_blocks(2, n_bits, r, *kvit.punct_geometry(r, 512, 96))
    # the receiver's own geometry at the flagship shape
    k1_err = k1_two_noisy_blocks(8, flag_bits, rate, vops.DEFAULT_BODY,
                                 vops.effective_overlap(rate))
    info = torch.as_tensor(rng.integers(0, 256, (8, flag_bytes),
                                        dtype=np.uint8), device=dev)
    _, coded = kcoder.byte_coder(state0, info, rate)
    coded = (coded * 15).contiguous()
    ov = vops.effective_overlap(rate)
    tail0 = torch.zeros(8, 4, ov, dtype=torch.uint8, device=dev)
    k1_out = kvit.viterbi_punct(coded, tail0, flag_bits, rate,
                                vops.DEFAULT_BODY)
    k1_plain = kvit.viterbi_punct_plain(coded, tail0, flag_bits, rate,
                                        vops.DEFAULT_BODY)
    k1_err = max(k1_err, int((k1_out.int() - k1_plain.int()).abs().max()))
    require(k1_err == 0, "K1 differs from its plain version at the "
                         "flagship shape")
    require(torch.equal(k1_out, info), "K1 noiseless flagship decode wrong")
    print(f"[K1] exact at all 5 rates over 2 noisy blocks, and over 2 noisy "
          f"blocks of 8 x {flag_bits} bits at body {vops.DEFAULT_BODY}; "
          f"decodes 8 x {flag_bits} noiseless bits", flush=True)

    # --- 3b. K3 against its plain version --------------------------------
    def k3_two_noisy_blocks(n_mux, n_bits, r, body, ov) -> int:
        """Two blocks of depunctured hard soft values (0/15, 2% of the sent
        bits flipped) through the viterbi_decoder block (K3) with its
        carried state, each held against the plain version on the same
        inputs and tail; bits and state must be exact."""
        dec = kvit.make_viterbi_decoder(n_bits, body, ov)
        depunct = inner_coder.make_depuncture(n_bits, r)
        st_k = kvit.init_state(n_mux, dev, ov)
        tail_p = torch.zeros(n_mux, 4, ov, dtype=torch.uint8, device=dev)
        err = 0
        for blk in range(2):
            info = torch.randint(0, 256, (n_mux, n_bits // 8), generator=gen,
                                 dtype=torch.uint8, device=dev)
            _, soft = kcoder.byte_coder_plain(zeros6[:n_mux], info, r)
            soft = soft * 15
            flips = torch.rand(soft.shape, generator=gen, device=dev) < 0.02
            coded = torch.where(flips, 15 - soft, soft)
            steps = [s.contiguous() for s in depunct(coded)]
            st_k, got = dec(st_k, *steps)
            want = kvit.viterbi_depunct_plain(*steps, tail_p, body)
            tail_p = torch.stack(steps, dim=-2)[..., -ov:].contiguous()
            err = max(err, int((got.int() - want.int()).abs().max()))
            require(torch.equal(got, want), f"K3 rate {r} body {body} "
                    f"block {blk} differs from its plain version")
            require(torch.equal(torch.stack([st_k[k] for k in
                                             ("x", "y", "xm", "ym")], -2),
                                tail_p), f"K3 rate {r} state differs")
        return err

    for r in RATES:
        n_bits = 8 * puncture.pattern(r).period * 480 * 4
        k3_two_noisy_blocks(2, n_bits, r, 512, 96)
    k3_body = kvit.auto_body(flag_bits)
    k3_err = k3_two_noisy_blocks(8, flag_bits, rate, k3_body,
                                 kvit.DEFAULT_OVERLAP)
    info_bits = torch.as_tensor(rng.integers(0, 2, (8, flag_bits),
                                             dtype=np.uint8), device=dev)
    _, k3_coded = kcoder.byte_coder(state0, torch.as_tensor(
        np.packbits(info_bits.cpu().numpy(), axis=-1), device=dev), rate)
    k3_steps = [s.contiguous() for s in
                inner_coder.make_depuncture(flag_bits, rate)(k3_coded * 15)]
    k3_tail = torch.zeros(8, 4, kvit.DEFAULT_OVERLAP, dtype=torch.uint8,
                          device=dev)
    k3_out = kvit.viterbi_depunct(*k3_steps, k3_tail, k3_body)
    k3_plain = kvit.viterbi_depunct_plain(*k3_steps, k3_tail, k3_body)
    k3_err = max(k3_err, int((k3_out.int() - k3_plain.int()).abs().max()))
    require(k3_err == 0, "K3 differs from its plain version at the "
                         "flagship block shape")
    require(torch.equal(k3_out, info_bits), "K3 noiseless decode wrong")
    print(f"[K3] exact at all 5 rates over 2 noisy blocks (body 512, overlap"
          f" 96), and over 2 noisy blocks of 8 x {flag_bits} bits at body "
          f"{k3_body}, overlap {kvit.DEFAULT_OVERLAP}; decodes 8 x "
          f"{flag_bits} noiseless bits", flush=True)

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

    def k2():
        kcoder.byte_coder(state0, stream, rate)

    def k2_plain():
        kcoder.byte_coder_plain(state0, stream, rate)

    def k1():
        kvit.viterbi_punct(coded, tail0, flag_bits, rate, vops.DEFAULT_BODY)

    def k1_plain():
        kvit.viterbi_punct_plain(coded, tail0, flag_bits, rate,
                                 vops.DEFAULT_BODY)

    def k3():
        kvit.viterbi_depunct(*k3_steps, k3_tail, k3_body)

    def k3_plain():
        kvit.viterbi_depunct_plain(*k3_steps, k3_tail, k3_body)

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

    times = {}
    for name, kern, plain, reps, preps in (("coder", k2, k2_plain, 20, 5),
                                           ("viterbi", k1, k1_plain, 5, 1),
                                           ("viterbi_depunct", k3, k3_plain,
                                            3, 1)):
        p1 = event_ms(plain, preps)
        a = event_ms(kern, reps)
        b = event_ms(kern, reps)
        p2 = event_ms(plain, preps)
        times[name] = ((a + b) / 2, (p1 + p2) / 2)
        print(f"[time] {name} at 8 muxes, flagship shape: kernel "
              f"{times[name][0]:.3f} ms, plain {times[name][1]:.3f} ms "
              f"({card})", flush=True)

    imported = sorted(k for k in sys.modules
                      if k.split(".")[0] in ("jax", "jaxlib", "dvbt_tpu"))
    require(not imported, f"JAX or the JAX package was imported: {imported}")
    # bounds at the timed shapes: each input read and each output written
    # once; ACS operations for the Viterbi decoders; K2's taps as
    # bit-sliced int32 XORs (5 per coded bit, 32 bits a word)
    n_c = coded.numel()
    bounds = {
        "viterbi": bound(n_c + k1_out.numel() + tail0.numel(),
                         viterbi_ops(8, flag_bits, vops.DEFAULT_BODY, ov)),
        "coder": bound(stream.numel() + k2_out.numel() + state0.numel(),
                       k2_out.numel() * 5 / 32),
        "viterbi_depunct": bound(
            sum(t.numel() for t in k3_steps) + k3_tail.numel()
            + k3_out.numel(),
            viterbi_ops(8, flag_bits, k3_body, kvit.DEFAULT_OVERLAP)),
    }

    def entry(name, key, source, replaces, launches_, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": times[key][0],
                "plain_ms": times[key][1], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": None}

    kernels = [
        entry("viterbi_punct", "viterbi", "dvbt_tpu_torch/csrc/viterbi.cu",
              "dvbt_tpu/kernels/viterbi_pallas.py:238", launches["viterbi"],
              k1_err),
        entry("byte_coder", "coder", "dvbt_tpu_torch/csrc/coder.cu",
              "dvbt_tpu/kernels/coder_pallas.py:44", launches["coder"],
              k2_err),
        entry("viterbi_depunct", "viterbi_depunct",
              "dvbt_tpu_torch/csrc/viterbi.cu",
              "dvbt_tpu/kernels/viterbi_pallas.py:71",
              blk_launches["viterbi_depunct"], k3_err),
    ]
    for k in kernels:
        print(f"[bound] {k['name']}: {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), kernel at {k['bound_ms'] / k['ms']:.1%} "
              f"of it ({card})", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
