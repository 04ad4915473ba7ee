#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dvbt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dvbt_tpu_torch/csrc, checks each against its
plain PyTorch version on the card, checks the 8K transmitter against the
golden snapshot, then drives the flagship slice (MODE_8K_UK: 8K, 64-QAM,
rate 2/3, GI 1/32; 8 muxes x 4 frames per step) TX -> RX and checks that
every mux returns its transport stream byte-exact.  Ends with timings.
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
    from dvbt_tpu_torch.kernels import _build
    from dvbt_tpu_torch.kernels import coder as kcoder
    from dvbt_tpu_torch.kernels import viterbi as kvit
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm
    from dvbt_tpu_torch.ops import inner_coder
    from dvbt_tpu_torch.ops import viterbi as vops
    from dvbt_tpu_torch.utils import puncture

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
        if "registers" in line or "spill" in line:
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
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames)
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

    times = {}
    for name, kern, plain, reps, preps in (("coder", k2, k2_plain, 20, 5),
                                           ("viterbi", k1, k1_plain, 5, 1)):
        p1 = event_ms(plain, preps)
        a = event_ms(kern, reps)
        b = event_ms(kern, reps)
        p2 = event_ms(plain, preps)
        times[name] = ((a + b) / 2, (p1 + p2) / 2)
        print(f"[time] {name} at 8 muxes, flagship shape: kernel "
              f"{times[name][0]:.3f} ms, plain {times[name][1]:.3f} ms "
              f"({card})", flush=True)

    require("jax" not in sys.modules, "JAX was imported")
    kernels = [
        {"name": "viterbi_punct", "route": "cuda",
         "source": "dvbt_tpu_torch/csrc/viterbi.cu",
         "replaces": "dvbt_tpu/kernels/viterbi_pallas.py:238",
         "launches": launches["viterbi"], "max_abs_err": k1_err,
         "ms": times["viterbi"][0], "plain_ms": times["viterbi"][1]},
        {"name": "byte_coder", "route": "cuda",
         "source": "dvbt_tpu_torch/csrc/coder.cu",
         "replaces": "dvbt_tpu/kernels/coder_pallas.py:44",
         "launches": launches["coder"], "max_abs_err": k2_err,
         "ms": times["coder"][0], "plain_ms": times["coder"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
