"""Where the time goes, on one CUDA device.

    python3 -m dvbt_tpu_torch.profile_slice            # the flagship step
    python3 -m dvbt_tpu_torch.profile_slice --blocks   # the block path

The flagship slice: MODE_8K_UK, 8 muxes x 4 frames per step, TX then
symbol-aligned RX.  With ``--blocks``, the block-level receive path
(models/flowgraph.py) at the same mode and size: 8 raw captures (the
transmitter's stream with a per-mux delay and CFO) from the synchronizer
to the descrambler.  Prints:

- host-clock ms per step, unprofiled (TX, RX and TX+RX for the slice; one
  pass over the captures for the block path), and the peak device memory
  of one step;
- from ONE torch.profiler trace of 5 steps: device ms per step inside each
  stage's profiler range, the device busy time (union of kernel, memcpy
  and memset intervals), the wall time of the profiled steps, the idle
  share 1 - busy / wall, and the number of device operations.  The
  profiler slows the host, so the traced idle share is an upper bound for
  an unprofiled step.

The Chrome trace is kept at ``build/dvbt_tpu_torch/slice_trace.json``
(``blocks_trace.json`` for the block path) beside the package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import MODE_8K_UK, make_ts_packets
from .kernels import _build
from .models import flowgraph
from .models import rx as rxm
from .models import tx as txm
from .ops import sync as syncop
from .utils.cplx import cis

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILED_STEPS = 5


def _host_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _union_us(spans) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def _profile(step, card: str, trace_path) -> None:
    """One torch.profiler trace of PROFILED_STEPS calls of step(): device
    busy time, idle share and device ms per profiler range."""
    n = PROFILED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    trace = json.loads(trace_path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev_spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS]
    if not dev_spans:
        raise SystemExit("profile_slice: the trace holds no device time")
    busy_us = _union_us(dev_spans)
    per_stage: dict[str, float] = {}
    for e in events:
        if e.get("cat") != "gpu_user_annotation":
            continue
        s, t = e["ts"], e["ts"] + e["dur"]
        inside = _union_us([(max(s, a), min(t, b)) for a, b in dev_spans
                            if a < t and b > s])
        per_stage[e["name"]] = per_stage.get(e["name"], 0.0) + inside
    total = sum(per_stage.values()) or 1.0
    print(f"profiled {n} steps, one trace ({card}): device busy "
          f"{busy_us / 1e3 / n:.3f} ms/step, wall {wall_us / 1e3 / n:.3f} "
          f"ms/step, idle share {1 - busy_us / wall_us:.4f}, "
          f"{len(dev_spans)} device operations")
    for name, us in sorted(per_stage.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {us / 1e3 / n:9.3f} ms/step "
              f"{us / total * 100:5.1f}%")


def _peak_mb(step) -> float:
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e6


def _slice(dev, card: str) -> None:
    mode, n_mux, n_frames = MODE_8K_UK, 8, 4
    tx, n_pk, n_samp = txm.make_transmitter(mode, dev, n_frames)
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames, metrics="min")
    pk = torch.as_tensor(make_ts_packets(n_pk * n_mux, seed=1).reshape(
        n_mux, n_pk, 188), device=dev)
    st = {"tx": txm.init_tx_state(mode, n_mux, dev),
          "rx": rxm.init_rx_state(mode, n_mux, dev)}

    def step_tx():
        st["tx"], st["iq"] = tx(st["tx"], pk)

    def step_rx():
        st["rx"], _, _ = rx(st["rx"], st["iq"])

    def step():
        step_tx()
        step_rx()

    for _ in range(3):
        step()
    ms = {"tx": _host_ms(step_tx, 10), "rx": _host_ms(step_rx, 10),
          "tx+rx": _host_ms(step, 10)}
    print(f"unprofiled ms/step: TX {ms['tx']:.3f}, RX {ms['rx']:.3f}, "
          f"TX+RX {ms['tx+rx']:.3f} ({n_mux} x {n_samp} samples); peak "
          f"device memory {_peak_mb(step):.1f} MB ({card})")
    _profile(step, card, _build.BUILD_DIR / "slice_trace.json")


def _blocks(dev, card: str) -> None:
    mode, n_mux, n_frames = MODE_8K_UK, 8, 4
    tx, n_pk, n_samp = txm.make_transmitter(mode, dev, n_frames)
    n_cap = syncop.min_capture_samples(mode, n_frames)
    delays = 1000 + 431 * torch.arange(n_mux, device=dev)
    cfo = torch.linspace(-3.3, 3.7, n_mux, device=dev)
    n_tx = -(-(int(delays.max()) + n_cap) // n_samp)
    tst = txm.init_tx_state(mode, n_mux, dev)
    chunks = []
    for s in range(n_tx):
        tst, iq = tx(tst, torch.as_tensor(make_ts_packets(
            n_pk * n_mux, seed=2 + s).reshape(n_mux, n_pk, 188), device=dev))
        chunks.append(iq)
    stream = torch.cat(chunks, dim=-1)
    n = torch.arange(n_cap, device=dev)
    capture = torch.gather(stream, -1, delays[:, None] + n) * cis(
        2 * np.pi * cfo[:, None] * n.to(torch.float32) / mode.fft_len)
    rx, _ = flowgraph.make_block_receiver(mode, dev, n_cap, n_frames)
    state = flowgraph.init_block_rx_state(mode, n_mux, dev)

    def step():
        rx(state, capture)

    for _ in range(3):
        step()
    print(f"unprofiled ms per capture: {_host_ms(step, 10):.3f} ({n_mux} x "
          f"{n_cap} samples); peak device memory {_peak_mb(step):.1f} MB "
          f"({card})")
    _profile(step, card, _build.BUILD_DIR / "blocks_trace.json")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--blocks"]):
        raise SystemExit("usage: python3 -m dvbt_tpu_torch.profile_slice "
                         "[--blocks]")
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    (_blocks if argv else _slice)(dev, card)


if __name__ == "__main__":
    main()
