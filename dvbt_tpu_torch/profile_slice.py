"""Where the time goes, on one CUDA device.

    python3 -m dvbt_tpu_torch.profile_slice            # the flagship step
    python3 -m dvbt_tpu_torch.profile_slice --demap soft   # its soft RX
    python3 -m dvbt_tpu_torch.profile_slice --hier     # hierarchical
    python3 -m dvbt_tpu_torch.profile_slice --blocks   # the block path
    python3 -m dvbt_tpu_torch.profile_slice --stream   # tracked blocks

The flagship slice: MODE_8K_UK, 8 muxes x 4 frames per step, TX then
symbol-aligned RX, whose demap is hard unless ``--demap soft`` asks for
the CSI-weighted soft metrics.  With ``--hier``, the same step at the
hierarchical configuration (parallel/ring_bench.HIER_8K: 8K 64-QAM
alpha=2, HP 2/3 + LP 3/4).  With ``--blocks``, the block-level receive path
(models/flowgraph.py) at the same mode and size: 8 raw captures (the
transmitter's stream with a per-mux delay and CFO) from the synchronizer
to the descrambler.  With ``--stream``, the bench's tracked variant: one
mux of MODE_8K_UK, 8 frames a block, at a carrier offset of 0.31
subcarrier, fed block by block to a locked StreamingReceiver
(``pipeline=4``, ``metrics="min"``), ring, host copies and all.  Prints:

- host-clock ms per step, unprofiled (TX, RX and TX+RX for the slice; one
  pass over the captures for the block path; one block fed, for the
  stream), and the peak device memory of one step;
- from ONE torch.profiler trace of 5 steps: device ms per step inside each
  stage's profiler range, the device busy time (union of kernel, memcpy
  and memset intervals), the wall time of the profiled steps, the idle
  share 1 - busy / wall, and the number of device operations.  The
  profiler slows the host, so the traced idle share is an upper bound for
  an unprofiled step.

The Chrome trace is kept at ``build/dvbt_tpu_torch/slice_trace.json``
(``blocks_trace.json`` for the block path, ``stream_trace.json`` for the
stream) beside the package.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import MODE_8K_UK, bench, make_ts_packets
from .utils.streams import join, split
from .kernels import _build
from .models import flowgraph
from .models import loopback
from .models import rx as rxm
from .models import tx as txm
from .ops import sync as syncop
from .parallel.ring_bench import HIER_8K
from .utils.cplx import cis
from .apps.device import card as device_card

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


def _profile(step, card: str, trace_path) -> dict:
    """One torch.profiler trace of PROFILED_STEPS calls of step(); returns
    per call the device busy ms (``busy``), the wall ms (``wall``), the
    idle share (``idle``) and the device ms inside each profiler range
    (``stages``)."""
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
          f"{len(dev_spans)} device operations", flush=True)
    for name, us in sorted(per_stage.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {us / 1e3 / n:9.3f} ms/step "
              f"{us / total * 100:5.1f}% ({card})", flush=True)
    return {"busy": busy_us / 1e3 / n, "wall": wall_us / 1e3 / n,
            "idle": 1 - busy_us / wall_us,
            "stages": {name: us / 1e3 / n for name, us in per_stage.items()}}


def _peak_mb(step) -> float:
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e6


def _slice(dev, card: str, demap: str = "hard", hier: bool = False) -> dict:
    """Profiles the flagship step (with ``hier`` its hierarchical
    configuration) with the receiver's ``demap``; returns _profile's
    reading."""
    mode, n_mux, n_frames = (HIER_8K if hier else MODE_8K_UK), 8, 4
    tx, n_pk, n_samp = txm.make_transmitter(mode, dev, n_frames)
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames, metrics="min",
                                 demap=demap)
    pk = join([torch.as_tensor(make_ts_packets(n * n_mux, seed=1 + k)
                               .reshape(n_mux, n, 188), device=dev)
               for k, n in enumerate(split(n_pk, hier))], hier)
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
    print(f"unprofiled ms/step, {'hierarchical, ' if hier else ''}{demap} "
          f"demap: TX {ms['tx']:.3f}, RX "
          f"{ms['rx']:.3f}, TX+RX {ms['tx+rx']:.3f} ({n_mux} x {n_samp} "
          f"samples); peak device memory {_peak_mb(step):.1f} MB ({card})",
          flush=True)
    name = ("slice_trace.json" if demap == "hard" and not hier
            else f"slice_{demap}{'_hier' if hier else ''}.json")
    return _profile(step, card, _build.BUILD_DIR / name)


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


def _stream(dev, card: str, frames: int = 8, mode=MODE_8K_UK) -> dict:
    """Profiles tracked blocks (bench.tracked_stream: one mux, ``frames``
    times the mode's frames per block, CFO 0.31) fed one at a time to a
    locked StreamingReceiver with pipeline=4 and metrics="min"; returns
    _profile's reading per block."""
    n_frames = mode.frames_per_block * frames
    n_warm, n_timed = 4, 8
    _, _, blocks = bench.tracked_stream(
        mode, dev, n_frames, n_warm + n_timed + PROFILED_STEPS)
    srx = loopback.StreamingReceiver(mode, dev, n_frames, pipeline=4,
                                     metrics="min")
    for b in blocks[:n_warm]:
        srx.feed(b)
    srx.flush()
    if not srx.locked:
        raise SystemExit("profile_slice: the streaming receiver did not lock")
    it = iter(blocks[n_warm:])

    def step():
        srx.feed(next(it))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        step()
    srx.flush()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    print(f"unprofiled ms per tracked block ({n_timed} blocks fed with "
          f"pipeline=4, then the flush): {ms:.3f} ({srx.block_samples} "
          f"samples, {frames} frames of {mode.transmission} "
          f"{mode.constellation} {mode.code_rate}) ({card})", flush=True)
    return _profile(step, card, _build.BUILD_DIR / "stream_trace.json")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", action="store_true",
                    help="profile the block path instead of the slice")
    ap.add_argument("--demap", choices=("hard", "soft"), default="hard",
                    help="the slice receiver's demap")
    ap.add_argument("--hier", action="store_true",
                    help="the slice at the hierarchical configuration")
    ap.add_argument("--stream", action="store_true",
                    help="tracked blocks through the StreamingReceiver")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = device_card(dev)
    if args.blocks:
        _blocks(dev, card)
    elif args.stream:
        _stream(dev, card)
    else:
        _slice(dev, card, args.demap, args.hier)


if __name__ == "__main__":
    main()
