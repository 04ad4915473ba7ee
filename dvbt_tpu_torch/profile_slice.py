"""Where the flagship step's time goes, on one CUDA device.

    python3 -m dvbt_tpu_torch.profile_slice

Runs the flagship slice (MODE_8K_UK, 8 muxes x 4 frames per step, TX then
symbol-aligned RX) and prints:

- TX, RX and TX+RX ms/step on the host clock, unprofiled, and the peak
  device memory of one step;
- from ONE torch.profiler trace of 5 TX+RX steps: device ms per
  step inside each stage's profiler range, the device busy time (union of
  kernel, memcpy and memset intervals), the wall time of the profiled
  steps, the idle share 1 - busy / wall, and the number of device
  operations.  The profiler slows the host, so the traced idle share is an
  upper bound for an unprofiled step.

The Chrome trace is kept at ``build/dvbt_tpu_torch/slice_trace.json``
beside the package.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import MODE_8K_UK, make_ts_packets
from .kernels import _build
from .models import rx as rxm
from .models import tx as txm

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILED_STEPS = 5
TRACE = _build.BUILD_DIR / "slice_trace.json"


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    dev = torch.device("cuda", 0)
    mode, n_mux, n_frames = MODE_8K_UK, 8, 4
    tx, n_pk, n_samp = txm.make_transmitter(mode, dev, n_frames)
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames)
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
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    print(f"unprofiled ms/step: TX {ms['tx']:.3f}, RX {ms['rx']:.3f}, "
          f"TX+RX {ms['tx+rx']:.3f} ({n_mux} x {n_samp} samples); peak "
          f"device memory {peak_mb:.1f} MB ({card})")

    n = PROFILED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    trace = json.loads(TRACE.read_text())
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
        print(f"  {name:22s} {us / 1e3 / n:9.3f} ms/step "
              f"{us / total * 100:5.1f}%")


if __name__ == "__main__":
    main()
