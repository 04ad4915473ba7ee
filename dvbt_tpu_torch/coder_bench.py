"""Device time of the inner coder kernel K2 at the main path's shapes.

    python3 -m dvbt_tpu_torch.coder_bench

K2 (``byte_coder``) at the flagship TX's shape, 8 muxes x 822,528 bytes at
rate 2/3 (8 x 9,870,336 coded bytes out), and at the time-sharded step's,
1 x 205,632 bytes (one frame of one mux).  At ~0.03 ms a launch the host
may issue launches (ctypes, a ``torch.empty`` each) more slowly than the
card runs them, and then CUDA events time the host; so the kernel's time
is ``torch.profiler``'s (its own device time over back-to-back launches),
and CUDA events over as many launches are reported beside it only to show
the host's issue rate.  The plain version is timed by events.  It uses
only the kernel's public wrappers, so the same file times any tree of the
package that has them.  ``chip_smoke.py`` takes its K2 timing from here.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import MODE_8K_UK
from .apps.device import card as device_card
from .kernels import coder as kcoder
from .viterbi_bench import event_ms

RATE = MODE_8K_UK.code_rate
FLAG_BYTES = MODE_8K_UK.packets_per_block * 4 * 204   # 4 frames a mux
FRAME_BYTES = MODE_8K_UK.packets_per_block * 204      # the time-sharded step
KERNEL_NAME = "byte_coder_kernel"


def inputs(n_mux: int, n_bytes: int, device, seed: int = 0):
    """(state6 zeros (n_mux, 6), stream (n_mux, n_bytes)) uint8 from a
    seed."""
    rng = np.random.default_rng(seed)
    stream = torch.as_tensor(rng.integers(0, 256, (n_mux, n_bytes),
                                          dtype=np.uint8), device=device)
    return torch.zeros(n_mux, 6, dtype=torch.uint8, device=device), stream


def profiler_ms(fn, reps: int, name: str = KERNEL_NAME) -> float:
    """Mean device time of the kernels whose name holds ``name``, by
    torch.profiler over reps runs of fn() (the mean over the launches the
    trace holds: it may drop a few); raises if it holds fewer than 90%."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    count = sum(e.count for e in hits)
    if not 0.9 * reps <= count <= reps:
        raise RuntimeError(f"profiler saw {count} launches of {name} in "
                           f"{reps} runs: {[e.key for e in hits]}")
    total_us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                   for e in hits)
    return total_us / 1e3 / count


def device_ms(fn, reps: int) -> dict:
    """K2's time: ``ms`` by the profiler, ``events_ms`` (the host's issue
    rate where it is the slower) by events."""
    return {"events_ms": event_ms(fn, reps), "ms": profiler_ms(fn, reps)}


def time_shape(n_mux: int, n_bytes: int, device, reps: int = 200,
               plain_reps: int = 5) -> dict:
    """K2 and its plain version at one shape, in the order plain, K2, K2,
    plain."""
    state, stream = inputs(n_mux, n_bytes, device)

    def k2():
        kcoder.byte_coder(state, stream, RATE)

    def plain():
        kcoder.byte_coder_plain(state, stream, RATE)

    p1 = event_ms(plain, plain_reps)
    runs = [device_ms(k2, reps), device_ms(k2, reps)]
    p2 = event_ms(plain, plain_reps)
    return {"shape": [n_mux, n_bytes], "runs": runs,
            "ms": sum(r["ms"] for r in runs) / 2, "plain_runs": [p1, p2],
            "plain_ms": (p1 + p2) / 2}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("coder_bench: no CUDA device")
    dev = torch.device("cuda", 0)
    card = device_card(dev)
    res = {"flagship": time_shape(8, FLAG_BYTES, dev),
           "frame": time_shape(1, FRAME_BYTES, dev),
           "card": card}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
