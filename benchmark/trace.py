"""Reading a torch.profiler trace: device busy time, device time inside
named ranges, operation counts, and where the device sat idle.

The arithmetic is the one ``dvbt_tpu_torch/profile_slice.py`` uses
(device busy as the union of kernel, memcpy and memset intervals; a
range's device time as the union of those intervals inside the range's
span on the device timeline), kept here so that the yardstick does not
move with the program.  Times are microseconds, as the trace has them.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
# ranges the harness opens around its own device work (the checks); their
# operations are not the program's
HARNESS_PREFIX = "bench."


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def merged(spans) -> list:
    """The union of intervals as sorted, disjoint intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def inside_us(dev_spans, start: float, end: float) -> float:
    """Device busy time within [start, end]."""
    return union_us([(max(s, start), min(e, end)) for s, e in dev_spans
                     if s < end and e > start])


class Trace:
    """The events of one profiler session, split by kind."""

    def __init__(self, events: list, wall_us: float):
        self.wall_us = wall_us
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and "dur" in e]
        self.annotations = [e for e in events
                            if e.get("cat") == "gpu_user_annotation"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and "dur" in e]
        self.spans = [(e["ts"], e["ts"] + e["dur"]) for e in self.device]

    def busy_us(self) -> float:
        return union_us(self.spans)

    def range_us(self) -> dict:
        """Device time inside each named range, summed over its spans."""
        out: dict = {}
        for e in self.annotations:
            us = inside_us(self.spans, e["ts"], e["ts"] + e["dur"])
            out[e["name"]] = out.get(e["name"], 0.0) + us
        return out

    def harness_spans(self) -> list:
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.annotations
                if e["name"].startswith(HARNESS_PREFIX)]

    def program_ops(self) -> list:
        """Device operations outside the harness's own ranges."""
        own = self.harness_spans()
        return [e for e in self.device
                if not any(s <= e["ts"] < t for s, t in own)]

    def memcpy_us(self, kind: str) -> float:
        """Device time of copies whose name holds ``kind`` (e.g. HtoD)."""
        return union_us([(e["ts"], e["ts"] + e["dur"]) for e in self.device
                         if e.get("cat") == "gpu_memcpy"
                         and kind in e.get("name", "")])

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most."""
        tot: dict = {}
        for e in self.device:
            tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"]
        return [[k, v / 1e6] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]] of the longest gaps between
        device operations, each named by the innermost host event that
        covers its middle."""
        busy = merged(self.spans)
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])
                if b[0] > a[1]]
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            mid = (s + e) / 2
            cover = [h for h in self.host
                     if h["ts"] <= mid <= h["ts"] + h["dur"]]
            name = (min(cover, key=lambda h: h["dur"])["name"] if cover
                    else "no host event")
            out.append([name, length / 1e6])
        return out


def warm_profiler(unit, n: int = 2) -> None:
    """A throwaway profiled session of ``n`` calls of ``unit()``: the
    profiler's first session pays its own set-up on the device."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(n):
            unit()


@contextlib.contextmanager
def profiled(device):
    """Profile the block (host and device); yields a dict that holds the
    ``Trace`` once the block has ended.  The Chrome trace goes to a file
    in the temporary directory, which is read and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield holder
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    holder["trace"] = Trace(events, wall_us)
