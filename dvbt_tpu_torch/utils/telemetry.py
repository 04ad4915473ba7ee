"""Stage timing: one profiler range per stage and, while a ``Recorder`` is
active, one span per stage with its host and device times.

``stage(name)`` is the context manager every stage of the port runs in
(``models/tx.py``, ``models/rx.py``, ``models/flowgraph.py``,
``bench.GraphStep``).  With no recorder active it is the
``torch.profiler.record_function(name)`` range itself, so that a profiler
trace holds one range per stage and nothing else is done.  Inside
``with Recorder(device):`` each stage also records a span: its name, the
enclosing span, the call it belongs to, its host start and end, and the
device time between a pair of CUDA events recorded on the current stream
at its start and end.

A stage entered while a CUDA graph is being captured records its events
into the graph (``torch.cuda.Event(external=True)``), so every replay
records them again: ``collect()`` after a replay and a synchronize reads
that replay's device times.  Such spans have no host times (a replay runs
no Python).  A recorder serves one captured graph, or eager calls, or
both; it reads the spans of one call at each ``collect()``.

Host times are Unix-epoch nanoseconds (``time.time_ns()``), the clock the
profiler's Chrome trace is kept on: there an event's ``ts`` is in
microseconds from the trace's ``baseTimeNanoseconds`` (0 where the trace
has none), so a span starts at ``(host_start_ns - base) / 1e3`` on the
trace's timeline.  Device times are milliseconds from the call's first
event.  Nothing here synchronizes: the caller synchronizes and then calls
``collect()``.  Spans stay in memory; nothing is written out.

    rec = Recorder(device)
    with rec:
        step(...)                  # or a replay of a graph captured in rec
    torch.cuda.synchronize(device)
    rec.collect()
    rec.summary()["rs_decode"]["device_ms"]
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

# the recorder that stage() records into: set by ``with Recorder(...)``
_active = None
# the most spans a recorder keeps
MAX_SPANS = 1 << 16


def stage(name: str):
    """The profiler range ``name``; while a Recorder is active, that
    recorder's span of the stage too."""
    rec = _active
    if rec is None:
        return record_function(name)
    return _Stage(rec, name)


class Span(NamedTuple):
    """One stage of one call.  ``parent`` is the index in
    ``Recorder.spans`` of the enclosing span (None at the top); host times
    are Unix-epoch ns (None inside a graph replay), device times ms from
    the call's first event (None without a CUDA device)."""
    name: str
    parent: int | None
    call: int
    host_start_ns: int | None
    host_end_ns: int | None
    device_start_ms: float | None
    device_end_ms: float | None

    @property
    def host_ms(self) -> float | None:
        if self.host_start_ns is None:
            return None
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms


class _Mark:
    """A stage entered since the last collect, or captured into a graph."""
    __slots__ = ("name", "parent", "events", "captured", "start", "end")

    def __init__(self, name, parent, events, captured):
        self.name, self.parent = name, parent
        self.events, self.captured = events, captured
        self.start = self.end = None


class _Stage:
    """A stage's profiler range and its span in the active recorder."""
    __slots__ = ("rec", "range", "name", "mark")

    def __init__(self, rec, name: str):
        self.rec, self.name = rec, name
        self.range = record_function(name)

    def __enter__(self):
        self.range.__enter__()
        self.mark = self.rec._open(self.name)
        return self

    def __exit__(self, *exc):
        self.rec._close(self.mark)
        return self.range.__exit__(*exc)


def _self_time(lo, hi, kids) -> float:
    """hi - lo less the part of [lo, hi] that the intervals kids cover."""
    covered, reach = 0.0, lo
    for s, e in sorted(kids):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            covered += e - s
            reach = e
    return (hi - lo) - covered


class Recorder:
    """Spans of the port's stages; active inside ``with recorder:``.

    ``spans`` holds at most ``MAX_SPANS`` spans: a call that would pass it
    is left out whole and counted in ``dropped``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.timed = self.device.type == "cuda"
        self.spans: list[Span] = []
        self.calls = 0
        self.dropped = 0
        self._marks: list[_Mark] = []      # eager, since the last collect
        self._captured: list[_Mark] = []   # recorded again by each replay
        self._stack: list[_Mark] = []
        self._free: list = []              # eager event pairs for reuse
        self._prev = None

    def __enter__(self):
        global _active
        self._prev, _active = _active, self
        return self

    def __exit__(self, *exc):
        global _active
        _active, self._prev = self._prev, None
        return False

    def _open(self, name: str) -> _Mark:
        parent = self._stack[-1] if self._stack else None
        events, captured = None, False
        if self.timed:
            captured = torch.cuda.is_current_stream_capturing()
            if captured and parent is not None and not parent.captured:
                parent = None     # an eager span does not outlive its call
            if captured:
                events = (torch.cuda.Event(enable_timing=True, external=True),
                          torch.cuda.Event(enable_timing=True, external=True))
            else:
                events = self._free.pop() if self._free else (
                    torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        m = _Mark(name, parent, events, captured)
        (self._captured if captured else self._marks).append(m)
        self._stack.append(m)
        m.start = time.time_ns()
        if events is not None:
            events[0].record()
        return m

    def _close(self, m: _Mark) -> None:
        if m.events is not None:
            m.events[1].record()
        m.end = time.time_ns()
        if self._stack.pop() is not m:
            raise RuntimeError(f"stage {m.name!r} closed out of order")

    def collect(self) -> int | None:
        """Read the stages entered since the last collect and the last
        replay of every captured stage into ``spans``, as one call; the
        caller has synchronized the device since.  Returns the call's id,
        or None when there was nothing to read or no room."""
        if self._stack:
            raise RuntimeError("collect() inside an open stage")
        marks = self._captured + self._marks
        self._marks = []
        if not marks:
            return None
        if len(self.spans) + len(marks) > MAX_SPANS:
            self.dropped += 1
            self._free += [m.events for m in marks
                           if m.events is not None and not m.captured]
            return None
        call = self.calls
        self.calls += 1
        index = {id(m): len(self.spans) + i for i, m in enumerate(marks)}
        base = marks[0].events[0] if self.timed else None
        for m in marks:
            dev = (base.elapsed_time(m.events[0]),
                   base.elapsed_time(m.events[1])) if self.timed else \
                (None, None)
            host = (None, None) if m.captured else (m.start, m.end)
            parent = None if m.parent is None else index[id(m.parent)]
            self.spans.append(Span(m.name, parent, call, *host, *dev))
            if self.timed and not m.captured:
                self._free.append(m.events)
        return call

    def self_times(self) -> list:
        """[(self host ms, self device ms)] of each span: its duration less
        the part of its interval that its children cover (None where the
        time was not taken)."""
        kids: dict = {}
        for i, s in enumerate(self.spans):
            if s.parent is not None:
                kids.setdefault(s.parent, []).append(s)
        out = []
        for i, s in enumerate(self.spans):
            ks = kids.get(i, [])
            host = dev = None
            if s.host_start_ns is not None:
                host = _self_time(s.host_start_ns, s.host_end_ns, [
                    (k.host_start_ns, k.host_end_ns) for k in ks
                    if k.host_start_ns is not None]) / 1e6
            if s.device_start_ms is not None:
                dev = _self_time(s.device_start_ms, s.device_end_ms, [
                    (k.device_start_ms, k.device_end_ms) for k in ks])
            out.append((host, dev))
        return out

    def summary(self) -> dict:
        """{stage name: {"device_ms", "host_ms", "self_device_ms",
        "self_host_ms", "calls"}}: each time summed over the call's spans
        of that name and averaged over the ``calls`` calls that hold one
        (None where not taken)."""
        keys = ("host_ms", "device_ms", "self_host_ms", "self_device_ms")
        sums: dict = {}
        for s, selves in zip(self.spans, self.self_times()):
            per_call = sums.setdefault(s.name, {}).setdefault(
                s.call, [None] * 4)
            for j, v in enumerate((s.host_ms, s.device_ms) + selves):
                if v is not None:
                    per_call[j] = (per_call[j] or 0.0) + v
        out = {}
        for name, by_call in sums.items():
            row = {"calls": len(by_call)}
            for j, key in enumerate(keys):
                vals = [c[j] for c in by_call.values() if c[j] is not None]
                row[key] = sum(vals) / len(vals) if vals else None
            out[name] = row
        return out
