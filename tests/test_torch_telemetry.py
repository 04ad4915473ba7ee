"""The port's stage telemetry (dvbt_tpu_torch.utils.telemetry) on the CPU.

With no recorder a stage is the profiler range it always was: an eager 2K
TX -> RX step and a block-path pass hold the same ranges as before (the
pass one more, ``block_rx``), and no CUDA event is made.  With a recorder
the outputs are byte for byte the same, spans nest with their parents and
calls, self times and ``summary()`` add up, and a span's host times sit on
the clock of the profiler's Chrome trace.  No stage's name starts with
the benchmark harness's ``bench.``."""

import contextlib
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvbt_tpu_torch import MODE_2K_QPSK, bench, make_ts_packets
from dvbt_tpu_torch.models import flowgraph
from dvbt_tpu_torch.models import rx as rxm
from dvbt_tpu_torch.models import tx as txm
from dvbt_tpu_torch.ops import sync as sync_ops
from dvbt_tpu_torch.utils import telemetry
from dvbt_tpu_torch.utils.telemetry import Recorder, stage

torch.set_num_threads(1)

PACKAGE = Path(telemetry.__file__).resolve().parents[1]
N_MUX = 2
# the ranges of one eager TX -> RX step with metrics="full", in order
STEP_RANGES = [
    "energy_dispersal", "rs_encode", "outer_interleave", "inner_coder",
    "bit_interleave", "qam_map", "frame_build", "ofdm_mod",
    "ofdm_demod", "channel_estimate", "tps_decode", "demap_deinterleave",
    "viterbi_decode", "outer_deinterleave", "rs_decode", "descramble"]
# the block path's stages, inside the pass's own block_rx
BLOCK_RANGES = [
    "synchronizer", "ofdm_demodulator", "demod_reference_signals",
    "dvbt_demap", "symbol_inner_interleaver", "bit_inner_interleaver",
    "viterbi_decoder", "convolutional_deinterleaver", "reed_solomon_dec",
    "energy_descramble"]


def _no_cuda_events(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA event was made")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def _chrome(prof, tmp_path) -> dict:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def _ranges(trace: dict) -> list:
    evs = [e for e in trace["traceEvents"]
           if e.get("cat") == "user_annotation"]
    return [e["name"] for e in sorted(evs, key=lambda e: e["ts"])]


@pytest.fixture(scope="module")
def step_io():
    """The packets of two 2K steps."""
    n_pk = txm.make_transmitter(MODE_2K_QPSK, "cpu", 1)[1]
    return torch.as_tensor(make_ts_packets(2 * N_MUX * n_pk, seed=3)
                           .reshape(2, N_MUX, n_pk, 188))


def _steps(packets, rec=None, collect=False):
    """Two eager TX -> RX steps; returns [(iq, ts, bad)] of each."""
    mode = MODE_2K_QPSK
    tx, _, _ = txm.make_transmitter(mode, "cpu", 1)
    rx, _, _ = rxm.make_receiver(mode, "cpu", 1)
    tst = txm.init_tx_state(mode, N_MUX, "cpu")
    rst = rxm.init_rx_state(mode, N_MUX, "cpu")
    out = []
    for pk in packets:
        with rec if rec is not None else contextlib.nullcontext():
            tst, iq = tx(tst, pk)
            rst, ts, met = rx(rst, iq)
        if collect:
            rec.collect()
        out.append((iq, ts, met["rs_uncorrectable"]))
    return out


def _capture():
    """Two 2K captures of the port's own TX at their own delays, and a
    block receiver of one frame for them."""
    mode = MODE_2K_QPSK
    tx, n_pk, _ = txm.make_transmitter(mode, "cpu", 1)
    st = txm.init_tx_state(mode, 1, "cpu")
    pk = make_ts_packets(6 * n_pk, seed=5)
    iq = []
    for b in range(6):
        st, x = tx(st, torch.as_tensor(pk[b * n_pk:(b + 1) * n_pk])[None])
        iq.append(x[0])
    stream = torch.cat(iq)
    n_cap = sync_ops.min_capture_samples(mode, 1)
    L = mode.symbol_len
    caps = torch.stack([stream[off:off + n_cap]
                        for off in (41 * L + 1234, 9 * L + 517)])
    rx, _ = flowgraph.make_block_receiver(mode, "cpu", n_cap, 1)
    return rx, flowgraph.init_block_rx_state(mode, 2, "cpu"), caps


def test_without_a_recorder_the_ranges_are_as_before(step_io, tmp_path,
                                                     monkeypatch):
    _no_cuda_events(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(step_io[:1])
    assert _ranges(_chrome(prof, tmp_path)) == STEP_RANGES
    rx, state, caps = _capture()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rx(state, caps)
    assert _ranges(_chrome(prof, tmp_path)) == ["block_rx"] + BLOCK_RANGES


def test_without_a_recorder_a_stage_is_the_profiler_range():
    assert type(stage("x")) is torch.profiler.record_function
    with Recorder("cpu"):
        assert type(stage("x")) is not torch.profiler.record_function
    assert telemetry._active is None


def test_a_recorder_changes_no_output(step_io, monkeypatch):
    _no_cuda_events(monkeypatch)
    plain = _steps(step_io)
    rec = Recorder("cpu")
    traced = _steps(step_io, rec, collect=True)
    for a, b in zip(plain, traced):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert rec.calls == 2
    assert [s.name for s in rec.spans] == STEP_RANGES * 2
    rx, state, caps = _capture()
    _, ts0, info0 = rx(state, caps)
    with rec:
        _, ts1, info1 = rx(state, caps)
    assert torch.equal(ts0, ts1)
    assert all(torch.equal(info0[k], info1[k]) for k in info0)


def test_spans_nest_in_calls_and_self_times_add_up(monkeypatch):
    _no_cuda_events(monkeypatch)
    rx, state, caps = _capture()
    rec = Recorder("cpu")
    for _ in range(2):
        with rec:
            rx(state, caps)
        rec.collect()
    n = 1 + len(BLOCK_RANGES)
    assert len(rec.spans) == 2 * n
    for c in range(2):
        call = rec.spans[c * n:(c + 1) * n]
        top = c * n
        assert [s.name for s in call] == ["block_rx"] + BLOCK_RANGES
        assert {s.call for s in call} == {c}
        assert call[0].parent is None
        assert all(s.parent == top for s in call[1:])
        assert all(s.device_ms is None for s in call)
        for s in call[1:]:
            assert call[0].host_start_ns <= s.host_start_ns
            assert s.host_end_ns <= call[0].host_end_ns
        kids = sum(s.host_ms for s in call[1:])
        self_host, self_dev = rec.self_times()[top]
        assert self_dev is None
        assert self_host == pytest.approx(call[0].host_ms - kids, abs=1e-6)
        assert 0 <= self_host < call[0].host_ms
    summ = rec.summary()
    assert set(summ) == {"block_rx"} | set(BLOCK_RANGES)
    for name, row in summ.items():
        spans = [s for s in rec.spans if s.name == name]
        assert row["calls"] == 2 and row["device_ms"] is None
        assert row["host_ms"] == pytest.approx(
            sum(s.host_ms for s in spans) / 2)
    assert summ["block_rx"]["self_host_ms"] == pytest.approx(
        sum(rec.self_times()[c * n][0] for c in range(2)) / 2)


def test_nested_and_repeated_stages():
    """Two calls of an outer stage holding ``a`` twice and ``b`` with ``a``
    inside: parents by index, sums within a call, means over calls."""
    rec = Recorder("cpu")
    for _ in range(2):
        with rec, stage("outer"):
            for name in ("a", "a", "b"):
                with stage(name):
                    if name == "b":
                        with stage("a"):
                            time.sleep(0.002)
                    time.sleep(0.001)
        rec.collect()
    names = [s.name for s in rec.spans]
    assert names == ["outer", "a", "a", "b", "a"] * 2
    assert [s.parent for s in rec.spans] == [None, 0, 0, 0, 3,
                                             None, 5, 5, 5, 8]
    assert [s.call for s in rec.spans] == [0] * 5 + [1] * 5
    selves = rec.self_times()
    for i, s in enumerate(rec.spans):
        kids = [k for k in rec.spans if k.parent == i]
        assert selves[i][0] == pytest.approx(
            s.host_ms - sum(k.host_ms for k in kids), abs=1e-6)
    summ = rec.summary()
    a = [s.host_ms for s in rec.spans if s.name == "a"]
    assert summ["a"]["host_ms"] == pytest.approx(sum(a) / 2)
    assert summ["a"]["calls"] == 2
    assert summ["b"]["self_host_ms"] == pytest.approx(
        (selves[3][0] + selves[8][0]) / 2)


def test_self_time_counts_overlapping_children_once():
    assert telemetry._self_time(0.0, 10.0, [(1, 4), (3, 6), (8, 12)]) == \
        pytest.approx(10 - 5 - 2)
    assert telemetry._self_time(0.0, 10.0, []) == 10.0


def test_spans_are_bounded_and_collect_refuses_an_open_stage(monkeypatch):
    monkeypatch.setattr(telemetry, "MAX_SPANS", 5)
    rec = Recorder("cpu")
    for _ in range(3):
        with rec:
            for name in ("a", "b", "c"):
                with stage(name):
                    pass
        rec.collect()
    assert len(rec.spans) == 3 and rec.calls == 1 and rec.dropped == 2
    assert rec.collect() is None
    with rec, stage("open"):
        with pytest.raises(RuntimeError):
            rec.collect()


def test_host_times_are_on_the_chrome_trace_clock(tmp_path):
    """Each span lies inside its range of the Chrome trace, ``(ns - base) /
    1e3`` microseconds from the trace's ``baseTimeNanoseconds``: the median
    offset of its start and of its end within 100 us, none more than 100 us
    outside the range or 1 ms inside it (on a busy host a range's entry
    and exit take tens of us)."""
    rec = Recorder("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec:
            for i in range(24):      # the first ranges pay the set-up
                with stage(f"clock{i}"):
                    time.sleep(0.001)
    rec.collect()
    trace = _chrome(prof, tmp_path)
    base = trace.get("baseTimeNanoseconds", 0)
    ev = {e["name"]: e for e in trace["traceEvents"]
          if e.get("cat") == "user_annotation"}
    starts, ends = [], []
    for s in rec.spans[8:]:
        e = ev[s.name]
        starts.append((s.host_start_ns - base) / 1e3 - e["ts"])
        ends.append(e["ts"] + e["dur"] - (s.host_end_ns - base) / 1e3)
    for off in (starts, ends):
        assert -100 < min(off) and max(off) < 1000, off
        assert abs(float(np.median(off))) < 100, off


def test_make_step_takes_demap_and_telemetry(monkeypatch):
    _no_cuda_events(monkeypatch)
    rec = Recorder("cpu")
    step = bench.make_step(MODE_2K_QPSK, "cpu", N_MUX, 1, graph=False,
                           demap="soft", telemetry=rec)
    n_pk = step.n_packets
    sent = torch.as_tensor(make_ts_packets(N_MUX * n_pk, seed=9)
                           .reshape(N_MUX, n_pk, 188))
    tst = txm.init_tx_state(MODE_2K_QPSK, N_MUX, "cpu")
    rst = rxm.init_rx_state(MODE_2K_QPSK, N_MUX, "cpu")
    for _ in range(2):
        tst, rst, ts, bad = step(tst, rst, sent)
        rec.collect()
    assert telemetry._active is None
    d = 11
    assert not bad.any()
    np.testing.assert_array_equal(ts[:, d:].numpy(), sent[:, :-d].numpy())
    summ = rec.summary()
    assert summ["demap_deinterleave"]["calls"] == 2
    assert "tps_decode" not in summ        # metrics="min"


def test_no_stage_takes_the_harness_prefix():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names |= set(re.findall(r"""\bstage\(\s*f?["']([^"']+)["']""",
                                path.read_text()))
    assert set(STEP_RANGES) | set(BLOCK_RANGES) | {"block_rx",
                                                   "graph_step"} <= names
    assert not [n for n in names if n.startswith("bench.")]
