"""The capture driver of one stream or two (``drivers/capture_streams``)
on the CPU at 2K.  On a single-stream configuration it makes the same
captures as ``capture_passes`` from a seed and checks them alike; on a
hierarchical one a sound run is correct, and each of three faults planted
in the program (one LP byte altered, the HP and LP outputs swapped, the LP
decoder handed a stale state) makes it not.  A traced run keeps the
recorder's summary in its reading, where ``lp_decode_ms.capture`` and
``host_ms.capture`` read it.  The harness's look for a card is skipped;
the rest is the run."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import common, faults, run
from benchmark.drivers import capture_passes, capture_streams

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"n_mux": 2, "capture_sets": 2, "warm_passes": 1, "frames": 1}
SINGLE_MODE = {"transmission": "2k", "constellation": "qpsk",
               "code_rate": "1/2", "guard": "1/32", "alpha": 0,
               "code_rate_lp": "1/2"}
HIER_MODE = {"transmission": "2k", "constellation": "64qam",
             "code_rate": "2/3", "guard": "1/32", "alpha": 2,
             "code_rate_lp": "3/4"}


def _ctx(hier: bool, seed: int, trace: bool = False) -> common.Context:
    """A cell's context cut to 2K, two captures a pass, one frame out and
    a window of one pass."""
    config, traffic = (("hier_monitor_8k64qam_a2", "hier_capture_8mux")
                       if hier else ("uk_8k64qam23", "capture_8mux"))
    cfg = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    cfg["mode"] = dict(HIER_MODE if hier else SINGLE_MODE)
    mix = json.loads((ROOT / f"benchmark/traffic/{traffic}.json")
                     .read_text())
    mix.update(SMALL)
    return common.Context(traffic, cfg, mix, seed, 0.0, trace,
                          torch.device("cpu"))


def _summary(res: dict) -> tuple:
    return ([(c.name, c.value, c.limit) for c in res["checks"]],
            res["attempted"], res["failed"])


@pytest.mark.parametrize("seed", [2**31 + 41, 2**33 + 7])
def test_single_stream_checks_equal_capture_passes(seed):
    passes = capture_passes.run(_ctx(False, seed))
    streams = capture_streams.run(_ctx(False, seed))
    assert _summary(streams) == _summary(passes)
    assert all(c.ok for c in streams["checks"])


def test_hierarchical_run_is_correct():
    res = capture_streams.run(_ctx(True, 2**31 + 43))
    assert all(c.ok for c in res["checks"]), res["checks"]
    assert res["attempted"] == 2 and res["failed"] == 0


def _swapped(rx):
    def bad(st, cap):
        st, (ts_hp, ts_lp), info = rx(st, cap)
        info = dict(info, rs_uncorrectable=info["lp_rs_uncorrectable"],
                    lp_rs_uncorrectable=info["rs_uncorrectable"])
        return st, (ts_lp, ts_hp), info
    return bad


def _stale_lp(rx):
    """The LP decoder handed the LP state the previous pass left, where the
    pass gives it the initial state."""
    held = {}

    def bad(st, cap):
        st_in = dict(st, lp=held["lp"]) if held else st
        st, ts, info = rx(st_in, cap)
        held["lp"] = st["lp"]
        return st, ts, info
    return bad


@pytest.mark.parametrize("fault", ["altered", "swapped", "stale_lp"])
def test_fault_is_not_correct(fault, monkeypatch):
    from dvbt_tpu_torch.models import flowgraph
    ctx = _ctx(True, 2**31 + 44)
    ctx.mix["capture_sets"] = 3
    if fault == "altered":          # one byte of the LP stream
        with faults.planted("capture_passes", "altered"):
            res = capture_streams.run(ctx)
    else:
        make = flowgraph.make_block_receiver
        wrap = _swapped if fault == "swapped" else _stale_lp

        def make_bad(*a, **k):
            rx, n_pk = make(*a, **k)
            return wrap(rx), n_pk
        monkeypatch.setattr(flowgraph, "make_block_receiver", make_bad)
        res = capture_streams.run(ctx)
    checks = {c.name: c for c in res["checks"]}
    assert not checks["ts_bad_packets"].ok
    assert res["failed"] > 0


def test_traced_reading_holds_the_telemetry(monkeypatch):
    """The traced run's reading: the profiled passes' ranges and the
    recorder's summary of ``trace_passes`` more passes, with ``lp_decode``
    inside ``block_rx``.  On the CPU a span has no device time, so
    ``lp_decode_ms.capture`` reads None there and ``host_ms.capture`` a
    number.  The device calls of the traced path do nothing here."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    ctx = _ctx(True, 2**31 + 45, trace=True)
    ctx.mix["trace_passes"] = 2
    res = capture_streams.run(ctx)
    assert all(c.ok for c in res["checks"]), res["checks"]
    reading = res["reading"]
    assert reading["kind"] == "capture" and reading["units"] == 2
    assert isinstance(reading["ranges"], dict)   # device times: none here
    tele = reading["telemetry"]
    assert tele["lp_decode"]["calls"] == tele["block_rx"]["calls"] == 2
    assert tele["viterbi_decoder"]["calls"] == 2
    assert run.reader("lp_decode_ms.capture")(res["trace"], reading) is None
    host = run.reader("host_ms.capture")(res["trace"], reading)
    assert host == tele["block_rx"]["host_ms"] > 0


def test_lp_decode_reader():
    read = run.reader("lp_decode_ms.capture")
    row = {"device_ms": 1.25, "host_ms": 0.5, "self_device_ms": 0.01,
           "self_host_ms": 0.01, "calls": 5}
    assert read(None, {"kind": "capture",
                       "telemetry": {"lp_decode": row}}) == 1.25
    assert read(None, {"kind": "capture", "telemetry": {}}) is None
    assert read(None, {"kind": "capture"}) is None
    assert read(None, {"kind": "txrx",
                       "telemetry": {"lp_decode": row}}) is None
