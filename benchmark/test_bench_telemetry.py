"""The telemetry window (benchmark/stage_window.py) and its readers.

On the CPU: each reader from a synthetic reading, None for another kind
and where the reading holds no window and the command line names no
traced cell; the window of each driver at 2K, and None where the program
has no telemetry.  On the card (``-m card``): the graph captured with a
recorder still launches K1 and K2 once, its ``rs_decode`` time is within
10% of the eager trace's range in the same process, and the graph without
a recorder launches the operations a step that ``step_ops.txrx`` read
before stage telemetry (1,360 in the UK cell)."""

import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark import common, run, stage_window
from benchmark.test_bench_faults import small_ctx

ROOT = Path(__file__).resolve().parents[1]
# metric: (reading kind, stage, field of the recorder's summary)
READERS = {
    "graph_rs_decode_ms.txrx": ("txrx", "rs_decode", "device_ms"),
    "graph_demap_ms.txrx": ("txrx", "demap_deinterleave", "device_ms"),
    "graph_viterbi_ms.txrx": ("txrx", "viterbi_decode", "device_ms"),
    "graph_unstaged_ms.txrx": ("txrx", "graph_step", "self_device_ms"),
    "host_ms.capture": ("capture", "block_rx", "host_ms"),
}
# step_ops.txrx of the UK cell before stage telemetry: the graph's operations
UK_STEP_OPS = 1360


def test_every_new_metric_is_declared():
    declared = {m["name"]: m for m in run.spec()["per_layer"]}
    for name in READERS:
        assert declared[name]["source"] == "program_span"


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_summary(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pytest"])
    kind, stage, field = READERS[name]
    other = "capture" if kind == "txrx" else "txrx"
    read = run.reader(name)
    row = {"device_ms": 1.5, "host_ms": 2.5, "self_device_ms": 0.5,
           "self_host_ms": 0.25, "calls": 3}
    assert read(None, {"kind": kind, "telemetry": {stage: row}}) \
        == row[field]
    assert read(None, {"kind": other, "telemetry": {stage: row}}) is None
    assert read(None, {"kind": kind, "telemetry": {}}) is None
    assert read(None, {"kind": kind, "telemetry": None}) is None
    absent = {"kind": kind}
    assert read(None, absent) is None and absent["telemetry"] is None


@pytest.mark.parametrize("argv", [
    [], ["--workload", "uk_headend_8mux", "--seed", "7", "--trace", "0"],
    ["--seed", "7", "--trace", "1"], ["--workload", "x", "--seed", "y"]])
def test_no_window_without_a_traced_cell(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", *argv])
    assert stage_window.command_line_context() is None


@pytest.mark.parametrize("driver,unit,n", [
    ("graph_step", "rs_decode", 2), ("capture_passes", "block_rx", 2)])
def test_window_on_the_cpu(driver, unit, n, monkeypatch):
    ctx = small_ctx(driver, 2**31 + 21)
    ctx.mix.update(trace_steps=n, trace_passes=n, capture_sets=1,
                   n_mux=1)
    summ = stage_window.window(ctx)
    assert summ[unit]["calls"] == n
    assert summ[unit]["host_ms"] > 0 and summ[unit]["device_ms"] is None
    import dvbt_tpu_torch.utils
    monkeypatch.setitem(sys.modules, "dvbt_tpu_torch.utils.telemetry", None)
    monkeypatch.delattr(dvbt_tpu_torch.utils, "telemetry")
    assert stage_window.window(ctx) is None


@pytest.mark.card
def test_graph_stages_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dvbt_tpu_torch import DvbtMode
    from dvbt_tpu_torch.bench import GraphStep
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm
    from dvbt_tpu_torch.utils.telemetry import Recorder

    from benchmark import trace as tr
    from benchmark.drivers import graph_step

    _, config, mix = run.cell(run.spec(), "uk_headend_8mux")
    dev = torch.device("cuda", 0)
    ctx = common.Context("uk_headend_8mux", config, mix, 11, 0.0, True,
                         dev)
    mode = DvbtMode(**config["mode"])
    n_mux, n_frames = mix["n_mux"], mix["frames"]
    tx, n_pk, _ = txm.make_transmitter(mode, dev, n_frames)
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames, **config["receiver"])

    def eager(tst, rst, packets):
        tst, iq = tx(tst, packets)
        rst, ts, met = rx(rst, iq)
        return tst, rst, ts, met["rs_uncorrectable"]

    pool = graph_step.packet_pool(ctx, n_pk)
    states = [(txm.init_tx_state(mode, n_mux, dev),
               rxm.init_rx_state(mode, n_mux, dev)) for _ in range(3)]
    rec = Recorder(dev)
    plain = GraphStep(eager, *states[0], torch.zeros_like(pool[0]))
    timed = GraphStep(eager, *states[1], torch.zeros_like(pool[0]),
                      telemetry=rec)
    assert timed.captured == {"byte_coder": 1, "viterbi_punct": 1}

    def ops(step, st, n=3):
        with tr.profiled(dev) as h:
            for k in range(n):
                step(*st, pool[k % len(pool)])
        return len(h["trace"].program_ops()) / n

    for step, st in ((plain, states[0]), (timed, states[1])):
        step(*st, pool[0])
    assert ops(plain, states[0]) == UK_STEP_OPS
    assert ops(timed, states[1]) == UK_STEP_OPS
    for k in range(5):
        timed(*states[1], pool[k % len(pool)])
        torch.cuda.synchronize(dev)
        rec.collect()
    graph_ms = rec.summary()["rs_decode"]["device_ms"]
    for k in range(2):
        eager(*states[2], pool[k])
    torch.cuda.synchronize(dev)
    with tr.profiled(dev) as h:
        for k in range(2):
            eager(*states[2], pool[k])
    eager_ms = h["trace"].range_us()["rs_decode"] / 2 / 1e3
    print(json.dumps({"graph_rs_decode_ms": graph_ms,
                      "eager_rs_decode_ms": eager_ms,
                      "summary": rec.summary()}))
    assert graph_ms == pytest.approx(eager_ms, rel=0.10)
