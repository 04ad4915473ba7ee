"""The telemetry window (benchmark/stage_window.py) and its readers.

On the CPU: each reader from a synthetic reading, None for another kind
and where the reading holds no window and the command line names no
traced cell; the window of each driver at 2K (the head-end's in a
hierarchical mode too), and None where the program has no telemetry.  On
the card (``-m card``): the graph captured with a recorder still launches
K1, K2 and the RS decoder once, its RS decode, demap and Viterbi decode
times are each within 10% of the eager trace's ranges in the same process,
and the graph with a recorder launches the operations a step that the
graph without one launches and that ``step_ops.txrx`` reads (161 in the UK
cell)."""

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
    "graph_demap_ms.txrx": ("txrx", "demap_deinterleave", "device_ms"),
    "graph_viterbi_ms.txrx": ("txrx", "viterbi_decode", "device_ms"),
    "graph_unstaged_ms.txrx": ("txrx", "graph_step", "self_device_ms"),
    "host_ms.capture": ("capture", "block_rx", "host_ms"),
}
# step_ops.txrx of the UK cell: the graph's operations a step, with the
# RS decode one kernel
UK_STEP_OPS = 161
# stages whose span in the replayed graph is held to the eager range
TIMED_STAGES = ("rs_decode", "demap_deinterleave", "viterbi_decode")


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


@pytest.mark.parametrize("driver,unit,n,hier", [
    pytest.param("graph_step", "rs_decode", 2, False,
                 id="graph_step-rs_decode-2"),
    pytest.param("capture_passes", "block_rx", 2, False,
                 id="capture_passes-block_rx-2"),
    pytest.param("graph_step", "rs_decode", 2, True,
                 id="graph_step-rs_decode-2-hier")])
def test_window_on_the_cpu(driver, unit, n, hier, monkeypatch):
    ctx = small_ctx(driver, 2**31 + 21, hier)
    ctx.mix.update(trace_steps=n, trace_passes=n, capture_sets=1,
                   n_mux=1)
    summ = stage_window.window(ctx)
    # a call's row sums its spans: a hierarchical step's HP and LP decode
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
    from dvbt_tpu_torch.bench import GraphStep
    from dvbt_tpu_torch.utils.telemetry import Recorder

    from benchmark import trace as tr
    from benchmark.drivers import graph_step

    _, config, mix = run.cell(run.spec(), "uk_headend_8mux")
    dev = torch.device("cuda", 0)
    ctx = common.Context("uk_headend_8mux", config, mix, 11, 0.0, True,
                         dev)
    # plain graph, graph with a recorder, eager: each with its own state
    (eager_p, *st_p, _, n_pk, _), (eager_t, *st_t, _, _, _), \
        (eager, *st_e, _, _, _) = [graph_step.compose(ctx) for _ in range(3)]
    pool = graph_step.packet_pool(ctx, n_pk)
    rec = Recorder(dev)
    plain = GraphStep(eager_p, *st_p,
                      graph_step.static_packets(mix["n_mux"], n_pk, dev))
    timed = GraphStep(eager_t, *st_t,
                      graph_step.static_packets(mix["n_mux"], n_pk, dev),
                      telemetry=rec)
    assert timed.captured == {"byte_coder": 1, "viterbi_punct": 1,
                              "rs_decode": 1}

    def ops(step, st, n=3):
        with tr.profiled(dev) as h:
            for k in range(n):
                step(*st, pool[k])
        return len(h["trace"].program_ops()) / n

    for step, st in ((plain, st_p), (timed, st_t)):
        step(*st, pool[0])
    assert ops(plain, st_p) == UK_STEP_OPS
    assert ops(timed, st_t) == UK_STEP_OPS
    for k in range(5):
        timed(*st_t, pool[k])
        torch.cuda.synchronize(dev)
        rec.collect()
    summary = rec.summary()
    for k in range(2):
        eager(*st_e, pool[k])
    torch.cuda.synchronize(dev)
    with tr.profiled(dev) as h:
        for k in range(2):
            eager(*st_e, pool[k])
    ranges = h["trace"].range_us()
    # stage: (graph span ms, eager range ms), a step
    stages = {name: (summary[name]["device_ms"], ranges[name] / 2 / 1e3)
              for name in TIMED_STAGES}
    print(json.dumps({"stages": stages, "summary": summary}))
    assert all(graph == pytest.approx(eager_ms, rel=0.10)
               for graph, eager_ms in stages.values()), stages
