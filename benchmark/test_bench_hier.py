"""The hierarchical head-end cell ``hier_headend_8mux`` and its two readers.

On the CPU: ``graph_lp_decode_ms.txrx`` and ``graph_lp_code_ms.txrx`` from
a synthetic reading (the value, None for another kind, None without a
window); the cell found by name, with the configuration's two streams and
their packets a mux and step; and the telemetry window of the hierarchical
head-end at 2K, which holds the program's ``lp_decode``, ``lp_code`` and
``stream_mux`` stages.  On the card (``-m card``): the hierarchical
``GraphStep`` at the cell's size captures K1, K2 and the RS decoder twice
(once a stream), its TS are exact on both streams, a recorder adds no
operation to the graph, and its ``lp_decode`` and ``lp_code`` spans are
within 10% of the same stages in an eager trace in the same process (the
device time of the operations each stage's host range launched)."""

import json
import sys

import pytest
import torch

from benchmark import common, run, stage_window
from benchmark.reference import tx as reference
from benchmark.trace import Trace, union_us

CELL = "hier_headend_8mux"
# metric: stage of the recorder's summary it reads (device_ms)
READERS = {"graph_lp_decode_ms.txrx": "lp_decode",
           "graph_lp_code_ms.txrx": "lp_code"}
# the stages only a hierarchical step has
HIER_STAGES = ("lp_code", "stream_mux", "lp_decode")


def test_readers_are_declared_for_the_cell():
    declared = {m["name"]: m for m in run.spec()["per_layer"]}
    for name in READERS:
        m = declared[name]
        assert m["source"] == "program_span" and m["moves"] == "txrx_msps"
        assert m["workloads"] == [CELL]
    assert set(READERS) <= {m["name"] for m in
                            run.per_layer(run.spec(), CELL)}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_summary(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pytest"])
    stage = READERS[name]
    read = run.reader(name)
    row = {"device_ms": 1.5, "host_ms": 2.5, "self_device_ms": 0.5,
           "self_host_ms": 0.25, "calls": 3}
    assert read(None, {"kind": "txrx", "telemetry": {stage: row}}) == 1.5
    assert read(None, {"kind": "capture", "telemetry": {stage: row}}) \
        is None
    # a one-stream step's window has no such stage
    assert read(None, {"kind": "txrx",
                       "telemetry": {"rs_decode": row}}) is None
    assert read(None, {"kind": "txrx", "telemetry": None}) is None
    absent = {"kind": "txrx"}
    assert read(None, absent) is None and absent["telemetry"] is None


def test_cell_found_by_name():
    w, config, mix = run.cell(run.spec(), CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "hier_8k64qam_a2", "headend_8mux", 1)
    assert config["mode"] == {
        "transmission": "8k", "constellation": "64qam", "code_rate": "2/3",
        "guard": "1/32", "alpha": 2, "code_rate_lp": "3/4"}
    assert config["receiver"] == {"demap": "hard", "chan_est": "time",
                                  "metrics": "min"}
    assert config["checks"] == {"tx_err": 1e-3}
    conf = {c["name"]: c for c in run.spec()["configs"]}["hier_8k64qam_a2"]
    assert conf["reduced"] == []
    # one superframe a step: 1,344 HP and 3,024 LP packets a mux
    mode = reference.mode_from(config)
    assert [mode.packets_per_frame(i) * mix["frames"] for i in (0, 1)] \
        == [1344, 3024]
    assert (mix["n_mux"], mix["frames"]) == (8, 4)
    assert {m["name"] for m in run.end_to_end(run.spec(), CELL)} == {
        "txrx_msps", "setup_s"}


def _ctx_2k(seed: int) -> common.Context:
    """The cell's configuration at 2K, one mux, 8 frames a step (672 HP
    and 1,512 LP packets, whole energy-dispersal groups)."""
    _, config, mix = run.cell(run.spec(), CELL)
    config = dict(config, mode=dict(config["mode"], transmission="2k"))
    mix = dict(mix, n_mux=1, frames=8, trace_steps=2)
    return common.Context(CELL, config, mix, seed, 0.0, True,
                          torch.device("cpu"))


def test_window_on_the_cpu_holds_the_lp_stages():
    summ = stage_window.window(_ctx_2k(2**31 + 23))
    for name in HIER_STAGES:
        assert summ[name]["calls"] == 2
        assert summ[name]["host_ms"] > 0 and summ[name]["device_ms"] is None
    # a stage's row sums both streams' spans of it
    assert summ["viterbi_decode"]["host_ms"] > 0


def eager_stage_ms(trace, name: str, n_calls: int) -> float:
    """Device ms a call of stage ``name`` takes in an eager trace: the
    union of the device intervals of the operations launched while its
    host range was open.  (A range's own ``gpu_user_annotation`` covers
    only the operations outside its child ranges, and an outer stage such
    as ``lp_code`` launches none of its own.)"""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in trace.host
              if e["cat"] == "user_annotation" and e["name"] == name]
    launched = {e["args"]["correlation"] for e in trace.host
                if e["cat"] in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and any(s <= e["ts"] < t for s, t in ranges)}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in trace.device
             if e.get("args", {}).get("correlation") in launched]
    return union_us(spans) / n_calls / 1e3


def test_eager_stage_ms_reads_the_launches_of_a_range():
    """Two calls of a stage, each launching two operations; one launch
    outside it and one operation of another correlation."""
    host = [{"cat": "user_annotation", "name": "lp_code", "ts": 0, "dur": 10},
            {"cat": "user_annotation", "name": "lp_code", "ts": 20,
             "dur": 10}]
    host += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
              "dur": 1, "args": {"correlation": c}}
             for t, c in ((1, 1), (5, 2), (21, 3), (25, 4), (15, 5))]
    dev = [{"cat": "kernel", "name": "k", "ts": s, "dur": d,
            "args": {"correlation": c}}
           for s, d, c in ((100, 50, 1), (120, 50, 2), (300, 100, 3),
                           (400, 100, 4), (600, 1000, 5), (700, 10, 9))]
    trace = Trace(host + dev, 2000.0)
    assert eager_stage_ms(trace, "lp_code", 2) == pytest.approx(
        (70 + 200) / 2 / 1e3)
    assert eager_stage_ms(trace, "lp_decode", 2) == 0.0


@pytest.mark.card
def test_hier_graph_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dvbt_tpu_torch.bench import GraphStep
    from dvbt_tpu_torch.utils.telemetry import Recorder

    from benchmark import trace as tr
    from benchmark.drivers import graph_step

    _, config, mix = run.cell(run.spec(), CELL)
    dev = torch.device("cuda", 0)
    ctx = common.Context(CELL, config, mix, 4000000019, 0.0, True, dev)
    # plain graph, graph with a recorder, eager: each with its own state
    (eager_p, *st_p, _, n_pk, _), (eager_t, *st_t, _, _, _), \
        (eager, *st_e, _, _, _) = [graph_step.compose(ctx) for _ in range(3)]
    assert n_pk == (1344, 3024)
    pool = graph_step.packet_pool(ctx, n_pk)
    rec = Recorder(dev)
    plain = GraphStep(eager_p, *st_p,
                      graph_step.static_packets(mix["n_mux"], n_pk, dev))
    timed = GraphStep(eager_t, *st_t,
                      graph_step.static_packets(mix["n_mux"], n_pk, dev),
                      telemetry=rec)
    twice = {"byte_coder": 2, "viterbi_punct": 2, "rs_decode": 2}
    assert plain.captured == twice and timed.captured == twice

    check = graph_step._Checker(pool)
    for k in range(6):
        _, _, ts, bad = plain(*st_p, pool[k])
        if k:
            check(k, ts, bad)
    torch.cuda.synchronize(dev)
    assert check.acc.tolist() == [0, 0, 0]

    def ops(step, st, n=3):
        with tr.profiled(dev) as h:
            for k in range(n):
                step(*st, pool[k])
        return len(h["trace"].program_ops()) / n

    timed(*st_t, pool[0])
    n_ops = ops(plain, st_p)
    assert ops(timed, st_t) == n_ops
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
    # stage: (graph span ms, eager ms), a step
    stages = {name: (summary[name]["device_ms"],
                     eager_stage_ms(h["trace"], name, 2))
              for name in HIER_STAGES}
    # each stage's device ms a step, the LP stream's (inside lp_code and
    # lp_decode) apart as "<stage>.lp"
    by_stream: dict = {}
    for sp in rec.spans:
        if sp.parent is not None:
            lp = rec.spans[sp.parent].name in ("lp_code", "lp_decode")
            key = sp.name + (".lp" if lp else "")
            by_stream[key] = by_stream.get(key, 0.0) + sp.device_ms / 5
    print(json.dumps({"step_ops": n_ops, "stages": stages,
                      "by_stream": by_stream, "summary": summary}))
    assert all(stages[name][0] == pytest.approx(stages[name][1], rel=0.10)
               for name in READERS.values()), stages
