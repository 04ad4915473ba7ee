"""The harness's arithmetic on made-up inputs: interval unions, device
time inside ranges, idle gaps, block latencies and their p95, and the
roofline counts from shapes."""

import types

import numpy as np
import pytest

from benchmark import roofline, run, trace
from benchmark.drivers import stream_feeder


def test_union_and_inside():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert trace.union_us(spans) == 12 + 10 + 1
    assert trace.merged(spans) == [[0, 12], [20, 30], [40, 41]]
    assert trace.inside_us(spans, 8, 22) == 4 + 2
    assert trace.union_us([]) == 0


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_ranges_ops_and_gaps():
    events = [
        _ev("kernel", "k1", 0, 10), _ev("kernel", "k2", 10, 5),
        _ev("gpu_memcpy", "Memcpy HtoD", 30, 4),
        _ev("kernel", "cmp", 50, 2),
        _ev("gpu_user_annotation", "rs_decode", 0, 12),
        _ev("gpu_user_annotation", "rs_decode", 30, 4),
        _ev("gpu_user_annotation", "bench.check", 49, 5),
        _ev("cpu_op", "feed", 0, 100), _ev("cuda_runtime", "sync", 16, 10),
    ]
    t = trace.Trace(events, wall_us=100.0)
    assert t.busy_us() == 21
    assert t.range_us()["rs_decode"] == 12 + 4
    assert [e["name"] for e in t.program_ops()] == ["k1", "k2",
                                                    "Memcpy HtoD"]
    assert t.memcpy_us("HtoD") == 4
    gaps = t.idle_gaps()
    assert gaps[0] == ["feed", 16e-6]       # 34 -> 50
    assert gaps[1] == ["sync", 15e-6]       # 15 -> 30
    assert t.top_ops(1) == [["k1", 10e-6]]


def test_block_latencies_and_p95():
    block = 100
    handed = {j: float(j) for j in range(10)}
    got = [(250, 7.5), (350, 8.0), (450, 9.25), (40, 3.0)]
    lat = stream_feeder.block_latencies(got, handed, block, first=3)
    assert lat == [7.5 - 3, 8.0 - 4, 9.25 - 5]
    many = list(np.arange(1, 101) / 1000)
    assert np.percentile(many, 95) == pytest.approx(0.09505)


def test_tally_checks_each_report_as_it_returns():
    rng = np.random.default_rng(5)
    packets = rng.integers(0, 256, (10, 188), dtype=np.uint8)
    order = np.arange(7, 7 + 30) % 10
    tally = stream_feeder.Tally(packets)

    def report(rows, offset, rs=0, reacquired=False):
        return types.SimpleNamespace(
            packets=packets[rows].copy(), stream_offset=offset,
            rs_uncorrectable=np.array([rs]), reacquired=reacquired)

    tally.add(report(order[:12], 0), 1.0)
    bad = report(order[12:24], 100, rs=2)
    bad.packets[3, 9] ^= 1
    bad.packets[5, 0] ^= 4
    tally.add(bad, 2.0)
    tally.add(report(order[24:30], 200, reacquired=True), 3.0)
    assert (tally.ts_bad, tally.rs_bad, tally.relocks, tally.failed) == \
        (2, 2, 1, 2)
    assert tally.got == [(0, 1.0), (100, 2.0), (200, 3.0)]
    lost = stream_feeder.Tally(packets)
    lost.add(types.SimpleNamespace(
        packets=np.zeros((4, 188), np.uint8), stream_offset=0,
        rs_uncorrectable=np.zeros(1), reacquired=False), 0.0)
    assert lost.ts_bad == 4


def test_roofline_counts_from_shapes():
    # 8 muxes x 4,032 packets: 52,641,792 trellis steps x 64 x 3
    # operations at 4 x 132 x 128 x 1.98 GHz
    n_bits = 8 * 4032 * 204 * 8
    t = roofline.viterbi_bound_s(8, 4032, "2/3")
    assert t == pytest.approx(n_bits * 64 * 3 / (4 * 132 * 128 * 1.98e9))
    assert t > (n_bits * 1.5 + n_bits / 8) / 3.35e12
    assert roofline.rs_decode_bound_s(8, 4032) == pytest.approx(
        8 * 4032 * 392 / 3.35e12)
    assert roofline.viterbi_bound_s(8, 2688, "2/3") == pytest.approx(
        t * 2 / 3)


@pytest.mark.parametrize("n_packets", [4032, 2688], ids=["uk", "de"])
def test_roofline_of_one_stream_reads_as_before(n_packets):
    """A reading without ``streams`` (every non-hierarchical cell) gives
    exactly the shares its one stream's bounds give."""
    r = {"kind": "txrx", "n_mux": 8, "n_packets": n_packets,
         "code_rate": "2/3",
         "ranges": {"viterbi_decode": 1500.0, "rs_decode": 17.6}}
    assert roofline.streams(r) == [[n_packets, "2/3"]]
    info_bits = 8 * n_packets * 204 * 8
    assert roofline.viterbi_bound_s(8, n_packets, "2/3") == \
        info_bits * 64 * 3 / (4 * 132 * 128 * 1.98e9)
    assert roofline.rs_decode_bound_s(8, n_packets) == \
        8 * n_packets * 392 / 3.35e12
    assert run.reader("viterbi_roofline.txrx")(None, r) == \
        100.0 * roofline.viterbi_bound_s(8, n_packets, "2/3") / 1.5e-3
    assert run.reader("rs_decode_roofline.txrx")(None, r) == \
        100.0 * roofline.rs_decode_bound_s(8, n_packets) / (17.6 / 1e6)


def test_roofline_of_two_streams_sums_them():
    """A hierarchical reading (the 8K alpha = 2 deployment's shapes: HP
    1,344 packets at 2/3, LP 3,024 at 3/4): each bound is the sum of its
    streams'."""
    r = {"kind": "txrx", "n_mux": 8, "streams": [[1344, "2/3"],
                                                 [3024, "3/4"]],
         "ranges": {"viterbi_decode": 1500.0, "rs_decode": 17.6}}
    vit = roofline.viterbi_bound_s(8, 1344, "2/3") + \
        roofline.viterbi_bound_s(8, 3024, "3/4")
    rs = roofline.rs_decode_bound_s(8, 1344) + \
        roofline.rs_decode_bound_s(8, 3024)
    assert run.reader("viterbi_roofline.txrx")(None, r) == pytest.approx(
        100 * vit / 1.5e-3)
    assert run.reader("rs_decode_roofline.txrx")(None, r) == pytest.approx(
        100 * rs / 17.6e-6)
    # each stream's Viterbi is bound by its operations, so the sum is the
    # bound of the two together
    assert vit == pytest.approx(8 * (1344 + 3024) * 204 * 8 * 64 * 3
                                / (4 * 132 * 128 * 1.98e9))


def test_readers_from_a_trace_and_a_reading():
    events = [_ev("kernel", "k", 10 * i, 5) for i in range(40)]
    events += [_ev("gpu_memcpy", "Memcpy HtoD", 400, 50),
               _ev("kernel", "cmp", 460, 2),
               _ev("gpu_user_annotation", "bench.check", 455, 10)]
    t = trace.Trace(events, wall_us=1000.0)
    r = {"kind": "txrx", "units": 20, "n_mux": 8, "n_packets": 4032,
         "code_rate": "2/3",
         "ranges": {"viterbi_decode": 1500.0, "rs_decode": 11300.0,
                    "demap_deinterleave": 2450.0}}
    assert run.reader("idle_share.txrx")(t, r) == pytest.approx(
        1 - (200 + 50 + 2) / 1000)
    assert run.reader("idle_share.capture")(t, r) is None
    assert run.reader("step_ops.txrx")(t, r) == 41 / 20
    assert run.reader("demap_ms.txrx")(t, r) == pytest.approx(2.45)
    assert run.reader("viterbi_roofline.txrx")(t, r) == pytest.approx(
        100 * roofline.viterbi_bound_s(8, 4032, "2/3") / 1.5e-3)
    assert run.reader("rs_decode_roofline.txrx")(t, r) == pytest.approx(
        100 * roofline.rs_decode_bound_s(8, 4032) / 11.3e-3)
    del r["ranges"]["viterbi_decode"]
    assert run.reader("viterbi_roofline.txrx")(t, r) is None
    assert run.reader("idle_share.txrx")(None, r) is None
    c = {"kind": "capture", "units": 5, "ranges": {"synchronizer": 22400.0}}
    assert run.reader("sync_ms.capture")(t, c) == pytest.approx(22.4)
    assert run.reader("idle_share.capture")(t, c) == pytest.approx(0.748)
    assert run.reader("step_ops.txrx")(t, c) is None
