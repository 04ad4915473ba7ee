"""Whole runs of each driver on the CPU at 2K, sound and with a fault
planted under the timed path: ``correct`` has to come out true, then
false; the head-end driver also in a hierarchical mode (HP and LP
streams).  The harness's look for a card is skipped; the rest is the
run."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import common, control, faults
from benchmark.drivers import capture_passes, graph_step, stream_feeder

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = {"graph_step": graph_step, "stream_feeder": stream_feeder,
           "capture_passes": capture_passes}
SMALL = {"graph_step": ("headend_8mux", {"n_mux": 2, "frames": 8}),
         "stream_feeder": ("stream_1mux", {"noise_copies": 2,
                                           "warm_blocks": 2}),
         "capture_passes": ("capture_8mux", {"n_mux": 2, "capture_sets": 2,
                                             "warm_passes": 1})}
# the hierarchical head-end: 16 frames a step, so that each stream's
# packets (1,008 HP, 1,512 LP) are whole energy-dispersal groups
HIER_MODE = {"transmission": "2k", "constellation": "16qam",
             "code_rate": "1/2", "guard": "1/32", "alpha": 2,
             "code_rate_lp": "3/4"}
HIER_FRAMES = 16


def small_ctx(driver: str, seed: int, hier: bool = False) -> common.Context:
    cfg = json.loads((ROOT / "benchmark/configs/uk_8k64qam23.json")
                     .read_text())
    cfg["mode"] = {"transmission": "2k", "constellation": "qpsk",
                   "code_rate": "1/2", "guard": "1/32", "alpha": 0,
                   "code_rate_lp": "1/2"}
    name, small = SMALL[driver]
    mix = json.loads((ROOT / f"benchmark/traffic/{name}.json").read_text())
    mix.update(small)
    if hier:
        cfg["mode"] = dict(HIER_MODE)
        mix["frames"] = HIER_FRAMES
    return common.Context(driver, cfg, mix, seed, 0.5, False,
                          torch.device("cpu"))


def _id(driver, hier, *rest):
    return "-".join([driver, *rest] + (["hier"] if hier else []))


SOUND = [(d, False) for d in sorted(DRIVERS)] + [("graph_step", True)]
FAULTY = [(d, f, False) for d in sorted(faults.FAULTS)
          for f in faults.FAULTS[d]] + [
    ("graph_step", f, True) for f in faults.FAULTS["graph_step"]]


@pytest.mark.parametrize("driver,hier", [
    pytest.param(d, h, id=_id(d, h)) for d, h in SOUND])
def test_sound_run_is_correct(driver, hier):
    res = DRIVERS[driver].run(small_ctx(driver, 2**31 + 11, hier))
    assert all(c.ok for c in res["checks"]), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("driver,fault,hier", [
    pytest.param(d, f, h, id=_id(d, h, f)) for d, f, h in FAULTY])
def test_fault_is_not_correct(driver, fault, hier):
    ctx = small_ctx(driver, 2**31 + 12, hier)
    try:
        with faults.planted(driver, fault, ctx):
            res = DRIVERS[driver].run(ctx)
    except RuntimeError as e:       # a stream that never locks
        assert "no lock" in str(e)
        return
    assert not all(c.ok for c in res["checks"])


@pytest.mark.parametrize("seed,hier", [
    pytest.param(seed, hier, id=_id(str(seed), hier)) for seed, hier in
    ((1, False), (2**31 + 3, False), (2**33 + 5, False), (2**31 + 3, True))])
def test_headend_control_fails_the_limit(seed, hier):
    ctx = small_ctx("graph_step", seed, hier)
    out = control.read(ctx, "control")
    assert out["fault"] == "ref_bf16" and not out["correct"]
    assert out["checks"]["tx_err"] > ctx.config["checks"]["tx_err"]
    assert out["checks"]["ts_bad_packets"] == 0


def test_pair_faults_touch_their_streams():
    """On a (HP, LP) pair ``altered`` changes one byte of the LP stream
    alone, so its run fails only if the LP stream is checked;
    ``half_batch`` halves both."""
    hp = torch.full((4, 16, 188), 7, dtype=torch.uint8)
    lp = torch.full((4, 24, 188), 9, dtype=torch.uint8)
    a_hp, a_lp = faults._alter((hp, lp))
    assert torch.equal(a_hp, hp) and int((a_lp != lp).sum()) == 1
    h_hp, h_lp = faults._halve((hp, lp))
    assert not h_hp[2:].any() and not h_lp[2:].any()
    assert torch.equal(h_hp[:2], hp[:2]) and torch.equal(h_lp[:2], lp[:2])


@pytest.mark.parametrize("hier", [False, True], ids=["single", "hier"])
def test_traced_reading(hier, monkeypatch):
    """The traced run's reading: a single stream's keys and values as the
    readers have always read them, two streams under ``streams``, HP
    first.  The device calls of the traced path do nothing here."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    ctx = small_ctx("graph_step", 2**31 + 15, hier)
    ctx.trace = True
    ctx.mix.update(trace_steps=2, eager_steps=1)
    res = graph_step.run(ctx)
    assert all(c.ok for c in res["checks"]), res["checks"]
    reading = res["reading"]
    assert isinstance(reading.pop("ranges"), dict)      # measured times
    shape = ({"streams": [[1008, "1/2"], [1512, "3/4"]]} if hier
             else {"n_packets": 504, "code_rate": "1/2"})
    assert reading == {"kind": "txrx", "units": 2, "n_mux": 2, **shape}


@pytest.mark.parametrize("driver,reading", [
    (d, f) for d in sorted(faults.READINGS) for f in faults.READINGS[d]])
def test_reading_runs_the_whole_cell(driver, reading):
    ctx = small_ctx(driver, 2**31 + 13)
    out = control.read(ctx, reading)
    assert out["fault"] == reading
    assert set(out["checks"]) == set(out["limits"])
