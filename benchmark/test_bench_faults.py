"""Whole runs of each driver on the CPU at 2K, sound and with a fault
planted under the timed path: ``correct`` has to come out true, then
false.  The harness's look for a card is skipped; the rest is the run."""

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


def small_ctx(driver: str, seed: int) -> common.Context:
    cfg = json.loads((ROOT / "benchmark/configs/uk_8k64qam23.json")
                     .read_text())
    cfg["mode"] = {"transmission": "2k", "constellation": "qpsk",
                   "code_rate": "1/2", "guard": "1/32", "alpha": 0,
                   "code_rate_lp": "1/2"}
    name, small = SMALL[driver]
    mix = json.loads((ROOT / f"benchmark/traffic/{name}.json").read_text())
    mix.update(small)
    return common.Context(driver, cfg, mix, seed, 0.5, False,
                          torch.device("cpu"))


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_sound_run_is_correct(driver):
    res = DRIVERS[driver].run(small_ctx(driver, 2**31 + 11))
    assert all(c.ok for c in res["checks"]), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("driver,fault", [
    (d, f) for d in sorted(faults.FAULTS) for f in faults.FAULTS[d]])
def test_fault_is_not_correct(driver, fault):
    ctx = small_ctx(driver, 2**31 + 12)
    try:
        with faults.planted(driver, fault, ctx):
            res = DRIVERS[driver].run(ctx)
    except RuntimeError as e:       # a stream that never locks
        assert "no lock" in str(e)
        return
    assert not all(c.ok for c in res["checks"])


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**33 + 5])
def test_headend_control_fails_the_limit(seed):
    ctx = small_ctx("graph_step", seed)
    out = control.read(ctx, "control")
    assert out["fault"] == "ref_bf16" and not out["correct"]
    assert out["checks"]["tx_err"] > ctx.config["checks"]["tx_err"]
    assert out["checks"]["ts_bad_packets"] == 0


@pytest.mark.parametrize("driver,reading", [
    (d, f) for d in sorted(faults.READINGS) for f in faults.READINGS[d]])
def test_reading_runs_the_whole_cell(driver, reading):
    ctx = small_ctx(driver, 2**31 + 13)
    out = control.read(ctx, reading)
    assert out["fault"] == reading
    assert set(out["checks"]) == set(out["limits"])
