"""The port's validation tools (``dvbt_tpu_torch.tools``) against the
repo's JAX tools and their records, on the CPU at 2K.

- ``mode_grid_hw.run_mode`` returns the JAX tool's dict (but for
  ``wall_s``) and the same TS bytes of each stream, at GI 1/4, rate 7/8
  and the alpha=4 hierarchical mode.
- ``GRID`` names the modes of docs/MODE_GRID_HW.json in its order;
  ``ber_curves.CURVES`` holds every docs/ber_*.jsonl curve with its SNR
  points and block count, and ``ber_hw.POINTS`` lie on them.  (The copies
  of the JAX tools' lists are held equal to them in test_torch_isolation.)
- The limit rule, ``ber_curves.judge``, on made-up samples; and through
  the port on the CPU: it accepts 8 seeds of 2K QPSK 1/2 hard at 5 dB
  and rejects the same chain 0.25 dB lower.
- Each tool's main: without a card it exits nonzero; with fakes for the
  chain, what it writes and its exit code.

``tools/`` has no ``__init__.py``: its scripts are loaded by path."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dvbt_tpu.mode import DvbtMode as JMode
from dvbt_tpu.models import rx as j_rx
from dvbt_tpu_torch.apps import ber_sweep as t_ber
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.tools import ber_curves, ber_hw, mode_grid_hw
from dvbt_tpu_torch.utils.streams import split
from test_torch_isolation import jax_tool

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs")


def _recording(monkeypatch, rx_module, outs):
    """Wrap rx_module.make_receiver so that each TS its receiver returns is
    appended to ``outs``."""
    make = rx_module.make_receiver

    def make_recording(*args, **kwargs):
        rx, n_pk, n_samples = make(*args, **kwargs)

        def rx_recording(state, iq):
            state, ts, m = rx(state, iq)
            outs.append(ts)
            return state, ts, m
        return rx_recording, n_pk, n_samples

    monkeypatch.setattr(rx_module, "make_receiver", make_recording)


@pytest.mark.parametrize("name", ["2k_qpsk_78", "2k_64qam_23_g14",
                                  "2k_16qam_a4_hier"])
def test_run_mode_matches_the_jax_tool(name, monkeypatch):
    mode = dict(mode_grid_hw.GRID)[name]
    hier = mode.hierarchical
    j_outs, t_outs = [], []
    _recording(monkeypatch, j_rx, j_outs)
    _recording(monkeypatch, t_rx, t_outs)
    want = jax_tool("mode_grid_hw").run_mode(
        JMode(**dataclasses.asdict(mode)))
    got = mode_grid_hw.run_mode(mode, "cpu")
    assert got.pop("wall_s") >= 0 and want.pop("wall_s") >= 0
    assert got == want
    assert got["byte_exact"] and got["rs_corrected"] == 0
    assert len(t_outs) == len(j_outs) == 2
    for j_ts, t_ts in zip(j_outs, t_outs):
        j_streams = split(j_ts, hier)
        t_streams = split(t_ts, hier)
        assert len(j_streams) == len(t_streams) == (2 if hier else 1)
        for j_s, t_s in zip(j_streams, t_streams):
            assert np.array_equal(t_s[0].numpy(), np.asarray(j_s))


def test_grid_names_the_jax_artifact_modes_in_order():
    with open(os.path.join(DOCS, "MODE_GRID_HW.json")) as f:
        want = list(json.load(f)["results"])
    assert [name for name, _ in mode_grid_hw.GRID] == want
    assert len(want) == 25


def _docs_stems() -> list[str]:
    return sorted(f[len("ber_"):-len(".jsonl")] for f in os.listdir(DOCS)
                  if f.startswith("ber_") and f.endswith(".jsonl"))


def test_curves_cover_every_docs_curve():
    stems = [c[0] for c in ber_curves.CURVES]
    assert len(stems) == len(set(stems)) == 20
    assert sorted(stems) == _docs_stems()
    assert sum(len(c[4]) for c in ber_curves.CURVES) == 132


@pytest.mark.parametrize("curve", ber_curves.CURVES, ids=lambda c: c[0])
def test_curve_snrs_and_blocks_equal_the_docs_file(curve):
    """The SNR list is the file's points in order; the blocks give the
    file's packet counts (the 11-packet delay off each stream)."""
    stem, mode, demap, profile, snrs, blocks = curve
    ref = ber_curves.reference(stem)
    assert list(ref) == [float(s) for s in snrs]
    for line in ref.values():
        assert line["demap"] == demap
        assert line.get("profile", "none") == (profile or "none")
        for stream, pre in zip(mode.streams, ("", "lp_")):
            assert line[f"{pre}packets"] == \
                blocks * mode.stream_packets_per_block(stream) - 11


def test_ber_hw_points_lie_on_their_curves():
    curves = {c[0]: c for c in ber_curves.CURVES}
    for args, snr, blocks, demap, profile, fname in ber_hw.POINTS:
        stem, mode, c_demap, c_profile, snrs, c_blocks = \
            curves[fname[len("ber_"):-len(".jsonl")]]
        assert dataclasses.astuple(mode)[:4] == args
        assert (c_demap, c_profile, c_blocks) == (demap, profile, blocks)
        assert snr in snrs


def _runs(key, values, per=0.0):
    return [{key: v, "per": per, "lp_per": per} for v in values]


@pytest.mark.parametrize("ref,runs,ok", [
    # J null: pooled per >= 0.99
    ({"ber_post_viterbi": None, "per": 1.0},
     _runs("ber_post_viterbi", [None, None], per=1.0), True),
    ({"ber_post_viterbi": None, "per": 1.0},
     _runs("ber_post_viterbi", [0.01, 0.01], per=0.98), False),
    # J 0: pooled per <= 0.005
    ({"ber_post_viterbi": 0.0, "per": 0.0},
     _runs("ber_post_viterbi", [1e-6, 0.0], per=0.004), True),
    ({"ber_post_viterbi": 0.0, "per": 0.0},
     _runs("ber_post_viterbi", [1e-6, 0.0], per=0.01), False),
    # the spread test on ber_post_viterbi: 4.5 sigma sqrt(1 + 1/S) ...
    ({"ber_post_viterbi": 1e-3, "per": 0.0},
     _runs("ber_post_viterbi", [0.7e-3, 0.9e-3, 0.5e-3, 0.7e-3]), True),
    ({"ber_post_viterbi": 1e-3, "per": 0.0},
     _runs("ber_post_viterbi", [0.5e-3, 0.52e-3, 0.48e-3, 0.5e-3]), False),
    # ... never tighter than 15% of J
    ({"ber_post_viterbi": 1e-3, "per": 0.0},
     _runs("ber_post_viterbi", [0.86e-3, 0.86e-3, 0.86e-3]), True),
    ({"ber_post_viterbi": 1e-3, "per": 0.0},
     _runs("ber_post_viterbi", [0.84e-3, 0.84e-3, 0.84e-3]), False),
    # a seed with no correctable packet fails the point
    ({"ber_post_viterbi": 1e-3, "per": 0.5},
     _runs("ber_post_viterbi", [1e-3, None, 1e-3], per=0.5), False),
])
def test_judge(ref, runs, ok):
    assert ber_curves.judge(ref, runs)["pass"] is ok


def test_judge_reads_per_on_the_cliff():
    """Where the curve's per is >= CLIFF_PER, the spread test takes per:
    a seed without a correctable packet does not fail the point."""
    ref = {"ber_post_viterbi": 0.013, "per": 0.98}
    runs = [{"ber_post_viterbi": b, "per": p}
            for b, p in ((0.014, 0.97), (None, 1.0), (0.012, 0.99))]
    got = ber_curves.judge(ref, runs)
    assert got["check"] == "per" and got["pass"]
    runs = [{"ber_post_viterbi": 0.013, "per": 0.7}] * 3
    assert not ber_curves.judge(ref, runs)["pass"]


def test_check_point_holds_both_streams():
    ref = {"ber_post_viterbi": 0.0, "per": 0.0,
           "lp_ber_post_viterbi": None, "lp_per": 1.0}
    runs = [{"ber_post_viterbi": 0.0, "per": 0.0,
             "lp_ber_post_viterbi": None, "lp_per": lp} for lp in (1.0, 0.9)]
    got = ber_curves.check_point(ref, runs, hier=True)
    assert set(got) == {"pass", "hp", "lp"}
    assert got["hp"]["pass"] and not got["lp"]["pass"] and not got["pass"]
    assert set(ber_curves.check_point(ref, runs, hier=False)) == \
        {"pass", "hp"}


def test_rule_accepts_the_seeds_and_rejects_a_quarter_db_fault():
    """2K QPSK 1/2 hard at 5 dB through the port on the CPU, as many seeds
    as chip_smoke.py's (8) of the curve's 8 blocks: within the rule of
    docs/ber_2k_qpsk_12_hard; the same chain FAULT_DB lower is not.  (With
    4 seeds the fault's own spread lets it pass.)"""
    stem, mode, demap, profile, _, blocks = ber_curves.CURVES[0]
    assert stem == "2k_qpsk_12_hard"
    curve = (stem, mode, demap, profile, [5], blocks)
    seeds = range(8)
    (ok,) = ber_curves.run_curve(curve, "cpu", seeds)
    (bad,) = ber_curves.run_curve(curve, "cpu", seeds,
                                  shift_db=-ber_curves.FAULT_DB)
    assert ok["pass"] and ok["hp"]["check"] == "ber_post_viterbi", ok
    assert not bad["pass"], bad
    assert bad["hp"]["mean"] > ok["hp"]["mean"] + ok["hp"]["limit"]


@pytest.mark.parametrize("main", [mode_grid_hw.main, ber_hw.main,
                                  ber_curves.main],
                         ids=["mode_grid_hw", "ber_hw", "ber_curves"])
def test_without_a_card_exits_nonzero(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mode_grid_hw, "run_mode", None)  # fail if reached
    monkeypatch.setattr(t_ber, "run_point", None)
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("raises", [None, "8k_64qam_78"])
def test_mode_grid_main_writes_the_artifact(raises, monkeypatch, tmp_path):
    """Every mode's result under its name, the green count; a mode that
    raises is recorded, not green, and the run exits nonzero."""
    modes = dict((m, n) for n, m in mode_grid_hw.GRID)

    def run_mode(mode, device):
        if modes[mode] == raises:
            raise RuntimeError("planted")
        return {"byte_exact": True, "rs_uncorrectable": 0,
                "rs_corrected": 0, "wall_s": 0.0}

    monkeypatch.setattr(mode_grid_hw, "run_mode", run_mode)
    out = tmp_path / "grid.json"
    rc = mode_grid_hw.main(["--device", "cpu", "--out", str(out)])
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and art["modes_total"] == 25
    assert list(art["results"]) == [n for n, _ in mode_grid_hw.GRID]
    if raises:
        assert rc == 1 and art["modes_green"] == 24
        assert "planted" in art["results"][raises]["error"]
    else:
        assert rc == 0 and art["modes_green"] == 25


def _fake_run_point(scale=1.0):
    """A stand-in for apps.ber_sweep.run_point: the JAX curve's line at the
    nearest SNR, its ber_post_viterbi times ``scale``, a 1% spread over
    seeds and a factor 2 for each 0.25 dB below the point; the other demap
    a tenth."""
    stems = {(c[1], c[2], c[3]): c[0] for c in ber_curves.CURVES}

    def run_point(mode, snr, blocks, seed, demap, profile, device):
        stem = stems.get((mode, demap, profile))
        other = stem is None
        if other:
            stem = stems[(mode, "soft" if demap == "hard" else "hard",
                          profile)]
        ref = ber_curves.reference(stem)
        at = min(ref, key=lambda s: abs(s - snr))
        spread = 0.01 * (seed - (ber_curves.SEEDS - 1) / 2)
        f = scale * (1 + spread) * 2 ** ((at - snr) / 0.25)
        f *= 0.1 if other else 1.0
        return {k: v * f if k.endswith("ber_post_viterbi") and v else v
                for k, v in ref[at].items()}
    return run_point


@pytest.mark.parametrize("scale,rc", [(1.0, 0), (1.5, 1)])
def test_ber_curves_main_writes_the_artifact(scale, rc, monkeypatch,
                                             tmp_path):
    monkeypatch.setattr(t_ber, "run_point", _fake_run_point(scale))
    out = tmp_path / "ber.json"
    assert ber_curves.main(["--device", "cpu", "--out", str(out)]) == rc
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and art["seeds"] == ber_curves.SEEDS
    assert (art["points_total"], art["streams_total"]) == (132, 151)
    assert list(art["curves"]) == [c[0] for c in ber_curves.CURVES]
    assert (art["points_passed"] == 132) is (rc == 0)
    assert set(art["planted"]) == set(ber_curves.FAULT_CURVES)
    for faults in art["planted"].values():
        assert len(faults) == 2
        assert all(0 < f["failed"] <= f["of"] for f in faults.values())


def test_ber_hw_main_appends_tagged_lines(monkeypatch, tmp_path):
    monkeypatch.setattr(t_ber, "run_point", _fake_run_point())
    out = tmp_path / "hw.jsonl"
    out.write_text('{"kept": true}\n')
    assert ber_hw.main(["--device", "cpu", "--out", str(out)]) == 0
    lines = [json.loads(s) for s in out.read_text().splitlines()]
    assert lines[0] == {"kept": True} and len(lines) == 5
    assert [line["curve"] for line in lines[1:]] == \
        [p[5] for p in ber_hw.POINTS]
    assert all(line["card"] == "cpu" and line["pass"]
               and line["seeds"] == ber_curves.SEEDS for line in lines[1:])
