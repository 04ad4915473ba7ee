"""The port's BER sweep (``python3 -m dvbt_tpu_torch.apps.ber_sweep``) on
the CPU: a hard 2K point against the JAX package's curve in docs/, and its
JSON line against the JAX app's.  The noise is the port's own (a
``torch.Generator``), so a point agrees with the JAX curve statistically:
at 5 dB the post-Viterbi BER of 493 packets (~800,000 bits) carries a few
percent of spread; the test holds 25%."""

import json
import os

import numpy as np
import pytest
import torch

from dvbt_tpu.apps import ber_sweep as j_ber
from dvbt_tpu_torch import MODE_2K_QPSK
from dvbt_tpu_torch.apps import ber_sweep as t_ber
from dvbt_tpu_torch.apps import common as t_common
from dvbt_tpu_torch.mode import DvbtMode

torch.set_num_threads(1)

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs")
# docs/ber_2k_qpsk_12_hard.jsonl at 5 dB
REF_5DB = 0.0026075846159965


def _doc_line(name: str, snr: float) -> dict:
    with open(os.path.join(DOCS, f"{name}.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if d["snr_db"] == snr:
                return d
    raise KeyError(snr)


def test_hard_point_matches_docs_curve():
    """2K QPSK 1/2, 8 blocks at 5 dB: post-Viterbi BER within 25% of the
    JAX package's curve, no uncorrectable packet, the TS byte-exact."""
    assert _doc_line("ber_2k_qpsk_12_hard", 5.0)["ber_post_viterbi"] == \
        REF_5DB
    r = t_ber.run_point(MODE_2K_QPSK, 5.0, 8, device="cpu")
    assert r["device"] == "cpu" and r["packets"] == 8 * 63 - 11
    assert abs(r["ber_post_viterbi"] / REF_5DB - 1) < 0.25, r
    assert r["per"] == 0.0 and r["ber_post_rs"] == 0.0


def test_json_line_keys_match_jax_app(capsys):
    """The port's main prints the JAX app's keys, for one stream and two
    (the latter against a line of the JAX app's in docs/)."""
    argv = ["-t", "2k", "--snrs", "7", "--blocks", "1", "--profile", "F1"]
    assert j_ber.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_ber.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    assert got["device"] == want["device"] == "cpu"
    assert (got["demap"], got["profile"]) == ("hard", "F1")
    assert t_ber.main(["-t", "2k", "-c", "16qam", "--alpha", "2",
                       "--rate-lp", "3/4", "--demap", "soft", "--snrs", "6",
                       "--blocks", "1", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(_doc_line("ber_2k_16qam_hier_a2_soft", 6.0))


def test_without_a_card_exits_nonzero(monkeypatch):
    """The default device is the card; without one main exits nonzero
    and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(t_ber, "run_point", None)   # would fail if reached
    with pytest.raises(SystemExit) as e:
        t_ber.main(["-t", "2k", "--snrs", "5", "--blocks", "1"])
    assert e.value.code not in (0, None)


def test_mode_flags_match_jax_app():
    """common.py's flags give the JAX app's modes (the port's own
    DvbtMode)."""
    import argparse

    from dvbt_tpu.apps import common as j_common

    for argv in ([], ["-t", "8k", "-c", "64qam", "-r", "2/3"],
                 ["-c", "16qam", "--alpha", "2", "--rate-lp", "3/4", "-g",
                  "1/8", "--cell-id", "7"]):
        pt, pj = argparse.ArgumentParser(), argparse.ArgumentParser()
        t_common.add_mode_args(pt)
        j_common.add_mode_args(pj)
        mt = t_common.mode_from_args(pt.parse_args(argv))
        mj = j_common.mode_from_args(pj.parse_args(argv))
        assert isinstance(mt, DvbtMode)
        assert mt == DvbtMode(mj.transmission, mj.constellation,
                              mj.code_rate, mj.guard, mj.alpha,
                              mj.code_rate_lp, mj.cell_id)


def test_run_point_reuses_its_chain():
    """One tx/rx pair per (mode, demap, device) across SNR points."""
    t_ber._build.cache_clear()
    for snr in (9.0, 10.0):
        r = t_ber.run_point(MODE_2K_QPSK, snr, 1, demap="soft",
                            device="cpu")
        assert r["per"] == 0.0
    info = t_ber._build.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    assert np.isfinite(r["snr_db"])
