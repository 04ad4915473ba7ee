"""The port's TPS-driven mode detection (models/auto.py) against the JAX
package on the CPU, as tests/test_auto.py holds the JAX package's: every
guard is picked as JAX picks it, with its scores; the hierarchical
detect_mode; noise is rejected; and AutoStreamingReceiver, told only
"2k", decodes a 2K 64-QAM 2/3 capture byte-exact with JAX's reports."""

import functools

import jax
import numpy as np
import pytest
import torch

from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import DvbtMode
from dvbt_tpu.models import auto as j_auto
from dvbt_tpu.models import channel as j_channel
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu_torch.models import auto as t_auto
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

CPU = torch.device("cpu")
DELAY = 11
# the guard scores are ratios of complex64/float32 running sums over ~46k
# samples; the two frameworks' scans round differently
SCORE_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def _tx_stream(mode, blocks, seed=3):
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    st = j_tx.init_tx_state(mode)
    chunks = []
    if mode.hierarchical:
        hp = tsio.make_ts_packets(n_pk[0] * blocks, seed=seed)
        lp = tsio.make_ts_packets(n_pk[1] * blocks, seed=seed + 1)
        for b in range(blocks):
            st, iq = tx(st, (hp[b * n_pk[0]:(b + 1) * n_pk[0]],
                             lp[b * n_pk[1]:(b + 1) * n_pk[1]]))
            chunks.append(np.asarray(iq))
        return hp, n_pk[0], np.concatenate(chunks)
    packets = tsio.make_ts_packets(n_pk * blocks, seed=seed)
    for b in range(blocks):
        st, iq = tx(st, packets[b * n_pk:(b + 1) * n_pk])
        chunks.append(np.asarray(iq))
    return packets, n_pk, np.concatenate(chunks)


@pytest.mark.parametrize("guard", ["1/32", "1/16", "1/8", "1/4"])
def test_detect_guard_matches_jax(guard):
    _, _, stream = _tx_stream(DvbtMode("2k", "qpsk", "1/2", guard), 1)
    best, scores = t_auto.detect_guard(stream, "2k", CPU)
    j_best, j_scores = j_auto.detect_guard(stream, "2k")
    assert best == j_best == guard, (scores, j_scores)
    assert scores.keys() == j_scores.keys()
    for g in scores:
        assert abs(scores[g] - j_scores[g]) <= SCORE_TOL, (g, scores,
                                                            j_scores)
    others = [v for k, v in scores.items() if k != guard]
    assert scores[guard] > 2 * max(others), scores


def test_detect_mode_hierarchical_matches_jax():
    mode = DvbtMode("2k", "16qam", "2/3", "1/16", alpha=2, code_rate_lp="3/4")
    _, _, stream = _tx_stream(mode, 2)
    det, info = t_auto.detect_mode(stream, "2k", CPU)
    j_det, j_info = j_auto.detect_mode(stream, "2k")
    assert det == port_mode(mode) == port_mode(j_det)
    assert info["bch_ok"]
    for k in ("guard", "length", "frame", "constellation", "alpha",
              "code_rate", "code_rate_lp", "transmission", "bch_ok"):
        assert info[k] == j_info[k], k
    for k in ("start", "cfo_int", "frame_num"):
        assert int(info["sync"][k]) == int(j_info["sync"][k]), k


def test_detect_mode_rejects_noise():
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(600_000)
             + 1j * rng.standard_normal(600_000)).astype(np.complex64)
    with pytest.raises(t_auto.DetectionError):
        t_auto.detect_mode(noise, "2k", CPU, guard="1/32")
    with pytest.raises(t_auto.DetectionError, match="need >= "):
        t_auto.detect_guard(noise[:5000], "2k", CPU)


def test_auto_receiver_2k_64qam_23_matches_jax():
    mode = DvbtMode("2k", "64qam", "2/3", "1/32")
    packets, n_pk, stream = _tx_stream(mode, 6)
    dev = j_channel.apply_cfo(jax.numpy.asarray(stream), 0.8, mode.fft_len)
    dev = j_channel.awgn(jax.random.PRNGKey(0), dev, 30.0)
    stream = np.asarray(dev)[777:]

    arx = t_auto.AutoStreamingReceiver("2k", CPU)
    reports = arx.feed(stream[:300_000]) + arx.feed(stream[300_000:])
    m = arx.detected_mode
    assert (m.constellation, m.code_rate, m.guard, m.alpha) == \
        ("64qam", "2/3", "1/32", 0)
    assert arx.detect_info["bch_ok"]
    assert arx.block_samples == mode.samples_per_block   # delegated

    j_arx = j_auto.AutoStreamingReceiver("2k")
    want = j_arx.feed(stream[:300_000]) + j_arx.feed(stream[300_000:])
    assert port_mode(j_arx.detected_mode) == m
    assert len(reports) == len(want) > 2
    for g, w in zip(reports, want):
        assert g.stream_offset == w.stream_offset
        assert g.reacquired == w.reacquired
        assert np.array_equal(g.packets, np.asarray(w.packets))
        assert np.array_equal(g.rs_corrected, np.asarray(w.rs_corrected))
        assert np.array_equal(g.rs_uncorrectable,
                              np.asarray(w.rs_uncorrectable))

    out = np.concatenate([r.packets for r in reports])
    k0 = (reports[0].stream_offset + 777 + 8) // mode.samples_per_block
    want_pk, got = packets[k0 * n_pk:], out[DELAY:]
    n = min(len(got), len(want_pk))
    assert n > 2 * n_pk
    assert np.array_equal(got[:n], want_pk[:n])
