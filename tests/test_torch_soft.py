"""The port's soft chain (ops/mapper.make_soft_demapper, ops/bit_interleaver.
make_soft_bit_deinterleaver, the CSI-weighted soft receiver) against the
JAX package on the CPU.  Inputs and noise come from seeded numpy.

The soft demapper takes the max-log LLR per axis where the JAX package
takes it over the whole constellation; the two agree in exact arithmetic
and round differently in float32.  Measured on 200,000 random points per
constellation and alpha, with and without CSI: at most 2.5e-6 of the
quantized metrics differ, each by one level (tests below hold 1e-5 and
one level), and every difference sits where the metric's unrounded value
is within 1e-3 of a rounding boundary."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.mode import MODE_2K_QPSK, DvbtMode
from dvbt_tpu.models import rx as j_rx
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu.ops import bit_interleaver as j_bil
from dvbt_tpu.ops import mapper as j_map
from dvbt_tpu_torch.apps import ber_sweep as t_ber
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.ops import bit_interleaver as t_bil
from dvbt_tpu_torch.ops import mapper as t_map
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

DELAY_PACKETS = 11
CPU = torch.device("cpu")
MAX_DIFF_SHARE = 1e-5      # quantized metrics that may differ from JAX's
CONSTELLATIONS = [("qpsk", 0), ("16qam", 0), ("64qam", 0), ("16qam", 1),
                  ("16qam", 2), ("16qam", 4), ("64qam", 1), ("64qam", 2),
                  ("64qam", 4)]


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _exact_metric(mode, y, csi):
    """The unrounded metric 7.5 + 7.5 * llr / dmin2 per (point, bit), the
    max-log LLR over the whole constellation in float64."""
    c = mode.constellation_table()
    v = mode.v
    yy = y.astype(np.complex128)[:, None]
    score = (yy * np.conj(c)[None]).real - np.abs(c)[None] ** 2 / 2
    c32 = c.astype(np.complex64)
    d2 = np.abs(c32[:, None] - c32[None, :]) ** 2
    np.fill_diagonal(d2, np.inf)
    dmin2 = float(d2.min())
    out = []
    for b in range(v):
        is1 = ((np.arange(1 << v) >> (v - 1 - b)) & 1).astype(bool)
        llr = score[:, is1].max(-1) - score[:, ~is1].max(-1)
        if csi is not None:
            llr = llr * csi
        out.append(7.5 + 7.5 * llr / dmin2)
    return np.stack(out, -1)


@pytest.mark.parametrize("with_csi", [False, True], ids=["plain", "csi"])
@pytest.mark.parametrize("const,alpha", CONSTELLATIONS)
def test_soft_demapper_matches_jax(const, alpha, with_csi):
    mode = DvbtMode("2k", const, "1/2", alpha=alpha)
    rng = np.random.default_rng(7)
    n = 50_000
    pts = mode.constellation_table().astype(np.complex64)
    scale = rng.choice([0.02, 0.1, 0.3, 1.0], n).astype(np.float32)
    y = (pts[rng.integers(0, len(pts), n)] + _cplx(rng, n) * scale).astype(
        np.complex64)
    csi = rng.exponential(1.0, n).astype(np.float32) if with_csi else None
    got = t_map.make_soft_demapper(port_mode(mode), CPU)(
        torch.from_numpy(y), None if csi is None else torch.from_numpy(csi))
    want = np.asarray(j_map.make_soft_demapper(mode)(
        jnp.asarray(y), None if csi is None else jnp.asarray(csi)))
    assert got.dtype == torch.uint8 and got.shape == (n, mode.v)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_DIFF_SHARE
    # every difference sits on a rounding boundary of the exact metric
    exact = _exact_metric(mode, y, csi)[diff > 0]
    assert np.all(np.abs(exact - np.floor(exact) - 0.5) < 1e-3)


@pytest.mark.parametrize("const,alpha", [("qpsk", 0), ("64qam", 0),
                                         ("16qam", 2), ("64qam", 4)])
def test_soft_demapper_reads_clean_points(const, alpha):
    """A clean constellation point's metrics lie on the side of 7.5 that
    its own cell value's bits say."""
    mode = DvbtMode("2k", const, "1/2", alpha=alpha)
    pts = mode.constellation_table().astype(np.complex64)
    got = t_map.make_soft_demapper(port_mode(mode), CPU)(
        torch.from_numpy(pts)).numpy()
    cells = np.arange(len(pts))
    bits = (cells[:, None] >> np.arange(mode.v - 1, -1, -1)) & 1
    assert np.array_equal(got >= 8, bits == 1)


@pytest.mark.parametrize("const,alpha", [("qpsk", 0), ("16qam", 0),
                                         ("64qam", 0), ("16qam", 2),
                                         ("64qam", 1)])
def test_soft_bit_deinterleaver_matches_jax(const, alpha):
    mode = DvbtMode("2k", const, "1/2", alpha=alpha)
    soft = np.random.default_rng(8).integers(
        0, 16, (2, 3, mode.n_payload, mode.v), dtype=np.uint8)
    got = t_bil.make_soft_bit_deinterleaver(port_mode(mode), CPU)(
        torch.from_numpy(soft))
    want = np.asarray(j_bil.make_soft_bit_deinterleaver(mode)(
        jnp.asarray(soft)))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _chains(mode):
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    rx_j, _, _ = j_rx.make_receiver(mode, demap="soft", measure_pre_rs=True)
    rx_t, _, _ = t_rx.make_receiver(port_mode(mode), CPU, demap="soft",
                                    measure_pre_rs=True)
    return tx, rx_j, rx_t, n_pk


def test_soft_receiver_matches_jax_under_noise():
    """2K 64-QAM 7/8 at 20 dB (a post-Viterbi BER of ~2e-3, every packet
    correctable), the same TX signal and numpy noise into both soft
    receivers over two blocks: the TS are equal, the packets the RS
    decoder could not correct are the same, and the summed pre-RS bit
    errors agree within 1% (a metric one level off at a rounding boundary
    may move a Viterbi decision)."""
    mode = DvbtMode("2k", "64qam", "7/8")
    tx, rx_j, rx_t, n_pk = _chains(mode)
    pmode = port_mode(mode)
    packets = make_ts_packets(n_pk * 2, seed=3)
    rng = np.random.default_rng(4)
    tst, rsj = j_tx.init_tx_state(mode), j_rx.init_rx_state(mode)
    rst = t_rx.init_rx_state(pmode, 1, CPU)
    err_j = err_t = 0
    for b in range(2):
        tst, iq = tx(tst, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
        iq = np.asarray(iq)
        sigma = np.sqrt(np.mean(np.abs(iq) ** 2) / 100 / 2)
        iq = (iq + sigma * _cplx(rng, iq.shape)).astype(np.complex64)
        rsj, ts_j, m_j = rx_j(rsj, jnp.asarray(iq))
        rst, ts_t, m_t = rx_t(rst, torch.from_numpy(iq)[None])
        assert np.array_equal(ts_t[0].numpy(), np.asarray(ts_j))
        assert np.array_equal(m_t["rs_uncorrectable"][0].numpy(),
                              np.asarray(m_j["rs_uncorrectable"]))
        err_j += int(np.asarray(m_j["pre_rs_bit_errors"]).sum())
        err_t += int(m_t["pre_rs_bit_errors"].sum())
    assert err_j > 1000
    assert abs(err_t - err_j) <= 0.01 * err_j, (err_t, err_j)


def test_soft_loopback_noiseless_byte_exact():
    """tests/test_channel.py's noiseless soft loopback, 2K 64-QAM 2/3."""
    mode = port_mode(DvbtMode("2k", "64qam", "2/3"))
    tx, n_pk, _ = t_tx.make_transmitter(mode, CPU)
    rx, _, _ = t_rx.make_receiver(mode, CPU, demap="soft")
    packets = make_ts_packets(n_pk * 2, seed=6)
    tst, rst = t_tx.init_tx_state(mode, 1, CPU), t_rx.init_rx_state(mode, 1,
                                                                     CPU)
    outs = []
    for b in range(2):
        tst, iq = tx(tst, torch.from_numpy(packets[b * n_pk:(b + 1) * n_pk])
                     [None])
        rst, ts, _ = rx(rst, iq)
        outs.append(ts[0].numpy())
    out = np.concatenate(outs)
    assert np.array_equal(out[DELAY_PACKETS:],
                          packets[:len(out) - DELAY_PACKETS])


def test_soft_unequalized_matches_jax():
    """equalize=False: the soft metrics carry no CSI (csi None), as in the
    JAX package; a noiseless block decodes alike in both."""
    mode = MODE_2K_QPSK
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    rx_j, _, _ = j_rx.make_receiver(mode, demap="soft", equalize=False)
    rx_t, _, _ = t_rx.make_receiver(port_mode(mode), CPU, demap="soft",
                                    equalize=False)
    packets = make_ts_packets(n_pk, seed=2)
    _, iq = tx(j_tx.init_tx_state(mode), jnp.asarray(packets))
    _, ts_j, m_j = rx_j(j_rx.init_rx_state(mode), iq)
    _, ts_t, m_t = rx_t(t_rx.init_rx_state(port_mode(mode), 1, CPU),
                        torch.from_numpy(np.array(iq))[None])
    assert "timing_tau" not in m_t
    assert np.array_equal(ts_t[0].numpy(), np.asarray(ts_j))


def test_soft_beats_hard():
    """tests/test_channel.py's point through the port's own run_point: at
    4 dB the hard QPSK 1/2 chain is past its waterfall while the soft
    chain decodes cleanly."""
    hard = t_ber.run_point(port_mode(MODE_2K_QPSK), 4.0, 2, demap="hard",
                           device="cpu")
    soft = t_ber.run_point(port_mode(MODE_2K_QPSK), 4.0, 2, demap="soft",
                           device="cpu")
    assert hard["per"] > 0.05
    assert soft["per"] == 0.0 and soft["ber_post_rs"] == 0.0
