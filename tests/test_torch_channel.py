"""The port's channel models (dvbt_tpu_torch/models/channel.py) and the
receiver's pre-RS error counter against the JAX package, on the CPU.
Inputs and noise come from seeded numpy; float stages must match within
the golden tolerance, the host resampler and the Annex B taps exactly or
to float32 rounding, and the counter exactly."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.mode import MODE_2K_QPSK
from dvbt_tpu.models import channel as j_ch
from dvbt_tpu.models import rx as j_rx
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu_torch.models import channel as t_ch
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
DELAY_PACKETS = 11
CPU = torch.device("cpu")
# the digest tests/test_channel.py pins the JAX package's tables to
ANNEX_B_SHA256 = ("37375a006a028ea615f87be78fbcbb54196958e333b95c18f60ff7"
                  "cd45c84e55")


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.parametrize("cfo,phase0", [(0.37, 0.0), (-3.2, 1.1)])
def test_apply_cfo_matches_jax(cfo, phase0):
    iq = _cplx(np.random.default_rng(0), (2, 5000))
    got = t_ch.apply_cfo(torch.from_numpy(iq), cfo, 2048, phase0)
    for m in range(2):
        want = j_ch.apply_cfo(jnp.asarray(iq[m]), cfo, 2048, phase0)
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("delay", [0, 1, 37])
def test_apply_delay_matches_jax(delay):
    iq = _cplx(np.random.default_rng(1), (2, 300))
    got = t_ch.apply_delay(torch.from_numpy(iq), delay)
    for m in range(2):
        assert np.array_equal(
            got[m].numpy(), np.asarray(j_ch.apply_delay(jnp.asarray(iq[m]),
                                                        delay)))


def _two_ray():
    return np.array([1.0, 0, 0, 0, 0, 0.4 * np.exp(1j * 0.7)], np.complex64)


@pytest.mark.parametrize("profile", ["F1", "P1", "two-ray"])
def test_multipath_matches_jax(profile):
    iq = _cplx(np.random.default_rng(2), (2, 4000))
    if profile == "two-ray":
        taps_t = torch.from_numpy(_two_ray())
        taps_j = jnp.asarray(_two_ray())
    else:
        taps_t = t_ch.annex_b_taps(profile)
        taps_j = j_ch.annex_b_taps(profile)
    got = t_ch.multipath(torch.from_numpy(iq), taps_t)
    assert got.dtype == torch.complex64 and got.shape == iq.shape
    for m in range(2):
        want = j_ch.multipath(jnp.asarray(iq[m]), taps_j)
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("ppm", [-50.0, 120.0])
def test_resample_ppm_is_exact(ppm):
    iq = _cplx(np.random.default_rng(3), 20000)
    got = t_ch.resample_ppm(iq, ppm)
    want = j_ch.resample_ppm(iq, ppm)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("profile", ["F1", "P1"])
@pytest.mark.parametrize("rate", [64e6 / 7, 48e6 / 7])
def test_annex_b_taps_match_jax(profile, rate):
    got = t_ch.annex_b_taps(profile, rate)
    want = np.asarray(j_ch.annex_b_taps(profile, rate))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_annex_b_taps_shape():
    """At 64/7 MHz the echoes span 51 samples; their 20 delays fall on 12
    distinct taps, and F1 adds the direct ray at tap 0.  Unit power."""
    for profile, n_nonzero in (("P1", 12), ("F1", 13)):
        taps = t_ch.annex_b_taps(profile).numpy()
        assert taps.shape == (51,)
        assert np.count_nonzero(taps) == n_nonzero
        assert np.sum(np.abs(taps) ** 2) == pytest.approx(1.0, rel=1e-6)
    with pytest.raises(ValueError, match="profile"):
        t_ch.annex_b_taps("P2")


def test_annex_b_table_checksum():
    """The port's copy of the 20-echo ensemble hashes to the digest that
    pins the JAX package's (tests/test_channel.py)."""
    for t in (t_ch._ANNEX_B_RHO, t_ch._ANNEX_B_THETA, t_ch._ANNEX_B_TAU_US):
        assert len(t) == 20
    blob = ";".join(
        ",".join(f"{v:.6f}" for v in t)
        for t in (t_ch._ANNEX_B_RHO, t_ch._ANNEX_B_THETA,
                  t_ch._ANNEX_B_TAU_US))
    assert hashlib.sha256(blob.encode()).hexdigest() == ANNEX_B_SHA256


def test_awgn_power_and_seed():
    """Each mux row gets noise at snr_db below its own measured power,
    within 2% over 200,000 samples (the estimate's spread is ~0.3%); the
    same seed gives the same noise, another seed other noise."""
    rng = np.random.default_rng(4)
    iq = torch.from_numpy(_cplx(rng, (2, 200_000)))
    iq[1] *= 3.0                                   # 9.5 dB hotter row
    snr = 12.0

    def noisy(seed):
        return t_ch.awgn(torch.Generator().manual_seed(seed), iq, snr)

    a, b, c = noisy(5), noisy(5), noisy(6)
    assert a.dtype == torch.complex64 and a.shape == iq.shape
    assert torch.equal(a, b) and not torch.equal(a, c)
    p_sig = (iq.abs() ** 2).mean(-1)
    p_noise = ((a - iq).abs() ** 2).mean(-1)
    ratio = p_noise / (p_sig / 10 ** (snr / 10))
    assert torch.all((ratio - 1).abs() < 0.02), ratio


def test_multipath_equalized_byte_exact():
    """tests/test_channel.py's two-ray channel (0.4 at 5 samples, inside
    the guard) through the port's chain: the equalizer absorbs it, the TS
    is byte-exact and the MER reads a clean constellation."""
    mode = port_mode(MODE_2K_QPSK)
    tx, n_pk, _ = t_tx.make_transmitter(mode, CPU)
    rx, _, _ = t_rx.make_receiver(mode, CPU)
    packets = make_ts_packets(n_pk * 3, seed=0)
    tst, rst = t_tx.init_tx_state(mode, 1, CPU), t_rx.init_rx_state(mode, 1,
                                                                     CPU)
    outs = []
    for b in range(3):
        tst, iq = tx(tst, torch.from_numpy(packets[b * n_pk:(b + 1) * n_pk])
                     [None])
        rst, ts, m = rx(rst, t_ch.multipath(iq, torch.from_numpy(
            _two_ray())))
        outs.append(ts[0].numpy())
    out = np.concatenate(outs)
    assert np.array_equal(out[DELAY_PACKETS:], packets[:len(out)
                                                       - DELAY_PACKETS])
    assert float(m["mer_db"][0]) > 25.0


def test_measure_pre_rs_matches_jax():
    """The port's and the JAX package's hard receivers, fed the same TX
    signal plus the same numpy noise at 5 dB (2K QPSK 1/2: correctable
    errors, no uncorrectable packet after warm-up), count the same
    post-Viterbi bit errors packet by packet, and decode the same TS."""
    mode = MODE_2K_QPSK
    pmode = port_mode(mode)
    tx_j, n_pk, _ = j_tx.make_transmitter(mode)
    rx_j, _, _ = j_rx.make_receiver(mode, measure_pre_rs=True)
    rx_t, _, _ = t_rx.make_receiver(pmode, CPU, measure_pre_rs=True)
    packets = make_ts_packets(n_pk * 2, seed=9)
    rng = np.random.default_rng(10)
    tst, rsj = j_tx.init_tx_state(mode), j_rx.init_rx_state(mode)
    rst = t_rx.init_rx_state(pmode, 1, CPU)
    total = 0
    for b in range(2):
        tst, iq = tx_j(tst, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
        iq = np.asarray(iq)
        sigma = np.sqrt(np.mean(np.abs(iq) ** 2) / 10 ** 0.5 / 2)
        iq = (iq + sigma * _cplx(rng, iq.shape)).astype(np.complex64)
        rsj, ts_j, m_j = rx_j(rsj, jnp.asarray(iq))
        rst, ts_t, m_t = rx_t(rst, torch.from_numpy(iq)[None])
        assert np.array_equal(ts_t[0].numpy(), np.asarray(ts_j))
        for k in ("pre_rs_bit_errors", "rs_uncorrectable", "rs_corrected"):
            got, want = m_t[k][0].numpy(), np.asarray(m_j[k])
            assert got.dtype == want.dtype and np.array_equal(got, want), k
        assert m_t["pre_rs_bit_errors"].dtype == torch.int32
        total += int(m_t["pre_rs_bit_errors"].sum())
        jax.block_until_ready(ts_j)
    assert total > 100            # the point has errors to count
    bad = m_t["rs_uncorrectable"][0].numpy()
    assert not bad.any()
