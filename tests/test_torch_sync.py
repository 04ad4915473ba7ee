"""The port's acquisition and synchronization (ops/ofdm.py
make_symbol_acquisition, ops/sync.py) against the JAX package on the CPU,
on 2K captures with delay, CFO and noise built as tests/test_sync.py
builds them; each mux of a batch has its own impairments."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import MODE_2K_QPSK, SYMBOLS_PER_FRAME, DvbtMode
from dvbt_tpu.models import channel, tx as j_tx
from dvbt_tpu.ops import ofdm as j_ofdm
from dvbt_tpu.ops import sync as j_sync
from dvbt_tpu_torch.ops import ofdm as t_ofdm
from dvbt_tpu_torch.ops import sync as t_sync
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

EXACT = ("theta", "cfo_int", "frame_sym", "frame_num", "start",
         "start_frame")
# cfo_frac: the port takes the CP-correlation running sums in float64,
# the JAX package in float32; measured agreement ~1e-7
CFO_TOL = 1e-5
# aligned samples: a cfo_frac difference d rotates sample n by 2*pi*d*n/N,
# up to ~2.4e-3 rad at the end of a 2K capture for d = 1e-5; measured
# ~2e-4 for the ~1e-7 the estimates differ by
ALIGNED_TOL = 2e-3


@functools.lru_cache(maxsize=None)
def _stream(mode, n_blocks):
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    packets = tsio.make_ts_packets(n_pk * n_blocks, seed=0)
    st = j_tx.init_tx_state(mode)
    out = []
    for b in range(n_blocks):
        st, iq = tx(st, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
        out.append(np.asarray(iq))
    return np.concatenate(out)


def _captures(mode, n_frames_out, impairments, snr_db=25.0):
    """One capture per (offset, cfo, phase0, seed), as tests/test_sync.py
    makes them."""
    stream = _stream(mode, 8)
    cap = j_sync.min_capture_samples(mode, n_frames_out)
    out = []
    for off, cfo, ph0, seed in impairments:
        c = channel.apply_cfo(jnp.asarray(stream[off:off + cap]), cfo,
                              mode.fft_len, phase0=ph0)
        if snr_db is not None:
            c = channel.awgn(jax.random.PRNGKey(seed), c, snr_db)
        out.append(np.asarray(c))
    return np.stack(out), cap


def _check_sync(mode, n_frames_out, impairments, backoff):
    caps, cap = _captures(mode, n_frames_out, impairments)
    sync_t = t_sync.make_synchronizer(port_mode(mode), cap, n_frames_out,
                                      "cpu", backoff=backoff)
    aligned, info = sync_t(torch.from_numpy(caps))
    sync_j = j_sync.make_synchronizer(mode, cap, n_frames_out,
                                      backoff=backoff)
    assert aligned.shape == (len(caps), n_frames_out * SYMBOLS_PER_FRAME
                             * mode.symbol_len)
    for m, c in enumerate(caps):
        al_j, info_j = sync_j(jnp.asarray(c))
        for k in EXACT:
            assert int(info[k][m]) == int(info_j[k]), (k, m)
        assert abs(float(info["cfo_frac"][m]) - float(info_j["cfo_frac"])) \
            <= CFO_TOL
        np.testing.assert_allclose(aligned[m].numpy(), np.asarray(al_j),
                                   rtol=0, atol=ALIGNED_TOL)
        np.testing.assert_allclose(info["scat_score"][m].numpy(),
                                   np.asarray(info_j["scat_score"]),
                                   rtol=1e-5)
        assert float(info["tps_score"][m]) == float(info_j["tps_score"])
    return info


def test_min_capture_samples_matches_jax():
    for mode in (MODE_2K_QPSK, DvbtMode("2k", "qpsk", "3/4"),
                 DvbtMode("8k", "64qam", "2/3")):
        for n in (1, 2, 4):
            assert t_sync.min_capture_samples(port_mode(mode), n) == \
                j_sync.min_capture_samples(mode, n)


def test_symbol_acquisition_matches_jax():
    mode = MODE_2K_QPSK
    L = mode.symbol_len
    caps, cap = _captures(mode, 1, [(41 * L + 1234, 2.3, 0.7, 3),
                                    (7 * L + 99, -1.6, 0.0, 4),
                                    (500, 0.45, 1.0, 5)])
    theta, cfo = t_ofdm.make_symbol_acquisition(port_mode(mode), cap)(
        torch.from_numpy(caps))
    acq_j = j_ofdm.make_symbol_acquisition(mode, cap)
    for m, c in enumerate(caps):
        th_j, cfo_j = acq_j(jnp.asarray(c))
        assert int(theta[m]) == int(th_j)
        assert abs(float(cfo[m]) - float(cfo_j)) <= CFO_TOL
    assert theta.dtype == torch.int32 and cfo.dtype == torch.float32


def test_synchronizer_matches_jax_with_delay_cfo_and_noise():
    """Two muxes, each with its own delay and CFO (+2.3 and -1.6
    subcarriers), AWGN at 25 dB; the estimates also equal the
    impairments."""
    mode = MODE_2K_QPSK
    L = mode.symbol_len
    imp = [(41 * L + 1234, 2.3, 0.7, 3), (7 * L + 99, -1.6, 0.0, 4)]
    info = _check_sync(mode, 1, imp, t_sync.DEFAULT_BACKOFF)
    for m, (off, cfo, _, _) in enumerate(imp):
        assert int(info["theta"][m]) == (-off) % L
        assert int(info["cfo_int"][m]) == round(cfo)
        assert abs(float(info["cfo_frac"][m]) - (cfo - round(cfo))) < 0.02
        abs_start = off + int(info["start"][m]) + t_sync.DEFAULT_BACKOFF
        assert abs_start % (SYMBOLS_PER_FRAME * L) == 0


def test_synchronizer_multiframe_block_alignment_matches_jax():
    """2K QPSK 3/4 carries whole packets only every 2 frames: sync must
    advance to an even TPS frame number, as the JAX package does."""
    mode = DvbtMode("2k", "qpsk", "3/4")
    L = mode.symbol_len
    info = _check_sync(mode, 2, [(70 * L + 99, 0.0, 0.0, 6),
                                 (12 * L + 7, 1.2, 0.3, 7)], backoff=0)
    assert (info["start_frame"] % 2 == 0).all()
    for m, off in enumerate((70 * L + 99, 12 * L + 7)):
        assert (off + int(info["start"][m])) % (2 * SYMBOLS_PER_FRAME * L) \
            == 0


def test_synchronizer_rejects_short_capture():
    mode = port_mode(MODE_2K_QPSK)
    with pytest.raises(ValueError, match="shorter"):
        t_sync.make_synchronizer(
            mode, t_sync.min_capture_samples(mode, 1) - 1, 1, "cpu")


def test_tracker_matches_jax():
    """Derotated samples within 1e-5; the carried NCO phase within one
    float32 step of the unwrapped angle (~1e3 rad here: 6.1e-5 rad)."""
    mode = MODE_2K_QPSK
    n_out = SYMBOLS_PER_FRAME * mode.symbol_len
    rng = np.random.default_rng(8)
    iq = (rng.standard_normal((3, n_out))
          + 1j * rng.standard_normal((3, n_out))).astype(np.complex64)
    cfo_frac = np.array([0.3, -0.4, 0.0], np.float32)
    cfo_int = np.array([2, -1, 0], np.int32)
    phase = np.array([0.3, 5.9, 0.0], np.float32)
    out, ph = t_sync.make_tracker(port_mode(mode), 1, "cpu")(
        torch.from_numpy(iq), torch.from_numpy(cfo_frac),
        torch.from_numpy(cfo_int), torch.from_numpy(phase))
    track_j = j_sync.make_tracker(mode, 1)
    for m in range(3):
        out_j, ph_j = track_j(jnp.asarray(iq[m]), jnp.float32(cfo_frac[m]),
                              jnp.int32(cfo_int[m]), jnp.float32(phase[m]))
        np.testing.assert_allclose(out[m].numpy(), np.asarray(out_j),
                                   rtol=0, atol=1e-5)
        assert abs(float(ph[m]) - float(ph_j)) <= 1.25e-4
        assert 0.0 <= float(ph[m]) < 2 * np.pi
