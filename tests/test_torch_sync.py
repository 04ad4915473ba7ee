"""The port's acquisition and synchronization (ops/ofdm.py
make_symbol_acquisition, ops/sync.py) against the JAX package on the CPU,
on 2K captures with delay, CFO and noise built as tests/test_sync.py
builds them, and on OFDM captures of random carriers at every guard; each
mux of a batch has its own impairments.  The acquisition kernel's wrapper
(kernels/acquire.py) on the CPU: its input checks, its launch geometry at
every mode, and a numpy emulation of the kernel's tiled plan (theta tiles
over fold groups, window sums from a scan over each tile) against the
plain version."""

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
from dvbt_tpu_torch.kernels import acquire as kacquire
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
# every (transmission, guard) of EN 300 744
ALL_GUARDS = [(t, g) for t in ("2k", "8k") for g in ("1/4", "1/8", "1/16",
                                                     "1/32")]


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


def _ofdm_captures(mode, n_samples, impairments, snr_db=20.0):
    """One capture of n_samples per (delay, cfo, phase0, seed): OFDM
    symbols of random QPSK carriers (the mode's active spectrum, cyclic
    prefix first) from the delay on, turned by cfo subcarriers from
    phase0, with AWGN at snr_db; complex64 (n_mux, n_samples)."""
    N, L = mode.fft_len, mode.symbol_len
    bins = t_ofdm._bin_map(port_mode(mode))
    out = []
    for delay, cfo, ph0, seed in impairments:
        rng = np.random.default_rng(seed)
        n_sym = (delay + n_samples) // L + 1
        spec = np.zeros((n_sym, N), np.complex128)
        spec[:, bins] = ((rng.integers(0, 2, (n_sym, len(bins))) * 2 - 1)
                         + 1j * (rng.integers(0, 2, (n_sym, len(bins))) * 2
                                 - 1)) / np.sqrt(2)
        sym = np.fft.ifft(spec, axis=-1, norm="ortho")
        stream = np.concatenate([sym[:, N - mode.guard_len:], sym],
                                axis=-1).reshape(-1)
        n = np.arange(n_samples)
        c = stream[delay:delay + n_samples] * np.exp(
            1j * (2 * np.pi * cfo * n / N + ph0))
        sigma = np.sqrt(np.mean(np.abs(c) ** 2) / 10 ** (snr_db / 10) / 2)
        c = c + sigma * (rng.standard_normal(n_samples)
                         + 1j * rng.standard_normal(n_samples))
        out.append(c.astype(np.complex64))
    return np.stack(out)


def _guard_captures(transmission, guard):
    """(mode, captures, n_samples): three captures of 6 symbols and a
    part, each with its own delay, integer + fractional CFO and phase."""
    mode = DvbtMode(transmission, "qpsk", "1/2", guard)
    L = mode.symbol_len
    n_samples = 6 * L + 777
    imp = [(L // 3 + 5, 2.3, 0.7, 3), (7 * L + 99, -1.6, 0.0, 4),
           (L - 1, 0.45, 1.0, 5)]
    return mode, _ofdm_captures(mode, n_samples, imp), n_samples


@pytest.mark.parametrize("transmission, guard", [
    ("2k", "1/4"), ("2k", "1/8"), ("2k", "1/16"), ("2k", "1/32"),
    ("8k", "1/4")])
def test_symbol_acquisition_matches_jax_at_every_guard(transmission, guard):
    """The plain version (the CPU's acquisition) against JAX's on OFDM
    captures with delay, fractional and integer CFO and noise: theta
    equal, cfo_frac within CFO_TOL, both at the impairments."""
    mode, caps, n = _guard_captures(transmission, guard)
    theta, cfo = t_ofdm.make_symbol_acquisition(port_mode(mode), n)(
        torch.from_numpy(caps))
    acq_j = j_ofdm.make_symbol_acquisition(mode, n)
    L = mode.symbol_len
    for m, (delay, f, _, _) in enumerate([(L // 3 + 5, 2.3, 0, 0),
                                          (7 * L + 99, -1.6, 0, 0),
                                          (L - 1, 0.45, 0, 0)]):
        th_j, cfo_j = acq_j(jnp.asarray(caps[m]))
        assert int(theta[m]) == int(th_j) == (-delay) % L
        assert abs(float(cfo[m]) - float(cfo_j)) <= CFO_TOL
        assert abs(float(cfo[m]) - (f - round(f))) < 0.02


def _tiled_acquisition(mode, caps: np.ndarray, n_samples: int, n_sm: int):
    """The kernel's plan in numpy at its launch geometry: for each capture,
    fold group and theta tile, every fold's window sums from a float64
    scan over the tile's T + G - 1 terms; the groups' partial sums added
    in order, the first argmax, the carrier offset from the summed gamma."""
    N, G, L = mode.fft_len, mode.guard_len, mode.symbol_len
    n_folds = (n_samples - N - G) // L
    M = caps.shape[0]
    geo = kacquire.geometry(port_mode(mode), n_folds, M, n_sm)
    T, n_groups = geo["tile"], geo["n_groups"]
    x = caps.astype(np.complex128)
    partial = np.zeros((M, n_groups, 3, L))
    for g in range(n_groups):
        folds = np.arange(g * n_folds // n_groups,
                          (g + 1) * n_folds // n_groups)
        assert folds.size >= 1
        for i in range(geo["n_tiles"]):
            theta0 = i * T
            n_theta = min(T, L - theta0)
            n_ld = n_theta + G - 1
            assert n_ld <= kacquire.ELEMS * geo["threads"]
            j = (folds * L + theta0)[:, None] + np.arange(n_ld)
            assert j.max() + N < n_samples
            a, b = x[:, j], x[:, j + N]                 # (M, folds, n_ld)
            terms = np.stack([a * b.conj(), (np.abs(a) ** 2
                                             + np.abs(b) ** 2) * 0.5])
            S = np.concatenate([np.zeros((2, M, len(folds), 1)),
                                np.cumsum(terms, -1)], -1)
            gam = S[0, ..., G:G + n_theta] - S[0, ..., :n_theta]
            phi = (S[1, ..., G:G + n_theta] - S[1, ..., :n_theta]).real
            sl = slice(theta0, theta0 + n_theta)
            partial[:, g, 0, sl] = (np.abs(gam) - kacquire.RHO * phi).sum(1)
            partial[:, g, 1, sl] = gam.real.sum(1)
            partial[:, g, 2, sl] = gam.imag.sum(1)
    total = partial.sum(1)
    theta = total[:, 0].argmax(-1)
    g_sum = total[np.arange(M), 1, theta] + 1j * total[np.arange(M), 2, theta]
    return theta, (-np.angle(g_sum) / (2 * np.pi)).astype(np.float32)


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("transmission, guard", ALL_GUARDS)
def test_tiled_plan_matches_plain_acquisition(transmission, guard, n_sm):
    """The kernel's tiled plan, at its geometry for one SM (one fold group
    of every period) and for the H100's 132 (a group a period here),
    gives the plain version's theta and its cfo_frac within 1e-6: both
    sum in float64, in other orders."""
    mode, caps, n = _guard_captures(transmission, guard)
    theta, cfo = kacquire.make_symbol_acquisition_plain(port_mode(mode), n)(
        torch.from_numpy(caps))
    th_k, cfo_k = _tiled_acquisition(mode, caps, n, n_sm)
    np.testing.assert_array_equal(th_k, theta.numpy())
    np.testing.assert_allclose(cfo_k, cfo.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("transmission, guard", ALL_GUARDS)
def test_acquisition_geometry_covers_every_mode(transmission, guard):
    """At every mode the fold blocks' tiles cover the symbol period, hold
    at least G candidates and stage at most 4 x threads samples; at the
    capture cells' shape (8 captures of 409 symbols) the fold launch puts
    at least 4 blocks on each of the H100's 132 SMs."""
    mode = port_mode(DvbtMode(transmission, "qpsk", "1/2", guard))
    G, L = mode.guard_len, mode.symbol_len
    n_samples = 409 * L
    n_folds = (n_samples - L) // L
    geo = kacquire.geometry(mode, n_folds, 8, 132)
    T, n_tiles = geo["tile"], geo["n_tiles"]
    assert G <= T and T + G - 1 <= kacquire.ELEMS * geo["threads"]
    assert (n_tiles - 1) * T < L <= n_tiles * T
    assert 1 <= geo["n_groups"] <= n_folds
    assert 8 * n_tiles * geo["n_groups"] >= 4 * 132
    one = kacquire.geometry(mode, 1, 1, 132)
    assert one["n_groups"] == 1 and one["tile"] == T


def test_acquisition_wrapper_checks_its_input():
    """complex64 (..., n_samples) with unit stride along the samples, or
    the wrapper raises, on the CPU as on the card; leading axes are kept."""
    mode = port_mode(DvbtMode("2k", "qpsk", "1/2", "1/32"))
    n = 3 * mode.symbol_len
    acquire = t_ofdm.make_symbol_acquisition(mode, n)
    x = torch.zeros(2, 3, n, dtype=torch.complex64)
    theta, cfo = acquire(x)
    assert theta.shape == cfo.shape == (2, 3)
    assert theta.dtype == torch.int32 and cfo.dtype == torch.float32
    with pytest.raises(TypeError, match="complex64"):
        acquire(x.to(torch.complex128))
    with pytest.raises(ValueError, match="is not"):
        acquire(x[..., 1:])
    with pytest.raises(ValueError, match="no capture"):
        acquire(x[:0])
    with pytest.raises(ValueError, match="unit stride"):
        acquire(torch.zeros(2, 2 * n, dtype=torch.complex64)[:, ::2])
    with pytest.raises(ValueError, match="full symbol"):
        t_ofdm.make_symbol_acquisition(mode, mode.symbol_len)


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
