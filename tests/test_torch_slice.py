"""The PyTorch port's TX -> RX slice against the JAX package on the CPU:
whole chains over carried-state blocks with two muxes, AWGN at 20 dB, a
mid-stream handover of the carried state between the two frameworks, and
the port's freedom from JAX."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.mode import MODE_2K_QPSK, DvbtMode
from dvbt_tpu.models import rx as j_rx
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.utils import state as t_state
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
DELAY_PACKETS = 11  # outer interleaver + deinterleaver: 2244 bytes
N_MUX = 2
MODE_2K_64QAM_23 = DvbtMode("2k", "64qam", "2/3")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _jax_chain(mode):
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    rx, _, _ = j_rx.make_receiver(mode, metrics="min")
    return tx, rx, n_pk


@functools.lru_cache(maxsize=None)
def _port_chain(mode):
    tx, n_pk, _ = t_tx.make_transmitter(port_mode(mode), "cpu")
    rx, _, _ = t_rx.make_receiver(port_mode(mode), "cpu", metrics="min")
    return tx, rx, n_pk


def _stack(states):
    """Per-mux JAX states -> one state with a leading mux axis (numpy)."""
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *states)


def _unstack(state, n):
    return [jax.tree.map(lambda x: jnp.asarray(x[m]), state)
            for m in range(n)]


def _packets(mode, n_blocks, seed):
    n_pk = _jax_chain(mode)[2]
    return make_ts_packets(n_pk * N_MUX * n_blocks, seed=seed).reshape(
        n_blocks, N_MUX, n_pk, 188)


def _awgn(rng, shape, snr_db):
    """Complex white noise snr_db below unit power (the TX output's mean
    power is just under 1)."""
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    return (sigma * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _jax_block(mode, tst, rst, packets, noise=None):
    """One block through the JAX TX and RX, mux by mux."""
    tx, rx, _ = _jax_chain(mode)
    iqs, tss, corr, bad = [], [], [], []
    for m in range(N_MUX):
        tst[m], iq = tx(tst[m], jnp.asarray(packets[m]))
        iq = np.asarray(iq)
        if noise is not None:
            iq = iq + noise[m]
        rst[m], ts, met = rx(rst[m], jnp.asarray(iq))
        iqs.append(np.asarray(iq))
        tss.append(np.asarray(ts))
        corr.append(np.asarray(met["rs_corrected"]))
        bad.append(np.asarray(met["rs_uncorrectable"]))
    return np.stack(iqs), np.stack(tss), np.stack(corr), np.stack(bad)


def _port_block(mode, tst, rst, packets, noise=None):
    tx, rx, _ = _port_chain(mode)
    tst, iq = tx(tst, torch.from_numpy(packets))
    if noise is not None:
        iq = iq + torch.from_numpy(noise)
    rst, ts, met = rx(rst, iq)
    assert met["timing_tau"].shape == (N_MUX, 68 * mode.frames_per_block)
    out = (iq.numpy(), ts.numpy(), met["rs_corrected"].numpy(),
           met["rs_uncorrectable"].numpy())
    return tst, rst, out


def _check_same(port, jax_out):
    np.testing.assert_allclose(port[0], jax_out[0], rtol=0, atol=ATOL)
    for p, j in zip(port[1:], jax_out[1:]):
        np.testing.assert_array_equal(p, j)


def _check_delivered(ts_blocks, packets):
    out = np.concatenate(ts_blocks, axis=1)
    sent = np.concatenate(list(packets), axis=1)
    np.testing.assert_array_equal(out[:, DELAY_PACKETS:],
                                  sent[:, :-DELAY_PACKETS])


@pytest.mark.parametrize("mode", [MODE_2K_QPSK, MODE_2K_64QAM_23],
                         ids=["2k_qpsk_12", "2k_64qam_23"])
def test_tx_rx_matches_jax(mode):
    """IQ within 2e-5; TS, rs_corrected, rs_uncorrectable exact; and the
    loop delivers the sent packets after the 11-packet delay."""
    packets = _packets(mode, 3, seed=21)
    j_t = [j_tx.init_tx_state(mode) for _ in range(N_MUX)]
    j_r = [j_rx.init_rx_state(mode) for _ in range(N_MUX)]
    p_t = t_tx.init_tx_state(port_mode(mode), N_MUX, "cpu")
    p_r = t_rx.init_rx_state(port_mode(mode), N_MUX, "cpu")
    ts_blocks, bad = [], []
    for blk in packets:
        want = _jax_block(mode, j_t, j_r, blk)
        p_t, p_r, got = _port_block(mode, p_t, p_r, blk)
        _check_same(got, want)
        ts_blocks.append(got[1])
        bad.append(got[3])
    _check_delivered(ts_blocks, packets)
    assert not np.concatenate(bad, axis=1)[:, DELAY_PACKETS:].any()


def test_awgn_20db_both_decode_the_sent_packets():
    """Hard-decision 64-QAM 2/3 at 20 dB SNR: RS has errors to correct, and
    both chains deliver the sent packets.  Outputs are held against the
    packets, not against each other: FFT round-off (~1e-6) may flip a cell
    lying on a decision boundary in one framework only."""
    mode = MODE_2K_64QAM_23
    packets = _packets(mode, 3, seed=22)
    rng = np.random.default_rng(23)
    n_samp = 68 * mode.symbol_len
    j_t = [j_tx.init_tx_state(mode) for _ in range(N_MUX)]
    j_r = [j_rx.init_rx_state(mode) for _ in range(N_MUX)]
    p_t = t_tx.init_tx_state(port_mode(mode), N_MUX, "cpu")
    p_r = t_rx.init_rx_state(port_mode(mode), N_MUX, "cpu")
    j_ts, p_ts, corrected = [], [], 0
    for blk in packets:
        noise = _awgn(rng, (N_MUX, n_samp), 20.0)
        want = _jax_block(mode, j_t, j_r, blk, noise)
        p_t, p_r, got = _port_block(mode, p_t, p_r, blk, noise)
        j_ts.append(want[1])
        p_ts.append(got[1])
        corrected += int(got[2].sum())
        assert not got[3][:, DELAY_PACKETS:].any()
        assert not want[3][:, DELAY_PACKETS:].any()
    assert corrected > 0
    _check_delivered(j_ts, packets)
    _check_delivered(p_ts, packets)


def test_state_handover_between_frameworks():
    """Block 1 in JAX, its carried TX and RX state handed to the port for
    block 2, the port's state handed back for block 3: every block matches
    an uninterrupted JAX run."""
    mode = MODE_2K_QPSK
    packets = _packets(mode, 3, seed=24)
    j_t = [j_tx.init_tx_state(mode) for _ in range(N_MUX)]
    j_r = [j_rx.init_rx_state(mode) for _ in range(N_MUX)]
    ref = [_jax_block(mode, j_t, j_r, blk) for blk in packets]

    h_t = [j_tx.init_tx_state(mode) for _ in range(N_MUX)]
    h_r = [j_rx.init_rx_state(mode) for _ in range(N_MUX)]
    _check_same(_jax_block(mode, h_t, h_r, packets[0]), ref[0])
    p_t = t_state.tx_state_from_jax(_stack(h_t), "cpu")
    p_r = t_state.rx_state_from_jax(_stack(h_r), "cpu")
    p_t, p_r, got = _port_block(mode, p_t, p_r, packets[1])
    _check_same(got, ref[1])
    h_t = _unstack(t_state.to_jax(p_t), N_MUX)
    h_r = _unstack(t_state.to_jax(p_r), N_MUX)
    _check_same(_jax_block(mode, h_t, h_r, packets[2]), ref[2])


def test_state_conversion_round_trip():
    mode = MODE_2K_64QAM_23
    jt = _stack([j_tx.init_tx_state(mode)] * N_MUX)
    jr = _stack([j_rx.init_rx_state(mode)] * N_MUX)
    pt = t_state.tx_state_from_jax(jt, "cpu")
    pr = t_state.rx_state_from_jax(jr, "cpu")
    want_t = t_tx.init_tx_state(port_mode(mode), N_MUX, "cpu")
    want_r = t_rx.init_rx_state(port_mode(mode), N_MUX, "cpu")
    for got, want in ((pt, want_t), (pr, want_r)):
        flat_g = jax.tree.leaves(t_state.to_jax(got))
        flat_w = jax.tree.leaves(t_state.to_jax(want))
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="keys"):
        t_state.tx_state_from_jax({"frame_idx": jt["frame_idx"]}, "cpu")


def test_port_imports_no_jax():
    code = ("import sys; import dvbt_tpu_torch, dvbt_tpu_torch.models.tx, "
            "dvbt_tpu_torch.models.rx, dvbt_tpu_torch.utils.state; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
