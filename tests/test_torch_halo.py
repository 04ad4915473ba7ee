"""The port's halo recompute (dvbt_tpu_torch/parallel/time_sharding.py)
against the JAX package's on the CPU, in one process: the halo size of
every mode, the TX state of each stream from a 12-packet halo, the RX
state from a real transmitted sample halo (hard and soft demap, one
stream and two), and the time-sharded carry handed across in both
directions.  Inputs come from seeded numpy."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.mode import MODE_2K_QPSK, MODE_8K_UK, DvbtMode
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu.parallel import time_sharding as j_tsh
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.parallel import time_sharding as t_tsh
from dvbt_tpu_torch.utils import state as t_state
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
CPU = torch.device("cpu")
MODES = [
    MODE_2K_QPSK,
    DvbtMode("2k", "16qam", "2/3"),
    pytest.param(MODE_8K_UK, marks=pytest.mark.slow),
]


def _mid(mode) -> str:
    return f"{mode.transmission}-{mode.constellation}-{mode.code_rate}"


NON_HIERARCHICAL = [
    DvbtMode(t, c, r) for t, c, r in itertools.product(
        ("2k", "8k"), ("qpsk", "16qam", "64qam"),
        ("1/2", "2/3", "3/4", "5/6", "7/8"))
]


HIERARCHICAL = [
    DvbtMode(t, c, r, alpha=a, code_rate_lp=lp)
    for t, c, a, (r, lp) in itertools.product(
        ("2k", "8k"), ("16qam", "64qam"), (1, 2, 4),
        (("1/2", "7/8"), ("2/3", "3/4"), ("7/8", "1/2")))
]


def _hid(mode) -> str:
    return _mid(mode) + f"-a{mode.alpha}-{mode.code_rate_lp}"


@pytest.mark.parametrize("mode", NON_HIERARCHICAL + HIERARCHICAL,
                         ids=lambda m: _hid(m) if m.alpha else _mid(m))
def test_rx_halo_symbols_match_jax(mode):
    h = t_tsh.rx_halo_symbols(port_mode(mode))
    assert h == j_tsh.rx_halo_symbols(mode)
    assert t_tsh.CHAN_WARMUP < h < 68


def _leaves_equal(port: dict, jstate: dict, atol: float = 0.0):
    """Port state (mux axis 1) against an unbatched JAX state, leaf by
    leaf: exact, or within atol for complex leaves."""
    assert set(port) == set(jstate)
    for k, j in jstate.items():
        if isinstance(j, dict):
            _leaves_equal(port[k], j, atol)
            continue
        got, want = port[k][0].numpy(), np.asarray(j)
        assert got.shape == want.shape, k
        if np.iscomplexobj(want):
            np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=k)
        else:
            assert got.dtype == want.dtype, k
            assert np.array_equal(got, want), k


@pytest.mark.parametrize("mode", MODES, ids=_mid)
@pytest.mark.parametrize("block_idx", [0, 5])
def test_tx_state_from_halo_matches_jax(mode, block_idx):
    halo = np.random.default_rng(block_idx).integers(
        0, 256, (j_tsh.HALO_PACKETS, 188)).astype(np.uint8)
    want = j_tsh.make_tx_state_from_halo(mode)(jnp.int32(block_idx),
                                                jnp.asarray(halo))
    got = t_tsh.make_tx_state_from_halo(port_mode(mode), CPU)(
        block_idx, torch.as_tensor(halo)[None])
    _leaves_equal(got, want)


@pytest.mark.parametrize("block_idx", [0, 5])
def test_lp_tx_state_from_halo_matches_jax(block_idx):
    """The LP stream's TX state (its own packet cadence, no frame_idx)."""
    mode = DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4")
    halo = np.random.default_rng(block_idx + 1).integers(
        0, 256, (j_tsh.HALO_PACKETS, 188)).astype(np.uint8)
    want = j_tsh.make_tx_state_from_halo(mode, "lp")(jnp.int32(block_idx),
                                                      jnp.asarray(halo))
    got = t_tsh.make_tx_state_from_halo(port_mode(mode), CPU, "lp")(
        block_idx, torch.as_tensor(halo)[None])
    assert "frame_idx" not in got
    _leaves_equal(got, want)


def _sent_block(mode, seed=17):
    """One block of the JAX transmitter's IQ (numpy)."""
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    if mode.hierarchical:
        pk = tuple(jnp.asarray(make_ts_packets(n, seed=seed + k))
                   for k, n in enumerate(n_pk))
    else:
        pk = jnp.asarray(make_ts_packets(n_pk, seed=seed))
    _, iq = tx(j_tx.init_tx_state(mode), pk)
    return np.array(iq)


def _stream_state_equal(got, stream):
    """The recomputed state's byte leaves against the streaming receiver's
    state after the same block."""
    torch.testing.assert_close(got["deint_tail"], stream["deint_tail"],
                               atol=0, rtol=0)
    for k, v in stream["viterbi"].items():
        assert torch.equal(got["viterbi"][k], v), k


@pytest.mark.parametrize("mode,demap", [
    (DvbtMode("2k", "16qam", "2/3"), "soft"),
    (DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4"), "hard"),
    (DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4"), "soft"),
], ids=["16qam-soft", "hier-a2-hard", "hier-a2-soft"])
@pytest.mark.parametrize("block_idx", [0, 3])
def test_rx_state_from_halo_soft_and_hierarchical_match_jax(mode, demap,
                                                            block_idx):
    """The soft and two-stream halo decode equals the JAX package's (the
    LP halo of 2K 16-QAM 3/4 holds 2268 info bits a symbol, not whole
    bytes) and, past stream start, the state the port's streaming receiver
    with the same demap carries out of that block, both streams."""
    iq = _sent_block(mode)
    H = j_tsh.rx_halo_symbols(mode)
    halo = iq[-H * mode.symbol_len:]
    want = j_tsh.make_rx_state_from_halo(mode, demap)(jnp.int32(block_idx),
                                                       jnp.asarray(halo))
    pmode = port_mode(mode)
    got = t_tsh.make_rx_state_from_halo(pmode, CPU, demap)(
        block_idx, torch.as_tensor(halo)[None])
    _leaves_equal(got, want, atol=ATOL)
    if block_idx:
        rx, _, _ = t_rx.make_receiver(pmode, CPU, metrics="min",
                                      demap=demap)
        stream, _, _ = rx(t_rx.init_rx_state(pmode, 1, CPU),
                          torch.as_tensor(iq)[None])
        _stream_state_equal(got, stream)
        torch.testing.assert_close(got["chan_tail"], stream["chan_tail"],
                                   atol=ATOL, rtol=0)
        if mode.hierarchical:
            _stream_state_equal(got["lp"], stream["lp"])


@pytest.mark.parametrize("mode", MODES, ids=_mid)
@pytest.mark.parametrize("block_idx", [0, 3])
def test_rx_state_from_halo_matches_jax(mode, block_idx):
    """The halo is the last H symbol periods of a block that the JAX
    transmitter sent; the recomputed state must equal the JAX package's
    (bytes exact, chan_tail within the golden tolerance) and, past stream
    start, the state the port's streaming receiver carries out of that
    block."""
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    _, iq = tx(j_tx.init_tx_state(mode),
               jnp.asarray(make_ts_packets(n_pk, seed=17)))
    iq = np.array(iq)
    H = j_tsh.rx_halo_symbols(mode)
    halo = iq[-H * mode.symbol_len:]
    want = j_tsh.make_rx_state_from_halo(mode)(jnp.int32(block_idx),
                                                jnp.asarray(halo))
    pmode = port_mode(mode)
    got = t_tsh.make_rx_state_from_halo(pmode, CPU)(
        block_idx, torch.as_tensor(halo)[None])
    _leaves_equal(got, want, atol=ATOL)
    if block_idx:
        rx, _, _ = t_rx.make_receiver(pmode, CPU, metrics="min")
        stream, _, _ = rx(t_rx.init_rx_state(pmode, 1, CPU),
                          torch.as_tensor(iq)[None])
        for k in ("deint_tail", "chan_tail"):
            torch.testing.assert_close(got[k], stream[k], atol=ATOL, rtol=0)
        for k, v in stream["viterbi"].items():
            assert torch.equal(got["viterbi"][k], v), k


def test_tx_state_from_halo_matches_streaming():
    """Past stream start, the TX state recomputed from the last 12 packets
    equals the state the port's streaming transmitter carries."""
    mode = port_mode(DvbtMode("2k", "16qam", "2/3"))
    tx, n_pk, _ = t_tx.make_transmitter(mode, CPU)
    pk = torch.as_tensor(make_ts_packets(3 * n_pk, seed=4)).reshape(
        3, 1, n_pk, 188)
    st = t_tx.init_tx_state(mode, 1, CPU)
    for b in range(3):
        st, _ = tx(st, pk[b])
    got = t_tsh.make_tx_state_from_halo(mode, CPU)(
        3, pk[2, :, -t_tsh.HALO_PACKETS:])
    for k, v in st.items():
        assert torch.equal(got[k], v), k


def test_carry_round_trip():
    """The JAX time-sharded carry (prev_pk, prev_iq, step_idx) goes into
    the port and back unchanged."""
    rng = np.random.default_rng(3)
    H = j_tsh.rx_halo_symbols(MODE_2K_QPSK) * MODE_2K_QPSK.symbol_len
    jcarry = (rng.integers(0, 256, (12, 188)).astype(np.uint8),
              (rng.standard_normal(H) + 1j * rng.standard_normal(H)
               ).astype(np.complex64),
              np.int32(7))
    carry = t_state.carry_from_jax(
        tuple(jnp.asarray(a) for a in jcarry), CPU)
    assert carry[0].dtype == torch.uint8 and carry[0].shape == (12, 188)
    assert carry[1].dtype == torch.complex64 and carry[1].shape == (H,)
    assert carry[2] == 7
    back = t_state.carry_to_jax(carry)
    for a, b in zip(back, jcarry):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a hierarchical carry: the (hp, lp) pair of packet tails
    lp = rng.integers(0, 256, (12, 188)).astype(np.uint8)
    hcarry = ((jcarry[0], lp),) + jcarry[1:]
    carry = t_state.carry_from_jax(hcarry, CPU)
    assert isinstance(carry[0], tuple) and len(carry[0]) == 2
    back = t_state.carry_to_jax(carry)
    for a, b in zip(back[0], hcarry[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="packet tail"):
        t_state.carry_from_jax((jcarry[1],) + jcarry[1:], CPU)
