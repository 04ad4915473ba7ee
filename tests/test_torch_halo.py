"""The port's halo recompute (dvbt_tpu_torch/parallel/time_sharding.py)
against the JAX package's on the CPU, in one process: the halo size of
every non-hierarchical mode, the TX state from a 12-packet halo, the RX
state from a real transmitted sample halo, and the time-sharded carry
handed across in both directions.  Inputs come from seeded numpy."""

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


@pytest.mark.parametrize("mode", NON_HIERARCHICAL, ids=_mid)
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
    with pytest.raises(NotImplementedError, match="item 20"):
        t_state.carry_from_jax(((jcarry[0], jcarry[0]),) + jcarry[1:], CPU)
