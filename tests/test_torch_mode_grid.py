"""The port's TX -> RX chain over the reference's mode grid, on the CPU.

Every (constellation x code rate) pair at 2K, cycling the four guard
intervals (the grid of tests/test_mode_grid.py), one block each: the
port's chain, with the kernels' plain versions, must return the sent
packets after the 11-packet delay with no uncorrectable packet.  One case
per guard holds the port's TX IQ against the JAX transmitter's within the
golden tolerance (the guard decides the cyclic prefix).  The 8K spot
checks are slow-marked, as in the reference."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.mode import DvbtMode
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
DELAY = 11
GUARDS = ("1/32", "1/16", "1/8", "1/4")
GRID = [
    (c, r, GUARDS[i % 4])
    for i, (c, r) in enumerate(itertools.product(
        ("qpsk", "16qam", "64qam"), ("1/2", "2/3", "3/4", "5/6", "7/8")))
]
# one grid case per guard, across the three constellations
PER_GUARD = [GRID[0], GRID[5], GRID[10], GRID[7]]
assert sorted(g for _, _, g in PER_GUARD) == sorted(GUARDS)


def _port_tx(mode, packets):
    pm = port_mode(mode)
    tx, _, _ = t_tx.make_transmitter(pm, "cpu")
    _, iq = tx(t_tx.init_tx_state(pm, 1, "cpu"),
               torch.from_numpy(packets)[None])
    return iq


def _one_block_loopback(mode):
    pm = port_mode(mode)
    _, n_pk, _ = t_tx.make_transmitter(pm, "cpu")
    rx, _, _ = t_rx.make_receiver(pm, "cpu", metrics="min")
    packets = make_ts_packets(n_pk, seed=4)
    _, out, m = rx(t_rx.init_rx_state(pm, 1, "cpu"), _port_tx(mode, packets))
    out = out[0].numpy()
    assert np.array_equal(out[DELAY:], packets[:len(out) - DELAY]), mode
    assert not m["rs_uncorrectable"][0, DELAY:].any(), mode


@pytest.mark.parametrize("const,rate,guard", GRID)
def test_port_mode_grid_2k(const, rate, guard):
    _one_block_loopback(DvbtMode("2k", const, rate, guard))


@pytest.mark.parametrize("const,rate,guard", PER_GUARD)
def test_port_tx_matches_jax_at_each_guard(const, rate, guard):
    mode = DvbtMode("2k", const, rate, guard)
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    packets = make_ts_packets(n_pk, seed=5)
    _, want = tx(j_tx.init_tx_state(mode), jnp.asarray(packets))
    got = _port_tx(mode, packets)[0].numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("const,rate,guard", [
    ("16qam", "3/4", "1/4"),
    ("64qam", "5/6", "1/16"),
])
def test_port_mode_grid_8k(const, rate, guard):
    _one_block_loopback(DvbtMode("8k", const, rate, guard))
