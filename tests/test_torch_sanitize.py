"""The port's numeric sanitizer (utils/sanitize.py) on the CPU, as
tests/test_sanitize.py holds the JAX package's checkify wrapper: the
checked receiver passes a clean block with the plain receiver's output,
and a NaN-poisoned block raises FloatingPointError naming the op.  The
JAX donation-aliasing test has no counterpart: the port donates
nothing."""

import numpy as np
import pytest
import torch

from dvbt_tpu_torch import MODE_2K_QPSK, make_ts_packets
from dvbt_tpu_torch.models import rx as rxm
from dvbt_tpu_torch.models import tx as txm
from dvbt_tpu_torch.utils import sanitize

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODE = MODE_2K_QPSK


def _one_block():
    tx, n_pk, _ = txm.make_transmitter(MODE, CPU)
    _, iq = tx(txm.init_tx_state(MODE, 1, CPU),
               torch.from_numpy(make_ts_packets(n_pk))[None])
    return iq


def test_checked_receiver_clean_signal_passes():
    rx, n_pk, _ = sanitize.make_checked_receiver(MODE, CPU)
    iq = _one_block()
    state, ts, metrics = rx(rxm.init_rx_state(MODE, 1, CPU), iq)
    assert ts.shape == (1, n_pk, 188)
    assert int(metrics["rs_uncorrectable"].sum()) in (0, 11)  # warm-up
    plain, _, _ = rxm.make_receiver(MODE, CPU)
    _, ts_p, m_p = plain(rxm.init_rx_state(MODE, 1, CPU), iq)
    assert torch.equal(ts, ts_p)
    assert torch.equal(metrics["rs_uncorrectable"], m_p["rs_uncorrectable"])
    assert torch.equal(metrics["mer_db"], m_p["mer_db"])


def test_checked_receiver_flags_nan_poisoned_signal():
    rx, _, _ = sanitize.make_checked_receiver(MODE, CPU)
    bad = _one_block().clone()
    bad[0, 12345] = complex(float("nan"), 0.0)
    with pytest.raises(FloatingPointError, match=r"^aten\.\S+ produced NaN"):
        rx(rxm.init_rx_state(MODE, 1, CPU), bad)


def test_checked_names_the_op_that_makes_the_inf():
    f = sanitize.checked(lambda x: (x + 1.0) / x)
    assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
    with pytest.raises(FloatingPointError, match=r"^aten\.div\.Tensor "):
        f(torch.tensor([1.0, 0.0]))
    # integer results are not scanned, and the mode ends with the call
    assert sanitize.checked(lambda x: x // 1)(torch.arange(3)).tolist() == \
        [0, 1, 2]
    assert torch.isinf(torch.tensor([1.0]) / 0).all()
