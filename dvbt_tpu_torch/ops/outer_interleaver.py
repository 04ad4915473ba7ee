"""Forney convolutional byte inter/deinterleaver I=12, M=17 (T3 / R8),
EN300744 §4.3.1 Fig 5.

Counterpart of dvbt_tpu/ops/outer_interleaver.py.  Byte i of the stream
passes branch j = i mod 12 with a delay of j*204 stream bytes; on the
(packets, 204) board column p of output packet k is board row k + shift[p]
of [carried tail (11 packets) | block].  That is one static index gather
per block.  The carried state is the last 2244 bytes (11 * 204) of input.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mode import OUTER_I, RS_PACKET

TAIL = (OUTER_I - 1) * RS_PACKET  # 2244 bytes of carried history
# the stream's delay through interleaver and deinterleaver: 11 packets
DELAY_PACKETS = TAIL // RS_PACKET


def _make(n_bytes: int, deinterleave: bool, device):
    if n_bytes % RS_PACKET:
        raise ValueError(f"{n_bytes} bytes is not a whole number of "
                         f"{RS_PACKET}-byte packets")
    n_pk = n_bytes // RS_PACKET
    r = np.arange(RS_PACKET) % OUTER_I
    d = (OUTER_I - 1 - r) if deinterleave else r
    shift = (OUTER_I - 1) - d                       # (204,) in [0, 11]
    k = np.arange(n_pk)[:, None]
    idx = ((k + shift[None, :]) * RS_PACKET + np.arange(RS_PACKET)[None, :])
    idx = torch.as_tensor(idx.reshape(-1), device=device)

    def apply(tail: torch.Tensor, x: torch.Tensor):
        """tail uint8 (n_mux, 2244), x uint8 (n_mux, n_bytes) -> (tail', y)."""
        board = torch.cat([tail, x], dim=-1)
        return board[..., -TAIL:], board.index_select(-1, idx)

    return apply


def make_outer_interleaver(n_bytes: int, device):
    """``n_bytes`` must be a multiple of 204 (whole RS packets)."""
    return _make(n_bytes, deinterleave=False, device=device)


def make_outer_deinterleaver(n_bytes: int, device):
    """Inverse; interleaver then deinterleaver is a 2244-byte delay."""
    return _make(n_bytes, deinterleave=True, device=device)


def init_state(n_mux: int, device) -> torch.Tensor:
    return torch.zeros(n_mux, TAIL, dtype=torch.uint8, device=device)
