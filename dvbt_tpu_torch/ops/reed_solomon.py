"""Reed-Solomon RS(204,188,T=8) encode/decode (T2 / R9), EN300744 §4.3.2.

Counterpart of dvbt_tpu/ops/reed_solomon.py with the same contract.  The
encoder is built from GF(2^8) table gathers instead of the JAX package's
bit-sliced GF(2) matmuls (those exist for the TPU's lack of fast
gathers): parity is GF(2)-linear in the message bytes, so it is one gather
from a (position, byte value) -> 16-byte product table followed by an XOR
reduction over the positions.  The decoder is ``kernels/rs.py``: the CUDA
kernel on CUDA tensors, its plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..kernels import rs as krs
from ..kernels.rs import _linear_map, _linear_table

RS_N, RS_K, RS_T = tables.RS_N, tables.RS_K, tables.RS_T
RS_2T = 2 * RS_T


def make_rs_encoder(device):
    """Returns encode(msg): uint8 (..., 188) -> (..., 204) systematic."""
    g = tables.rs_generator_poly()
    # parity = XOR_p msg_p * rem(x^(203-p) mod g), coefficients high-first
    rem = np.zeros((RS_N, RS_2T), np.int64)
    cur = np.zeros(RS_2T, np.int64)
    cur[-1] = 1                                      # x^0
    for d in range(RS_N):
        rem[d] = cur
        lead = cur[0]                                # multiply by x
        cur = np.concatenate([cur[1:], [0]])
        if lead:
            cur = cur ^ tables.gf_mul(g[1:], lead)
    table = torch.as_tensor(_linear_table(rem[RS_N - 1 - np.arange(RS_K)]),
                            device=device)

    def encode(msg: torch.Tensor) -> torch.Tensor:
        return torch.cat([msg, _linear_map(msg, table)], dim=-1)

    return encode


def make_rs_decoder(device):
    """Returns decode(cw): uint8 (..., 204) ->
    (msg uint8 (..., 188), n_corrected int32 (...,), uncorrectable bool).
    CUDA tensors run the RS kernel, CPU tensors its plain version; the
    kernel's tables are made here, outside any CUDA graph capture."""
    device = torch.device(device)
    lut = krs.decoder_tables(device) if device.type == "cuda" else None
    return functools.partial(krs.rs_decode, lut=lut)
