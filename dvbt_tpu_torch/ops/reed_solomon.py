"""Reed-Solomon RS(204,188,T=8) encode/decode (T2 / R9), EN300744 §4.3.2.

Counterpart of dvbt_tpu/ops/reed_solomon.py with the same contract.  Both
directions are ``kernels/rs.py``: the CUDA kernel on CUDA tensors, its
plain PyTorch version on CPU tensors.  The plain encoder is built from
GF(2^8) table gathers instead of the JAX package's bit-sliced GF(2)
matmuls (those exist for the TPU's lack of fast gathers); the kernel
divides by g(x) with an LFSR, one thread a packet.
"""

from __future__ import annotations

import functools

import torch

from .. import tables
from ..kernels import rs as krs

RS_N, RS_K, RS_T = tables.RS_N, tables.RS_K, tables.RS_T


def _kernel_tables(device) -> torch.Tensor | None:
    """The RS kernels' tables on a CUDA device, None on the CPU."""
    device = torch.device(device)
    return krs.decoder_tables(device) if device.type == "cuda" else None


def make_rs_encoder(device):
    """Returns encode(msg): uint8 (..., 188) -> (..., 204) systematic.
    CUDA tensors run the RS encode kernel, CPU tensors its plain version;
    the kernel's table is made here, outside any CUDA graph capture."""
    return functools.partial(krs.rs_encode, lut=_kernel_tables(device))


def make_rs_decoder(device):
    """Returns decode(cw): uint8 (..., 204) ->
    (msg uint8 (..., 188), n_corrected int32 (...,), uncorrectable bool).
    CUDA tensors run the RS kernel, CPU tensors its plain version; the
    kernel's tables are made here, outside any CUDA graph capture."""
    return functools.partial(krs.rs_decode, lut=_kernel_tables(device))
