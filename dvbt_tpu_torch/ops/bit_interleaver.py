"""Bit-wise inner interleaver (T5 / R6), EN300744 §4.3.4.1.

Counterpart of dvbt_tpu/ops/bit_interleaver.py.  Demux, the six 126-bit
cyclic block interleavers and the bits -> cell packing compose into one
static permutation, identical for every 126-cell block; here it is an index
gather from ``tables.bit_interleaver_indices`` (the JAX package applies it
as a one-hot matmul, which suits the TPU's MXU).  Stateless.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..mode import DvbtMode


def _block_dims(mode: DvbtMode):
    blk = tables.bit_interleaver_indices(mode.v, mode.hierarchical)
    n_blocks = mode.n_payload // tables.BIT_ILV_BLOCK
    nbb = tables.BIT_ILV_BLOCK * mode.v          # coded bits per block
    return blk, n_blocks, nbb


def make_bit_interleaver(mode: DvbtMode, device):
    """Returns interleave(bits): uint8 (..., n_payload*v) -> int32 cells
    (..., n_payload), y0 the cell MSB."""
    blk, n_blocks, nbb = _block_dims(mode)
    v = mode.v
    src = torch.as_tensor(blk.reshape(-1).astype(np.int64), device=device)
    weight = (1 << torch.arange(v - 1, -1, -1, device=device)).to(torch.int32)

    def interleave(b: torch.Tensor) -> torch.Tensor:
        x = b.reshape(*b.shape[:-1], n_blocks, nbb)
        picked = x.index_select(-1, src).reshape(*x.shape[:-1],
                                                 tables.BIT_ILV_BLOCK, v)
        cells = (picked.to(torch.int32) * weight).sum(-1, dtype=torch.int32)
        return cells.reshape(*b.shape[:-1], mode.n_payload)

    return interleave


def _inverse(mode: DvbtMode, device) -> torch.Tensor:
    """Coded position k of a 126-cell block reads in-block value inv[k]
    (bit j of cell c is value c*v + j)."""
    blk, _, nbb = _block_dims(mode)
    inv = np.empty(nbb, np.int64)
    inv[blk.reshape(-1)] = np.arange(nbb)
    return torch.as_tensor(inv, device=device)


def make_bit_deinterleaver(mode: DvbtMode, device, scale: int = 1):
    """Returns deinterleave(cells): int32 (..., n_payload) -> uint8
    bits*scale (..., n_payload*v) in coded-stream order.  ``scale=15``
    gives hard decisions as saturated soft metrics {0, 15}."""
    _, n_blocks, nbb = _block_dims(mode)
    v = mode.v
    inv = _inverse(mode, device)
    sh = torch.arange(v - 1, -1, -1, dtype=torch.int32, device=device)

    def deinterleave(cells: torch.Tensor) -> torch.Tensor:
        cell_bits = ((cells.to(torch.int32).unsqueeze(-1) >> sh) & 1)
        x = cell_bits.reshape(*cells.shape[:-1], n_blocks, nbb)
        out = x.index_select(-1, inv).to(torch.uint8) * scale
        return out.reshape(*cells.shape[:-1], mode.n_payload * v)

    return deinterleave


def make_soft_bit_deinterleaver(mode: DvbtMode, device):
    """Returns deinterleave(soft): uint8 (..., n_payload, v) per-bit
    metrics in cell order (bit j = y_j) -> uint8 (..., n_payload*v) in
    coded-stream order: the hard path's permutation, applied to values."""
    _, n_blocks, nbb = _block_dims(mode)
    inv = _inverse(mode, device)

    def deinterleave(soft: torch.Tensor) -> torch.Tensor:
        x = soft.reshape(*soft.shape[:-2], n_blocks, nbb)
        out = x.index_select(-1, inv)
        return out.reshape(*soft.shape[:-2], mode.n_payload * mode.v)

    return deinterleave
