"""Bit/byte packing helpers, MSB-first (EN 300 744 serialization).

Counterpart of dvbt_tpu/utils/bits.py: bit 0 of a byte is its MSB, the
order in which bytes enter the inner coder [EN300744 §4.3.3].
"""

from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 -> (..., n*8) uint8 in {0,1}, MSB-first."""
    bits = (x.unsqueeze(-1) >> _shifts(x.device)) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8)


def bits_to_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., n*8) uint8 in {0,1} -> (..., n) uint8, MSB-first."""
    g = b.reshape(*b.shape[:-1], b.shape[-1] // 8, 8).to(torch.int32)
    w = (1 << _shifts(b.device).to(torch.int32))
    return (g * w).sum(dim=-1).to(torch.uint8)
