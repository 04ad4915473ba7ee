"""Punctured convolutional inner coder K=7 (T4) and RX depuncturing,
EN300744 §4.3.3 (G1=171o, G2=133o, Table 3 puncturing).

Counterpart of dvbt_tpu/ops/inner_coder.py and of the byte-stream contract
of dvbt_tpu/kernels/coder_pallas.py: the coder takes the outer
interleaver's BYTE stream and carries the last 6 stream bits, (n_mux, 6)
uint8 oldest first.  The work is kernel K2 (kernels/coder.py).
"""

from __future__ import annotations

import torch

from ..kernels import coder as kcoder
from ..utils import puncture


def make_inner_coder(n_bytes: int, rate: str):
    """Returns apply(state6, stream) -> (state6', coded_bits).

    stream: uint8 (n_mux, n_bytes); coded_bits: uint8 {0,1}
    (n_mux, n_bytes*8*den/num) in Table-3 serial order."""
    period = puncture.pattern(rate).period
    if (n_bytes * 8) % period:
        raise ValueError(f"{n_bytes} bytes is not a whole number of rate-"
                         f"{rate} puncture periods")

    def apply(state6: torch.Tensor, stream: torch.Tensor):
        return kcoder.byte_coder(state6, stream, rate)

    return apply


def make_depuncture(n_info_bits: int, rate: str):
    """Returns depuncture(coded) -> (x, y, x_known, y_known), each
    (..., n_info_bits): erasures re-inserted at punctured positions (value
    0, known 0).  Input dtype is preserved."""
    period, keep, _, rank, _ = puncture.pattern(rate)
    if n_info_bits % period:
        raise ValueError(f"{n_info_bits} bits is not a whole number of "
                         f"rate-{rate} puncture periods")
    n_blk = n_info_bits // period
    known = [int(r >= 0) for r in rank]
    # the x and y masks, (n_info_bits,) each, built once per device: a
    # host-to-device copy every call would block the host and cannot be
    # captured into a CUDA graph
    masks = {}

    def depuncture(coded: torch.Tensor):
        lead = coded.shape[:-1]
        c = coded.reshape(*lead, n_blk, keep)
        zeros = torch.zeros(c.shape[:-1], dtype=coded.dtype,
                            device=coded.device)
        cols = [zeros if rank[r] < 0 else c[..., rank[r]]
                for r in range(2 * period)]
        x = torch.stack(cols[0::2], dim=-1).reshape(*lead, n_info_bits)
        y = torch.stack(cols[1::2], dim=-1).reshape(*lead, n_info_bits)
        if coded.device not in masks:
            kn = torch.tensor(known, dtype=torch.uint8, device=coded.device)
            masks[coded.device] = (kn[0::2].repeat(n_blk),
                                   kn[1::2].repeat(n_blk))
        kx, ky = masks[coded.device]
        return (x, y, kx.expand(*lead, n_info_bits),
                ky.expand(*lead, n_info_bits))

    return depuncture


def init_state(n_mux: int, device) -> torch.Tensor:
    return torch.zeros(n_mux, 6, dtype=torch.uint8, device=device)
