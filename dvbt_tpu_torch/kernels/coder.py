"""K2 — byte stream -> punctured K=7 coded bits (TX inner coder, T4).

Replaces ``dvbt_tpu/kernels/coder_pallas.py::_coder_kernel`` (built by
``make_byte_coder``).  The CUDA kernel is ``csrc/coder.cu``; like the Pallas
kernel it runs the mother code on packed bytes and expands bits only at
the end: one thread per ``period`` input bytes (8 puncture periods) holds
them, with the byte before (the carried 6-bit state at a row's start), in
one register word, forms every x and y bit of its unit with shifted-word
XORs, picks the coded bytes in Table-3 serial order (one template
instantiation a rate) and stages them in shared memory, from which each
block writes its run of the row with 16-byte stores.  On the H100 it is
bound by those byte stores (one byte per coded bit, ~9.9 MB per 8K mux at
rate 2/3).  The plain version below is the same contract in PyTorch.

Dispatch is by tensor device only: CPU tensors take the plain version, CUDA
tensors the kernel (or an error).  ``_build.launches`` counts its
launches as ``byte_coder``.
"""

from __future__ import annotations

import torch

from ..utils import bits as bitutils
from ..utils import puncture
from . import _build


def _next_state(stream: torch.Tensor) -> torch.Tensor:
    """Last 6 stream bits (oldest first) = bits 2..7 of the last byte."""
    sh = torch.arange(5, -1, -1, dtype=torch.uint8, device=stream.device)
    return (stream[..., -1:] >> sh) & 1


def byte_coder_plain(state6: torch.Tensor, stream: torch.Tensor,
                     rate: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(state6 (..., 6), stream (..., n_bytes)) uint8 ->
    (state6', coded (..., n_bytes*8*den/num) uint8 {0,1})."""
    period, _, order, _, _ = puncture.pattern(rate)
    bits = bitutils.bytes_to_bits(stream)
    n = bits.shape[-1]
    full = torch.cat([state6.to(torch.uint8), bits], dim=-1)

    def taps(delays):
        acc = full[..., 6:6 + n]
        for d in delays:
            acc = acc ^ full[..., 6 - d:6 - d + n]
        return acc

    x = taps((1, 2, 3, 6))                     # G1 = 171o
    y = taps((2, 3, 5, 6))                     # G2 = 133o
    xy = torch.stack([x, y], dim=-1).reshape(*bits.shape[:-1], n // period,
                                             2 * period)
    idx = torch.tensor(order, dtype=torch.long, device=stream.device)
    coded = xy.index_select(-1, idx).reshape(*bits.shape[:-1], -1)
    return _next_state(stream), coded


def byte_coder(state6: torch.Tensor, stream: torch.Tensor,
               rate: str) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if stream.device.type == "cpu":
        return byte_coder_plain(state6, stream, rate)
    period, keep, order, _, _ = puncture.pattern(rate)
    n_bytes = stream.shape[-1]
    if stream.device.type != "cuda" or state6.device != stream.device:
        raise ValueError(f"byte_coder: stream on {stream.device}, state on "
                         f"{state6.device}; the kernel takes CUDA tensors")
    if stream.dtype != torch.uint8 or state6.dtype != torch.uint8:
        raise TypeError("byte_coder: stream and state6 must be uint8")
    if not (stream.is_contiguous() and state6.is_contiguous()):
        raise ValueError("byte_coder: stream and state6 must be contiguous")
    if state6.shape != stream.shape[:-1] + (6,):
        raise ValueError(f"byte_coder: state6 {tuple(state6.shape)} does not "
                         f"match stream {tuple(stream.shape)}")
    if n_bytes == 0 or (n_bytes * 8) % period:
        raise ValueError(f"byte_coder: {n_bytes} bytes is not a whole number "
                         f"of rate-{rate} puncture periods")
    n_mux = stream.numel() // n_bytes
    n_coded = n_bytes * 8 // period * keep
    if n_coded >= 2**31:
        raise ValueError(f"byte_coder: {n_coded} coded bits a row; the kernel "
                         "indexes a row with 32 bits")
    out = torch.empty(stream.shape[:-1] + (n_coded,), dtype=torch.uint8,
                      device=stream.device)
    order_packed = sum(o << (4 * r) for r, o in enumerate(order))
    lib = _build.library()
    code = lib.dvbt_byte_coder(
        stream.data_ptr(), state6.data_ptr(), out.data_ptr(), n_mux, n_bytes,
        n_coded, period, keep, order_packed,
        torch.cuda.current_stream(stream.device).cuda_stream)
    _build.check(code, "dvbt_byte_coder", kernel="byte_coder")
    return _next_state(stream), out
