"""Viterbi decoding of the punctured K=7 inner code (R7), EN300744 §4.3.3.

Counterpart of dvbt_tpu/ops/viterbi.py with the contract of the JAX
package's punctured decoder (kernels/viterbi_pallas.py
``make_viterbi_decoder_punctured``): the coded soft stream (uint8 0..15)
goes in, info bytes come out, and the carried state is the ``{x, y, xm,
ym}`` tail of the last ``overlap`` mother-code steps.  The work is kernel K1
(kernels/viterbi.py).

Window geometry.  The stream is decoded in overlapped windows of
``body + 2*overlap`` steps, and the output depends on (body, overlap)
wherever the noise leaves the decision open.  The JAX package's jnp decoder
(its CPU path) uses body 1024; its Pallas decoder derives the body from the
TPU's VMEM budget.  The default here is ``body=DEFAULT_BODY=1024`` and
``overlap=effective_overlap(rate)``, so that this receiver reproduces the
JAX receiver on CPU byte for byte, noise included.  Tuning the body for
the H100 is later work.
"""

from __future__ import annotations

import torch

from ..kernels import viterbi as kvit
from ..utils import puncture
from . import inner_coder

DEFAULT_OVERLAP = 128
DEFAULT_BODY = 1024


def effective_overlap(rate: str, overlap: int = DEFAULT_OVERLAP) -> int:
    """Overlap rounded up to lcm(8, puncture period): the carried tail is
    byte- and puncture-phase aligned (the JAX package's rule)."""
    align = puncture.pattern(rate).align
    return -(-overlap // align) * align


def make_viterbi_decoder(n_bits: int, rate: str, body: int = DEFAULT_BODY,
                         overlap: int | None = None):
    """Returns decode(state, coded) -> (state', bytes).

    coded: uint8 (n_mux, n_bits//period*keep) punctured soft stream 0..15;
    state: {'x','y','xm','ym'} uint8 (n_mux, overlap) tail of the previous
    block (all zero at stream start: an erasure warm-up);
    bytes: uint8 (n_mux, n_bits//8) decoded info bytes, MSB-first."""
    ov = effective_overlap(rate) if overlap is None else overlap
    period, keep, _, _, _ = puncture.pattern(rate)
    if n_bits % 8 or n_bits % period or ov % period or ov > n_bits:
        raise ValueError(f"n_bits={n_bits}, overlap={ov} do not fit rate "
                         f"{rate} (whole bytes and puncture periods, "
                         f"overlap <= block)")
    if body % 8 or body <= 0:
        raise ValueError(f"body={body} must be a positive multiple of 8")
    ov_c = ov // period * keep
    depunct_tail = inner_coder.make_depuncture(ov, rate)

    def decode(state: dict, coded: torch.Tensor):
        tail = torch.stack([state[k] for k in ("x", "y", "xm", "ym")],
                           dim=-2)
        out = kvit.viterbi_punct(coded, tail, n_bits, rate, body)
        x, y, xm, ym = depunct_tail(coded[..., coded.shape[-1] - ov_c:])
        new_state = {"x": x, "y": y, "xm": xm.contiguous(),
                     "ym": ym.contiguous()}
        return new_state, out

    return decode


def init_state(n_mux: int, overlap: int, device) -> dict:
    """All-zero {x, y, xm, ym} (n_mux, overlap) tails: an erasure warm-up."""
    return kvit.init_state(n_mux, device, overlap)
