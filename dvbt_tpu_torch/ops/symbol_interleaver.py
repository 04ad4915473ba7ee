"""Symbol inner interleaver H(q) (T6 / R5), EN300744 §4.3.4.2.

Counterpart of dvbt_tpu/ops/symbol_interleaver.py.  The static
permutation pair H / H^-1 serves the ``symbol_inner_interleaver`` block
(``make_symbol_interleaver``) and is fused into the gathers of the frame
builder and the cell deinterleaver (ops/reference_signals.py) on the
flagship path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mode import SYMBOLS_PER_FRAME, DvbtMode


def _perm_pair(mode: DvbtMode, deinterleave: bool) -> np.ndarray:
    """(2, n_payload) int32: row 0 = even-symbol gather, row 1 = odd."""
    h = mode.symbol_interleaver_perm().astype(np.int64)
    hinv = np.empty_like(h)
    hinv[h] = np.arange(len(h), dtype=np.int64)
    # TX even symbols: out[H[q]] = in[q]  -> gather with Hinv
    # TX odd  symbols: out[q]    = in[H[q]] -> gather with H
    even, odd = (h, hinv) if deinterleave else (hinv, h)
    return np.stack([even, odd]).astype(np.int32)


def make_symbol_interleaver(mode: DvbtMode, device,
                            n_sym: int = SYMBOLS_PER_FRAME,
                            deinterleave: bool = False):
    """Returns apply(cells): (..., n_sym, n_payload) -> same shape, H(q)-
    permuted (H^-1 with ``deinterleave``).  Row 0 must be symbol l=0 of a
    frame, so that the even/odd rule lands on the right rows."""
    if n_sym % 2 and n_sym != 1:
        raise ValueError(f"n_sym={n_sym} must be even (or 1)")
    pair = torch.as_tensor(_perm_pair(mode, deinterleave).astype(np.int64),
                           device=device)
    idx = pair.repeat(max(n_sym // 2, 1), 1)[:n_sym]

    def apply(cells: torch.Tensor) -> torch.Tensor:
        return torch.gather(cells, -1, idx.expand(cells.shape))

    return apply
