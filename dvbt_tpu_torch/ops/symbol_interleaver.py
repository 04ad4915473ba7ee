"""Symbol inner interleaver H(q) (T6 / R5), EN300744 §4.3.4.2.

Counterpart of dvbt_tpu/ops/symbol_interleaver.py.  Only the static
permutation pair is needed here: the frame builder and the cell
deinterleaver (ops/reference_signals.py) fuse it into their own gathers.
"""

from __future__ import annotations

import numpy as np

from dvbt_tpu.mode import DvbtMode


def _perm_pair(mode: DvbtMode, deinterleave: bool) -> np.ndarray:
    """(2, n_payload) int32: row 0 = even-symbol gather, row 1 = odd."""
    h = mode.symbol_interleaver_perm().astype(np.int64)
    hinv = np.empty_like(h)
    hinv[h] = np.arange(len(h), dtype=np.int64)
    # TX even symbols: out[H[q]] = in[q]  -> gather with Hinv
    # TX odd  symbols: out[q]    = in[H[q]] -> gather with H
    even, odd = (h, hinv) if deinterleave else (hinv, h)
    return np.stack([even, odd]).astype(np.int32)
