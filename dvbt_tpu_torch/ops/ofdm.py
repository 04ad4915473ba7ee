"""OFDM modulation / demodulation (T9 / R2) and symbol acquisition (R1),
EN300744 §4.4 + Table 5.

Counterpart of dvbt_tpu/ops/ofdm.py: ``torch.fft`` with norm="ortho" on
whole batches of symbols, the same carrier <-> FFT bin map (active
spectrum centred on DC), and the one-shot CP-correlation timing and
fractional-CFO estimator (``kernels/acquire.py``), batched over a
leading mux axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import acquire as kacquire
from ..mode import DvbtMode


@functools.lru_cache(maxsize=None)
def _bin_map(mode: DvbtMode) -> np.ndarray:
    """Carrier k (0..Kmax) -> FFT bin ((k - Kmax/2) mod N)."""
    k = np.arange(mode.n_carriers)
    return ((k - mode.kmax // 2) % mode.fft_len).astype(np.int64)


def make_ofdm_modulator(mode: DvbtMode, device):
    """Returns modulate(carriers): complex64 (..., n_sym, K) ->
    (..., n_sym*(N+guard)) time-domain baseband, cyclic prefix first."""
    bins = torch.as_tensor(_bin_map(mode), device=device)
    N, G = mode.fft_len, mode.guard_len

    def modulate(carriers: torch.Tensor) -> torch.Tensor:
        spec = carriers.new_zeros(*carriers.shape[:-1], N)
        spec[..., bins] = carriers
        x = torch.fft.ifft(spec, dim=-1, norm="ortho")
        with_cp = torch.cat([x[..., N - G:], x], dim=-1)
        return with_cp.reshape(*carriers.shape[:-2], -1)

    return modulate


def make_ofdm_demodulator(mode: DvbtMode, device, n_sym: int | None = None):
    """Returns demodulate(iq): complex64 (..., n_sym*(N+guard)) symbol-
    aligned baseband -> carriers (..., n_sym, K).  With ``n_sym`` given,
    the input must hold exactly that many symbols."""
    bins = torch.as_tensor(_bin_map(mode), device=device)
    N, G = mode.fft_len, mode.guard_len

    def demodulate(iq: torch.Tensor) -> torch.Tensor:
        if n_sym is not None and iq.shape[-1] != n_sym * (N + G):
            raise ValueError(f"{iq.shape[-1]} samples are not {n_sym} "
                             "symbols")
        syms = iq.reshape(*iq.shape[:-1], -1, N + G)[..., G:]
        return torch.fft.fft(syms, dim=-1, norm="ortho").index_select(-1,
                                                                     bins)

    return demodulate


def make_symbol_acquisition(mode: DvbtMode, n_samples: int):
    """The ``ofdm_sym_acquisition`` block: CP-correlation timing and
    fractional CFO of raw captures, acquire(iq) -> (theta, cfo_frac) (see
    ``kernels.acquire.make_symbol_acquisition``: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors).  The synchronizer calls it
    through this module attribute."""
    return kacquire.make_symbol_acquisition(mode, n_samples)
