"""OFDM modulation / demodulation (T9 / R2) and symbol acquisition (R1),
EN300744 §4.4 + Table 5.

Counterpart of dvbt_tpu/ops/ofdm.py: ``torch.fft`` with norm="ortho" on
whole batches of symbols, the same carrier <-> FFT bin map (active
spectrum centred on DC), and the one-shot CP-correlation timing and
fractional-CFO estimator, batched over a leading mux axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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
    """One-shot timing + fractional CFO estimator over a sample block (the
    ``ofdm_sym_acquisition`` block).

    Returns acquire(iq): complex64 (..., n_samples) -> (theta int32 (...),
    offset of the first complete symbol start in [0, N+guard); cfo_frac
    float32 (...), fractional carrier offset in subcarriers).

    CP correlation gamma(n) = sum_{k<G} r[n+k] conj(r[n+k+N]) minus an
    energy term, folded over all whole symbol periods and argmaxed; the
    CFO is the phase of the folded gamma at the peak.  The moving sums are
    differences of running sums, taken in double precision: over a whole
    capture a single-precision running sum loses the few-sample window
    sums to round-off."""
    N, G = mode.fft_len, mode.guard_len
    L = N + G
    n_folds = (n_samples - N - G) // L
    if n_folds < 1:
        raise ValueError("need at least one full symbol for acquisition")
    rho = 0.1  # SNR-dependent energy weight; modest value is robust

    def acquire(iq: torch.Tensor):
        r = iq.to(torch.complex128)
        a, b = r[..., : n_samples - N], r[..., N:]
        prod = a * b.conj()
        eng = (a.abs() ** 2 + b.abs() ** 2) * 0.5
        cs = torch.nn.functional.pad(torch.cumsum(prod, -1), (1, 0))
        ce = torch.nn.functional.pad(torch.cumsum(eng, -1), (1, 0))
        gamma = cs[..., G:] - cs[..., :-G]           # (..., n_samples-N-G+1)
        phi = ce[..., G:] - ce[..., :-G]
        metric = gamma.abs() - rho * phi
        usable = n_folds * L
        m = metric[..., :usable].reshape(*metric.shape[:-1], n_folds, L)
        g = gamma[..., :usable].reshape(*metric.shape[:-1], n_folds, L)
        theta = m.sum(-2).argmax(-1)
        g_sum = torch.gather(g.sum(-2), -1, theta[..., None])[..., 0]
        cfo = (-torch.angle(g_sum) / (2.0 * np.pi)).to(torch.float32)
        return theta.to(torch.int32), cfo

    return acquire
