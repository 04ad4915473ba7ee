"""CP-correlation symbol acquisition (R1; the ``ofdm_sym_acquisition``
block): the CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package leaves the acquisition to XLA.
The plain version takes the CP-correlation window sums as differences of
float64 and complex128 running sums over each whole capture, then folds
the metric over the symbol periods; on the card that is ~20 operations,
two of them scans that keep only a few SMs busy, and ~10 full-size float64
intermediates.  The kernel (``csrc/acquire.cu``) reads the capture about
once: a block takes a tile of timing candidates over a group of symbol
periods and forms each window sum from a float64 scan over the tile in
shared memory; a second launch of one block a capture sums the groups in a
fixed order and picks theta and the carrier offset.  Its bound is the
capture's bytes (complex64, read once).

Dispatch is by tensor device only: CPU tensors take the plain version,
CUDA tensors the kernel (or an error).  ``_build.launches`` counts its
launches as ``acquire``, one a call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mode import DvbtMode
from . import _build

RHO = 0.1             # energy weight of the metric; csrc/acquire.cu's kRho
ELEMS = 4             # samples a thread scans; csrc/acquire.cu's kElems
# (largest guard, threads of a fold block): a tile stages 4 x threads
# samples, so its timing candidates T = 4 x threads - G + 1 stay >= G
THREADS_BY_GUARD = ((256, 256), (1024, 512), (2048, 1024))
BLOCKS_PER_SM = 8     # fold blocks a pass aims at, per SM (2 waves of 4)


def _folds(mode: DvbtMode, n_samples: int) -> int:
    n_folds = (n_samples - mode.fft_len - mode.guard_len) // mode.symbol_len
    if n_folds < 1:
        raise ValueError("need at least one full symbol for acquisition")
    return n_folds


def make_symbol_acquisition_plain(mode: DvbtMode, n_samples: int):
    """The plain version: acquire(iq) -> (theta, cfo_frac) as
    ``make_symbol_acquisition`` documents, from running sums in double
    precision over each whole capture."""
    N, G = mode.fft_len, mode.guard_len
    L = N + G
    n_folds = _folds(mode, n_samples)
    rho = RHO  # SNR-dependent energy weight; modest value is robust

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


def geometry(mode: DvbtMode, n_folds: int, n_rows: int, n_sm: int) -> dict:
    """The kernel's launch geometry: ``threads`` of a fold block (by the
    guard), ``tile`` timing candidates a block (``n_tiles`` of them cover
    the symbol period, the last may be short; tile + G - 1 <= 4 x
    threads), and ``n_groups`` contiguous groups of the ``n_folds`` symbol
    periods, enough for ``BLOCKS_PER_SM`` blocks on each of ``n_sm`` SMs
    where the periods allow."""
    G, L = mode.guard_len, mode.symbol_len
    threads = next((t for g, t in THREADS_BY_GUARD if G <= g), None)
    if threads is None:
        raise ValueError(f"acquisition: guard of {G} samples is over "
                         f"{THREADS_BY_GUARD[-1][0]}")
    n_tiles = -(-L // (ELEMS * threads - G + 1))
    tile = -(-L // n_tiles)
    n_groups = min(n_folds, -(-BLOCKS_PER_SM * n_sm // (n_rows * n_tiles)))
    return {"threads": threads, "tile": tile, "n_tiles": n_tiles,
            "n_groups": n_groups}


def _check_input(iq: torch.Tensor, n_samples: int) -> None:
    """Raise unless iq is a complex64 (..., n_samples) tensor of at least
    one capture with unit stride along the samples."""
    if iq.dtype != torch.complex64:
        raise TypeError(f"acquisition: iq must be complex64, not {iq.dtype}")
    if iq.dim() == 0 or iq.shape[-1] != n_samples:
        raise ValueError(f"acquisition: iq {tuple(iq.shape)} is not (..., "
                         f"{n_samples})")
    if iq.numel() == 0:
        raise ValueError(f"acquisition: iq {tuple(iq.shape)} holds no "
                         "capture")
    if iq.stride(-1) != 1:
        raise ValueError("acquisition: iq must have unit stride along the "
                         "samples")


def make_symbol_acquisition(mode: DvbtMode, n_samples: int):
    """One-shot timing + fractional CFO estimator over a sample block (the
    ``ofdm_sym_acquisition`` block).

    Returns acquire(iq): complex64 (..., n_samples) -> (theta int32 (...),
    offset of the first complete symbol start in [0, N+guard); cfo_frac
    float32 (...), fractional carrier offset in subcarriers).

    CP correlation gamma(n) = sum_{k<G} r[n+k] conj(r[n+k+N]) minus an
    energy term, folded over all whole symbol periods and argmaxed; the
    CFO is the phase of the folded gamma at the peak.  The window sums are
    taken in double precision: over a whole capture a single-precision
    running sum loses the few-sample window sums to round-off.  CPU
    tensors run the plain version, CUDA tensors the kernel in one call
    (two launches)."""
    N, G, L = mode.fft_len, mode.guard_len, mode.symbol_len
    n_folds = _folds(mode, n_samples)
    plain = make_symbol_acquisition_plain(mode, n_samples)

    def acquire(iq: torch.Tensor):
        _check_input(iq, n_samples)
        if iq.device.type == "cpu":
            return plain(iq)
        x = iq.reshape(-1, n_samples)
        n_rows = x.shape[0]
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        geo = geometry(mode, n_folds, n_rows, n_sm)
        partial = torch.empty(n_rows, geo["n_groups"], 3, L,
                              dtype=torch.float64, device=x.device)
        theta = torch.empty(n_rows, dtype=torch.int32, device=x.device)
        cfo = torch.empty(n_rows, dtype=torch.float32, device=x.device)
        code = _build.library().dvbt_acquire(
            x.data_ptr(), partial.data_ptr(), theta.data_ptr(),
            cfo.data_ptr(), n_rows, x.stride(0), N, G, n_folds, geo["tile"],
            geo["n_tiles"], geo["n_groups"], geo["threads"],
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(code, "dvbt_acquire", kernel="acquire")
        return theta.reshape(iq.shape[:-1]), cfo.reshape(iq.shape[:-1])

    return acquire
