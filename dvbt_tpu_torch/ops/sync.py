"""Receiver synchronization front-end (R1 + the sync half of R3),
EN300744 §4.4-4.6.

Counterpart of dvbt_tpu/ops/sync.py, batched over a leading mux axis: one
pass over a capture block per mux —

1. CP-correlation timing + fractional CFO      (ofdm.make_symbol_acquisition)
2. fractional-CFO derotation of the capture
3. FFT of every candidate symbol
4. integer CFO from the continual-pilot power over candidate shifts
5. scattered-pilot phase (l mod 4) from the pilot energy over 4 phases
6. TPS sync-word correlation over candidate frame starts (polarity-
   agnostic, so the inverted sync word of odd frames also votes)
7. TPS frame number and block (packet) alignment

Each mux has its own delay and CFO, so the data-dependent slices of the
JAX package (``dynamic_slice`` at a scalar offset) are per-row gathers
here, and every estimate is a (n_mux,) tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..mode import SYMBOLS_PER_FRAME, DvbtMode
from ..utils.cplx import cis
from . import ofdm, reference_signals

DEFAULT_MAX_INT_CFO = 8
DEFAULT_BACKOFF = 8  # samples of CP margin before the detected boundary
_TWO_PI = 2.0 * np.pi


def min_capture_samples(mode: DvbtMode, n_frames_out: int) -> int:
    """Smallest capture length make_synchronizer accepts: the decode block
    plus worst-case timing (one symbol) + frame (68 symbols) + block
    (frames_per_block-1 frames) misalignment, plus one TPS-sync tail frame."""
    L = mode.symbol_len
    f = mode.frames_per_block
    n_out_sym = n_frames_out * SYMBOLS_PER_FRAME
    slack_sym = SYMBOLS_PER_FRAME * f + SYMBOLS_PER_FRAME
    return (n_out_sym + slack_sym) * L + L


def _rows(x: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """x (M, T), start (M,) -> (M, n): row m is x[m, start[m]:start[m]+n]."""
    idx = start.to(torch.int64)[:, None] + torch.arange(n, device=x.device)
    return torch.gather(x, -1, idx)


def make_synchronizer(mode: DvbtMode, n_samples_in: int, n_frames_out: int,
                      device, max_int_cfo: int = DEFAULT_MAX_INT_CFO,
                      backoff: int = DEFAULT_BACKOFF):
    """The ``synchronizer`` block.  Returns sync(iq) -> (aligned, info).

    iq      : complex64 (n_mux, n_samples_in) raw baseband with unknown
              delay, CFO (|int| <= max_int_cfo subcarriers + fractional)
              and noise, per mux.
    aligned : complex64 (n_mux, n_frames_out * 68 * symbol_len) CFO-
              corrected baseband starting exactly at a packet-aligned frame
              start — what models.rx.make_receiver consumes.
    info    : dict of (n_mux,) estimates: theta, cfo_frac, cfo_int,
              frame_sym, frame_num, start, start_frame, and the detection
              scores scat_score (n_mux, 4) and tps_score.
    """
    N, G, L = mode.fft_len, mode.guard_len, mode.symbol_len
    f = mode.frames_per_block
    n_out = n_frames_out * SYMBOLS_PER_FRAME * L
    if n_samples_in < min_capture_samples(mode, n_frames_out):
        raise ValueError(f"capture of {n_samples_in} samples is shorter than "
                         f"{min_capture_samples(mode, n_frames_out)}")
    n_sym = (n_samples_in - L) // L

    acquire = ofdm.make_symbol_acquisition(mode, n_samples_in)
    t = reference_signals._frame_tables(mode)

    def as_index(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    bins = as_index(ofdm._bin_map(mode))                        # (K,)
    sp_idx = as_index(t["sp_idx"])                              # (4, n_sp)
    tp = as_index(t["tp"])                                      # (n_tps,)
    shifts = np.arange(-max_int_cfo, max_int_cfo + 1)
    cp_bins = ofdm._bin_map(mode)[mode.continual_pilots()]
    cp_shift_idx = as_index((cp_bins[None, :] + shifts[:, None]) % N)
    sync_sign = torch.as_tensor(
        1.0 - 2.0 * np.array(tables.TPS_SYNC, np.float32), device=device)

    # TPS sync-word vote positions: for candidate frame start c in [0, 68),
    # frame replica r, word bit i -> diff-bit index c + 68 r + (i + 1)
    n_votes = (n_sym - 1 - 16 - (SYMBOLS_PER_FRAME - 1)) \
        // SYMBOLS_PER_FRAME + 1
    if n_votes < 1:
        raise ValueError("capture too short for one TPS sync-word vote")
    c = np.arange(SYMBOLS_PER_FRAME)
    pos = as_index(c[:, None, None] + SYMBOLS_PER_FRAME
                   * np.arange(n_votes)[None, :, None]
                   + np.arange(16)[None, None, :] + 1)          # (68, R, 16)
    c_t = as_index(c)
    s_i = as_index(np.arange(n_sym))
    n_f = torch.arange(n_samples_in, dtype=torch.float32, device=device)
    m_f = torch.arange(n_out, dtype=torch.float32, device=device)

    def sync(iq: torch.Tensor):
        M = iq.shape[0]
        theta, cfo_frac = acquire(iq)
        theta_b = (theta - backoff) % L

        # fractional-CFO derotation of the whole capture (integer CFO does
        # not break subcarrier orthogonality, so it is corrected post-FFT)
        r = iq * cis(-_TWO_PI * cfo_frac[:, None] * n_f / N)

        syms = _rows(r, theta_b, n_sym * L).reshape(M, n_sym, L)[..., G:]
        spec = torch.fft.fft(syms, dim=-1, norm="ortho")       # (M, S, N)

        # integer CFO: continual-pilot power over candidate shifts
        P = (spec.abs() ** 2).sum(-2)                          # (M, N)
        cp_score = P[:, cp_shift_idx].sum(-1)                  # (M, n_shift)
        cfo_int = (cp_score.argmax(-1) - max_int_cfo).to(torch.int32)

        cols = (bins[None, :] + cfo_int[:, None]) % N          # (M, K)
        carriers = torch.gather(spec, -1, cols[:, None, :].expand(
            M, n_sym, cols.shape[-1]))                         # (M, S, K)

        # scattered-pilot phase (l mod 4)
        E = (carriers[..., sp_idx].abs() ** 2).sum(-1)         # (M, S, 4)
        m_scat = torch.stack([
            E[:, s_i, (s_i + o) % 4].sum(-1) for o in range(4)], dim=-1)
        o_hat = m_scat.argmax(-1)                              # (M,)

        # TPS: DBPSK diff votes + sync-word correlation
        cells = carriers[..., tp]                              # (M, S, n_tps)
        votes = (cells[:, 1:] * cells[:, :-1].conj()).real.sum(-1)
        bsign = torch.cat([votes.new_zeros(M, 1), torch.sign(votes)], -1)
        corr = (bsign[:, pos] * sync_sign).sum(-1)             # (M, 68, R)
        m_tps = corr.abs().sum(-1)                             # (M, 68)
        # frame start must be consistent with the scattered phase
        valid = (c_t[None, :] + o_hat[:, None]) % 4 == 0
        c_hat = torch.where(valid, m_tps, -torch.inf).argmax(-1)

        # frame number + block (packet) alignment
        bbit = (bsign < 0).to(torch.int64)
        frame_num = ((torch.gather(bbit, -1, (c_hat + 23)[:, None])[:, 0]
                      << 1)
                     | torch.gather(bbit, -1, (c_hat + 24)[:, None])[:, 0])
        adv = (-frame_num) % f
        c_full = c_hat + adv * SYMBOLS_PER_FRAME

        # aligned, fully CFO-corrected output block
        start = theta_b.to(torch.int64) + c_full * L
        irot = cis(-_TWO_PI * cfo_int.to(torch.float32)[:, None] * m_f / N)
        aligned = _rows(r, start, n_out) * irot

        def i32(x):
            return x.to(torch.int32)

        info = {
            "theta": theta, "cfo_frac": cfo_frac, "cfo_int": cfo_int,
            "frame_sym": i32(c_hat), "frame_num": i32(frame_num),
            "start": i32(start), "start_frame": i32((frame_num + adv) % 4),
            "scat_score": m_scat,
            "tps_score": torch.gather(m_tps, -1, c_hat[:, None])[:, 0],
        }
        return aligned, info

    return sync


def make_tracker(mode: DvbtMode, n_frames_out: int, device):
    """Steady-state (locked) front-end: derotate exactly one decode block at
    a known CFO, no search.  Returns track(iq, cfo_frac, cfo_int, phase) ->
    (aligned, phase'), all with a leading mux axis; ``phase`` (n_mux,)
    carries the NCO angle across blocks so the derotation is continuous
    sample to sample."""
    N = mode.fft_len
    n_out = n_frames_out * SYMBOLS_PER_FRAME * mode.symbol_len
    n_f = torch.arange(n_out, dtype=torch.float32, device=device)

    def track(iq: torch.Tensor, cfo_frac: torch.Tensor,
              cfo_int: torch.Tensor, phase: torch.Tensor):
        cfo = cfo_frac + cfo_int.to(torch.float32)
        rot = cis(-_TWO_PI * cfo[:, None] * n_f / N + phase[:, None])
        # floored modulo as jnp.mod takes it: exact fmod, then the sign fix
        ang = torch.fmod(phase - _TWO_PI * cfo * n_out / N, _TWO_PI)
        phase1 = torch.where(ang < 0, ang + _TWO_PI, ang)
        return iq * rot, phase1.to(torch.float32)

    return track
