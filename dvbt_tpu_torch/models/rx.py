"""The symbol-aligned DVB-T receive chain, batched over muxes.

Counterpart of dvbt_tpu/models/rx.py for ``demap="hard"``,
``chan_est="time"``, ``metrics="min"``: FFT -> time-interpolated channel
estimate + zero-forcing equalizer -> hard demap + cell deinterleave -> bit
deinterleave -> punctured Viterbi (kernel K1) -> outer deinterleave -> RS
decode -> descramble with the credible-phase latch.  Every tensor carries a
leading mux axis, where the JAX package vmaps.  The stages carry the JAX
package's ``named_scope`` names as profiler ranges.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function as scope

from dvbt_tpu.mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode

from ..ops import (
    bit_interleaver,
    energy,
    mapper,
    ofdm,
    outer_interleaver,
    reed_solomon,
    reference_signals,
    viterbi,
)

# options of the JAX receiver that are not ported yet, with their ROADMAP
# queue-1 item
_NOT_PORTED = {
    ("demap", "soft"): 19,
    ("metrics", "full"): 18,
    ("chan_est", "freq"): 18,
    ("equalize", False): 18,
}


def _check(mode: DvbtMode, **options) -> None:
    if mode.hierarchical:
        raise NotImplementedError(
            "hierarchical modes are not ported yet (ROADMAP queue 1, item 20)")
    for key, value in options.items():
        item = _NOT_PORTED.get((key, value))
        if item is not None:
            raise NotImplementedError(f"{key}={value!r} is not ported yet "
                                      f"(ROADMAP queue 1, item {item})")


def init_rx_state(mode: DvbtMode, n_mux: int, device) -> dict:
    """Carried RX state, one row per mux: outer-deinterleaver tail, Viterbi
    tail, descrambler phase lock, and the channel estimator's 3-symbol pilot
    history."""
    _check(mode)
    ov = viterbi.effective_overlap(mode.code_rate)
    tail, valid = reference_signals.init_time_channel_state(mode, n_mux,
                                                            device)
    return {
        "deint_tail": outer_interleaver.init_state(n_mux, device),
        "viterbi": viterbi.init_state(n_mux, ov, device),
        "descr_phase": torch.zeros(n_mux, dtype=torch.int32, device=device),
        "descr_locked": torch.zeros(n_mux, dtype=torch.bool, device=device),
        "chan_tail": tail,
        "chan_valid": valid,
    }


def make_receiver(mode: DvbtMode, device, n_frames: int | None = None,
                  equalize: bool = True, demap: str = "hard",
                  chan_est: str = "time", metrics: str = "min"):
    """Returns (rx, n_packets, n_samples).

    rx(state, iq): complex64 (n_mux, n_samples) symbol-aligned baseband ->
    (state', ts uint8 (n_mux, n_packets, 188), metrics) with metrics
    rs_corrected int32 / rs_uncorrectable bool (n_mux, n_packets) and
    timing_tau float32 (n_mux, n_symbols)."""
    _check(mode, demap=demap, chan_est=chan_est, metrics=metrics,
           equalize=equalize)
    if n_frames is None:
        n_frames = mode.frames_per_block
    if n_frames % mode.frames_per_block:
        raise ValueError(f"n_frames={n_frames} is not a multiple of "
                         f"{mode.frames_per_block} frames per block")
    n_blocks = n_frames // mode.frames_per_block
    n_sym = n_frames * SYMBOLS_PER_FRAME
    n_samples = n_sym * mode.symbol_len
    n_packets = mode.packets_per_block * n_blocks
    n_bytes = n_packets * RS_PACKET
    rate = mode.code_rate

    demod = ofdm.make_ofdm_demodulator(mode, device)
    est = reference_signals.make_time_channel_estimator(mode, device)
    cell_dilv = reference_signals.make_cell_deinterleaver(mode, device)
    qdemap = mapper.make_demapper(mode, device)
    bit_dilv = bit_interleaver.make_bit_deinterleaver(mode, device, scale=15)
    vit = viterbi.make_viterbi_decoder(n_bytes * 8, rate)
    out_dilv = outer_interleaver.make_outer_deinterleaver(n_bytes, device)
    rs_dec = reed_solomon.make_rs_decoder(device)
    descramble = energy.make_energy_dispersal(n_packets, device)
    tau_scale = mode.fft_len / (2.0 * np.pi)

    def rx(state: dict, iq: torch.Tensor):
        n_mux = iq.shape[0]
        with scope("ofdm_demod"):
            carriers = demod(iq)                            # (n_mux, S, K)
        with scope("channel_estimate"):
            chan_tail, H = est(state["chan_tail"], state["chan_valid"],
                               carriers)
            X = carriers / H
            # per-symbol timing offset from the channel's phase slope: a
            # delay of tau samples gives H(k) ~ exp(-j 2 pi k tau / N)
            dphi = (H[..., 1:] * H[..., :-1].conj()).sum(-1)
            timing_tau = -torch.angle(dphi) * tau_scale
        with scope("demap_deinterleave"):
            # hard decisions as saturated soft metrics {0, 15}
            bits = bit_dilv(cell_dilv(qdemap(X)))
        with scope("viterbi_decode"):
            vstate, stream = vit(state["viterbi"], bits.reshape(n_mux, -1))
        with scope("outer_deinterleave"):
            deint_tail, deint = out_dilv(state["deint_tail"], stream)
        with scope("rs_decode"):
            msg, rs_corr, rs_bad = rs_dec(deint.reshape(n_mux, n_packets,
                                                        RS_PACKET))
        with scope("descramble"):
            detected = energy.detect_dispersal_phase(msg)
            phase = torch.where(state["descr_locked"], state["descr_phase"],
                                detected)
            new_phase, ts = descramble(phase, msg)
        # latch the group phase only once the detection is credible (mostly
        # correctable packets): a garbage block after (re)acquisition must
        # not freeze a phase guessed from noise
        credible = rs_bad.to(torch.float32).mean(-1) < 0.5
        new_state = {
            "deint_tail": deint_tail,
            "viterbi": vstate,
            "descr_phase": new_phase,
            "descr_locked": state["descr_locked"] | credible,
            "chan_tail": chan_tail,
            "chan_valid": torch.ones_like(state["chan_valid"]),
        }
        out_metrics = {"rs_corrected": rs_corr, "rs_uncorrectable": rs_bad,
                       "timing_tau": timing_tau}
        return new_state, ts, out_metrics

    return rx, n_packets, n_samples
