"""The symbol-aligned DVB-T receive chain, batched over muxes.

Counterpart of dvbt_tpu/models/rx.py (hard demap, non-hierarchical): FFT
-> channel estimate (``chan_est="time"``: pilots combined over the
4-symbol pattern with a carried history; ``"freq"``: the current symbol's
pilots only) + zero-forcing equalizer (unless ``equalize=False``) -> TPS
decode and MER (``metrics="full"``) -> hard demap + cell deinterleave ->
bit deinterleave -> punctured Viterbi (kernel K1) -> outer deinterleave ->
RS decode -> descramble with the credible-phase latch.  Every tensor
carries a leading mux axis, where the JAX package vmaps.  The stages carry
the JAX package's ``named_scope`` names as profiler ranges.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function as scope

from ..mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
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
_NOT_PORTED = {("demap", "soft"): 19}


def check_ported(mode: DvbtMode, **options) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a mode or a
    receiver option that is not ported yet."""
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
    check_ported(mode)
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
                  chan_est: str = "time", metrics: str = "full"):
    """Returns (rx, n_packets, n_samples).

    rx(state, iq): complex64 (n_mux, n_samples) symbol-aligned baseband ->
    (state', ts uint8 (n_mux, n_packets, 188), metrics) with metrics
    rs_corrected int32 / rs_uncorrectable bool (n_mux, n_packets);
    timing_tau float32 (n_mux, n_symbols) when equalizing; and with
    ``metrics="full"`` (the default, as in the JAX package) tps_bits uint8
    (n_mux, n_frames, 68), tps_frame int32 (n_mux, n_frames) and mer_db
    float32 (n_mux,).  ``metrics="min"`` leaves out the TPS decode and the
    MER estimate, as the flagship step does."""
    check_ported(mode, demap=demap)
    if chan_est not in ("time", "freq"):
        raise ValueError(f"chan_est={chan_est!r} is not 'time' or 'freq'")
    if metrics not in ("full", "min"):
        raise ValueError(f"metrics={metrics!r} is not 'full' or 'min'")
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
    full = metrics == "full"
    time_est = chan_est == "time"

    demod = ofdm.make_ofdm_demodulator(mode, device)
    if time_est:
        est = reference_signals.make_time_channel_estimator(mode, device)
    else:
        est = reference_signals.make_channel_estimator(mode, device)
    cell_dilv = reference_signals.make_cell_deinterleaver(mode, device)
    tps_dec = reference_signals.make_tps_decoder(mode, device)
    qdemap = mapper.make_demapper(mode, device)
    qmap = mapper.make_mapper(mode, device)
    bit_dilv = bit_interleaver.make_bit_deinterleaver(mode, device, scale=15)
    vit = viterbi.make_viterbi_decoder(n_bytes * 8, rate)
    out_dilv = outer_interleaver.make_outer_deinterleaver(n_bytes, device)
    rs_dec = reed_solomon.make_rs_decoder(device)
    descramble = energy.make_energy_dispersal(n_packets, device)
    tau_scale = mode.fft_len / (2.0 * np.pi)

    def rx(state: dict, iq: torch.Tensor):
        n_mux = iq.shape[0]
        out_metrics = {}
        chan_tail, chan_valid = state["chan_tail"], state["chan_valid"]
        with scope("ofdm_demod"):
            carriers = demod(iq)                            # (n_mux, S, K)
        X = carriers
        if equalize:
            with scope("channel_estimate"):
                if time_est:
                    chan_tail, H = est(chan_tail, chan_valid, carriers)
                    chan_valid = torch.ones_like(chan_valid)
                else:
                    H = est(carriers)
                X = carriers / H
                # per-symbol timing offset from the channel's phase slope:
                # a delay of tau samples gives H(k) ~ exp(-j 2 pi k tau / N)
                dphi = (H[..., 1:] * H[..., :-1].conj()).sum(-1)
                out_metrics["timing_tau"] = -torch.angle(dphi) * tau_scale
        if full:
            with scope("tps_decode"):
                tps_bits, tps_frame = tps_dec(X.reshape(
                    n_mux, n_frames, SYMBOLS_PER_FRAME, -1))
        with scope("demap_deinterleave"):
            cells = cell_dilv(qdemap(X))
            # hard decisions as saturated soft metrics {0, 15}
            bits = bit_dilv(cells)
        if full:
            # MER: error power of the equalized payload cells against their
            # hard decisions, over the whole block of each mux
            p_hat = qmap(cells)
            err = cell_dilv(X) - p_hat
            sig = (p_hat.abs() ** 2).sum((-2, -1))
            noise = (err.abs() ** 2).sum((-2, -1)).clamp_min(1e-12)
            out_metrics.update(tps_bits=tps_bits, tps_frame=tps_frame,
                               mer_db=10.0 * torch.log10(sig / noise))
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
            "chan_valid": chan_valid,
        }
        out_metrics.update(rs_corrected=rs_corr, rs_uncorrectable=rs_bad)
        return new_state, ts, out_metrics

    return rx, n_packets, n_samples
