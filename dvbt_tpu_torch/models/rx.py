"""The symbol-aligned DVB-T receive chain, batched over muxes.

Counterpart of dvbt_tpu/models/rx.py: FFT -> channel estimate
(``chan_est="time"``: pilots combined over the 4-symbol pattern with a
carried history; ``"freq"``: the current symbol's pilots only) +
zero-forcing equalizer (unless ``equalize=False``) -> TPS decode and MER
(``metrics="full"``) -> cell deinterleave + demap (``demap="hard"``: hard
decisions as saturated metrics; ``"soft"``: max-log metrics weighted by
the channel state |H|^2) + bit deinterleave, one kernel on the card
(``kernels/demap.py``) -> per stream: punctured
Viterbi (kernel K1) -> outer deinterleave -> RS decode -> descramble with
the credible-phase latch.  Hierarchical modes decode both streams: of each
cell's v deinterleaved bits, the first 2 go to HP and the rest to LP, each
at its own code rate [EN300744 §4.3.4.1].  Every tensor carries a leading
mux axis, where the JAX package vmaps.  The stages carry the JAX package's
``named_scope`` names as telemetry stages (``utils/telemetry.py``):
profiler ranges, and spans while a recorder is active.  Hierarchical modes
add ``lp_decode`` around the LP stream's decoder, whose stages keep their
names inside it (so a stage's time sums both streams).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import demap as kdemap
from ..mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
from ..ops import (
    energy,
    mapper,
    ofdm,
    outer_interleaver,
    reed_solomon,
    reference_signals,
    viterbi,
)
from ..utils.bits import bytes_to_bits
from ..utils.telemetry import stage

_STREAM_KEYS = ("deint_tail", "viterbi", "descr_phase", "descr_locked")


def _init_stream_state(rate: str, n_mux: int, device) -> dict:
    return {
        "deint_tail": outer_interleaver.init_state(n_mux, device),
        "viterbi": viterbi.init_state(n_mux, viterbi.effective_overlap(rate),
                                      device),
        "descr_phase": torch.zeros(n_mux, dtype=torch.int32, device=device),
        "descr_locked": torch.zeros(n_mux, dtype=torch.bool, device=device),
    }


def init_rx_state(mode: DvbtMode, n_mux: int, device) -> dict:
    """Carried RX state, one row per mux: outer-deinterleaver tail, Viterbi
    tail and descrambler phase lock of the HP stream, the channel
    estimator's 3-symbol pilot history, and in hierarchical modes the LP
    stream's own under ``"lp"``."""
    state = _init_stream_state(mode.code_rate, n_mux, device)
    state["chan_tail"], state["chan_valid"] = \
        reference_signals.init_time_channel_state(mode, n_mux, device)
    if mode.hierarchical:
        state["lp"] = _init_stream_state(mode.code_rate_lp, n_mux, device)
    return state


def _make_stream_decoder(mode: DvbtMode, stream: str, n_blocks: int, device,
                         measure_pre_rs: bool = False):
    """Per-stream byte pipeline (R7..R10).  Returns (run, n_packets):
    run(state, coded uint8 (n_mux, n_coded) soft metrics 0..15) ->
    (state', ts uint8 (n_mux, n_packets, 188), metrics)."""
    n_packets = mode.stream_packets_per_block(stream) * n_blocks
    n_bytes = n_packets * RS_PACKET
    rate = mode.code_rate if stream == "hp" else mode.code_rate_lp
    vit = viterbi.make_viterbi_decoder(n_bytes * 8, rate)
    out_dilv = outer_interleaver.make_outer_deinterleaver(n_bytes, device)
    rs_dec = reed_solomon.make_rs_decoder(device)
    descramble = energy.make_energy_dispersal(n_packets, device)
    if measure_pre_rs:
        rs_enc = reed_solomon.make_rs_encoder(device)

    def run(state: dict, coded: torch.Tensor):
        n_mux = coded.shape[0]
        with stage("viterbi_decode"):
            vstate, stream_bytes = vit(state["viterbi"], coded)
        with stage("outer_deinterleave"):
            deint_tail, deint = out_dilv(state["deint_tail"], stream_bytes)
        packets204 = deint.reshape(n_mux, n_packets, RS_PACKET)
        with stage("rs_decode"):
            msg, rs_corr, rs_bad = rs_dec(packets204)
        with stage("descramble"):
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
        }
        metrics = {"rs_corrected": rs_corr, "rs_uncorrectable": rs_bad}
        if measure_pre_rs:
            # post-Viterbi bit errors of each correctable packet: the
            # re-encoded message is the codeword that was sent, so its XOR
            # with the received codeword holds the errors RS corrected.
            # Uncorrectable packets read 0 (their count is unknown).
            with stage("pre_rs_errors"):
                diff = packets204 ^ rs_enc(msg)
                n_err = bytes_to_bits(diff).sum(-1, dtype=torch.int32)
                metrics["pre_rs_bit_errors"] = torch.where(rs_bad, 0, n_err)
        return new_state, ts, metrics

    return run, n_packets


def make_receiver(mode: DvbtMode, device, n_frames: int | None = None,
                  equalize: bool = True, demap: str = "hard",
                  chan_est: str = "time", metrics: str = "full",
                  measure_pre_rs: bool = False):
    """Returns (rx, n_packets, n_samples).

    rx(state, iq): complex64 (n_mux, n_samples) symbol-aligned baseband ->
    (state', ts, metrics).  ts is uint8 (n_mux, n_packets, 188); in
    hierarchical modes it is the (ts_hp, ts_lp) pair and n_packets the
    (n_hp, n_lp) pair.  metrics: rs_corrected int32 / rs_uncorrectable
    bool (n_mux, n_packets) per stream (the LP stream's with an ``lp_``
    prefix), with ``measure_pre_rs`` also pre_rs_bit_errors int32 (n_mux,
    n_packets), the post-Viterbi bit errors of each correctable packet (0
    where uncorrectable); timing_tau float32 (n_mux, n_symbols) when
    equalizing; and with ``metrics="full"`` (the default, as in the JAX
    package) tps_bits uint8 (n_mux, n_frames, 68), tps_frame int32
    (n_mux, n_frames) and mer_db float32 (n_mux,).  ``metrics="min"``
    leaves out the TPS decode and the MER estimate, as the flagship step
    does.  ``demap="soft"`` feeds K1 max-log metrics, weighted by the
    normalized |H|^2 when equalizing."""
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
    full = metrics == "full"
    time_est = chan_est == "time"
    hier = mode.hierarchical

    demod = ofdm.make_ofdm_demodulator(mode, device)
    if time_est:
        est = reference_signals.make_time_channel_estimator(mode, device)
    else:
        est = reference_signals.make_channel_estimator(mode, device)
    cell_dilv = reference_signals.make_cell_deinterleaver(mode, device)
    tps_dec = reference_signals.make_tps_decoder(mode, device)
    qdemap = mapper.make_demapper(mode, device)
    qmap = mapper.make_mapper(mode, device)
    demap_dilv = kdemap.make_demap_deinterleave(mode, device, demap)
    hp_dec, n_hp = _make_stream_decoder(mode, "hp", n_blocks, device,
                                        measure_pre_rs)
    if hier:
        lp_dec, n_lp = _make_stream_decoder(mode, "lp", n_blocks, device,
                                            measure_pre_rs)
    tau_scale = mode.fft_len / (2.0 * np.pi)

    def rx(state: dict, iq: torch.Tensor):
        n_mux = iq.shape[0]
        out_metrics = {}
        chan_tail, chan_valid = state["chan_tail"], state["chan_valid"]
        with stage("ofdm_demod"):
            carriers = demod(iq)                            # (n_mux, S, K)
        X = carriers
        if equalize:
            with stage("channel_estimate"):
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
            with stage("tps_decode"):
                tps_bits, tps_frame = tps_dec(X.reshape(
                    n_mux, n_frames, SYMBOLS_PER_FRAME, -1))
        with stage("demap_deinterleave"):
            bits = demap_dilv(X, H if equalize else None)
        if full:
            # MER: error power of the equalized payload cells against their
            # hard decisions, over the whole block of each mux
            Xc = cell_dilv(X)
            p_hat = qmap(qdemap(Xc))
            err = Xc - p_hat
            sig = (p_hat.abs() ** 2).sum((-2, -1))
            noise = (err.abs() ** 2).sum((-2, -1)).clamp_min(1e-12)
            out_metrics.update(tps_bits=tps_bits, tps_frame=tps_frame,
                               mer_db=10.0 * torch.log10(sig / noise))
        hp_state, ts, m_hp = hp_dec(
            {k: state[k] for k in _STREAM_KEYS}, bits[0])
        out_metrics.update(m_hp)
        if hier:
            with stage("lp_decode"):
                lp_state, ts_lp, m_lp = lp_dec(state["lp"], bits[1])
            out_metrics.update({f"lp_{k}": v for k, v in m_lp.items()})
            ts = (ts, ts_lp)
        new_state = dict(hp_state, chan_tail=chan_tail, chan_valid=chan_valid)
        if hier:
            new_state["lp"] = lp_state
        return new_state, ts, out_metrics

    n_packets = (n_hp, n_lp) if hier else n_hp
    return rx, n_packets, n_samples
