"""The reference receive flowgraph composed block by block from the
registry, starting from a raw capture.

SURVEY.md §3.2's RX chain: synchronizer (acquisition, CFO, frame sync) ->
ofdm_demodulator -> demod_reference_signals (frequency-interpolated channel
estimate) + equalize, TPS decode -> payload extraction -> dvbt_demap ->
symbol_inner_interleaver (inverse) -> bit_inner_interleaver (inverse) ->
depuncture -> viterbi_decoder (kernel K3) -> convolutional_deinterleaver ->
reed_solomon_dec -> energy_descramble.  Every stage comes from
``blocks.resolve`` or from a function that a block's notes name in the
same module; the flagship receiver (models/rx.py) fuses several of these
stages instead.  Batched over a leading mux axis: each mux's capture has
its own delay and CFO.  Each stage runs in a telemetry stage
(``utils/telemetry.py``) named after its block, and the whole pass in the
stage ``block_rx``.
"""

from __future__ import annotations

import importlib

import torch

from .. import blocks
from ..mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
from ..utils.bits import bits_to_bytes
from ..utils.telemetry import stage


def _beside(block: str, attr: str):
    """A function named in a block's notes, from its factory's module."""
    module = blocks.BY_NAME[block].factory.rpartition(".")[0]
    return getattr(importlib.import_module(module), attr)


def init_block_rx_state(mode: DvbtMode, n_mux: int, device) -> dict:
    """Carried state: Viterbi tail, outer-deinterleaver tail, descrambler
    phase lock, one row per mux."""
    return {
        "viterbi": _beside("viterbi_decoder", "init_state")(n_mux, device),
        "deint_tail": _beside("convolutional_deinterleaver", "init_state")(
            n_mux, device),
        "descr_phase": torch.zeros(n_mux, dtype=torch.int32, device=device),
        "descr_locked": torch.zeros(n_mux, dtype=torch.bool, device=device),
    }


def make_block_receiver(mode: DvbtMode, device, n_samples_in: int,
                        n_frames_out: int, max_int_cfo: int = 8):
    """Returns (rx, n_packets).

    rx(state, capture): complex64 (n_mux, n_samples_in) raw baseband ->
    (state', ts uint8 (n_mux, n_packets, 188), info) with the
    synchronizer's estimates, rs_corrected / rs_uncorrectable (n_mux,
    n_packets) and tps_bits (n_mux, n_frames_out, 68)."""
    if mode.hierarchical:
        raise NotImplementedError(
            "hierarchical modes have no block path: the JAX package's "
            "registry chain it mirrors has no LP demux (models/rx.py "
            "decodes both streams)")
    if n_frames_out % mode.frames_per_block:
        raise ValueError(f"n_frames_out={n_frames_out} is not a multiple of "
                         f"{mode.frames_per_block} frames per block")
    make = blocks.resolve
    n_sym = n_frames_out * SYMBOLS_PER_FRAME
    n_packets = mode.packets_per_block * n_frames_out \
        // mode.frames_per_block
    n_bytes = n_packets * RS_PACKET
    n_bits = n_bytes * 8

    sync = make("synchronizer")(mode, n_samples_in, n_frames_out, device,
                                max_int_cfo)
    demod = make("ofdm_demodulator")(mode, device, n_sym)
    estimate = make("demod_reference_signals")(mode, device)
    tps_dec = _beside("demod_reference_signals", "make_tps_decoder")(
        mode, device)
    extract = _beside("demod_reference_signals", "make_payload_extractor")(
        mode, device)
    demap = make("dvbt_demap")(mode, device)
    sym_dilv = make("symbol_inner_interleaver")(mode, device, n_sym,
                                                deinterleave=True)
    bit_dilv = _beside("bit_inner_interleaver", "make_bit_deinterleaver")(
        mode, device, scale=15)
    depuncture = _beside("inner_coder", "make_depuncture")(n_bits,
                                                           mode.code_rate)
    viterbi = make("viterbi_decoder")(n_bits)
    out_dilv = make("convolutional_deinterleaver")(n_bytes, device)
    rs_dec = make("reed_solomon_dec")(device)
    descramble = make("energy_descramble")(n_packets, device)
    detect = _beside("energy_descramble", "detect_dispersal_phase")

    def decode(state: dict, capture: torch.Tensor):
        n_mux = capture.shape[0]
        with stage("synchronizer"):
            aligned, info = sync(capture)
        with stage("ofdm_demodulator"):
            Y = demod(aligned)                            # (n_mux, S, K)
        with stage("demod_reference_signals"):
            X = Y / estimate(Y)
            tps_bits, _ = tps_dec(X.reshape(n_mux, n_frames_out,
                                            SYMBOLS_PER_FRAME, -1))
            payload = extract(X)
        with stage("dvbt_demap"):
            cells = demap(payload)
        with stage("symbol_inner_interleaver"):
            cells = sym_dilv(cells)                       # (n_mux, S, C)
        with stage("bit_inner_interleaver"):
            coded = bit_dilv(cells).reshape(n_mux, -1)    # soft {0, 15}
            steps = [s.contiguous() for s in depuncture(coded)]
        with stage("viterbi_decoder"):
            vstate, bits = viterbi(state["viterbi"], *steps)
        with stage("convolutional_deinterleaver"):
            deint_tail, deint = out_dilv(state["deint_tail"],
                                         bits_to_bytes(bits))
        with stage("reed_solomon_dec"):
            msg, rs_corr, rs_bad = rs_dec(deint.reshape(n_mux, n_packets,
                                                        RS_PACKET))
        with stage("energy_descramble"):
            phase = torch.where(state["descr_locked"], state["descr_phase"],
                                detect(msg))
            new_phase, ts = descramble(phase, msg)
        credible = rs_bad.to(torch.float32).mean(-1) < 0.5
        new_state = {
            "viterbi": vstate,
            "deint_tail": deint_tail,
            "descr_phase": new_phase,
            "descr_locked": state["descr_locked"] | credible,
        }
        info = dict(info, rs_corrected=rs_corr, rs_uncorrectable=rs_bad,
                    tps_bits=tps_bits)
        return new_state, ts, info

    def rx(state: dict, capture: torch.Tensor):
        with stage("block_rx"):
            return decode(state, capture)

    return rx, n_packets
