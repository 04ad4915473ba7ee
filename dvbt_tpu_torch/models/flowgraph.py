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

Hierarchical modes decode both streams, a branch of the port's own (the
JAX package's registry chain has no LP demux): of each cell's v
deinterleaved bits the first 2 go to HP and the rest to LP [EN300744
§4.3.4.1] (``kernels/demap.split_streams``, as ``models/rx.py``'s plain
path splits them), and each stream is depunctured at its own code rate and
decoded by its own K3, outer deinterleaver, RS decoder and descrambler
with carried state of its own.  The LP stream's decoder runs in the stage
``lp_decode``, whose stages keep their block names (so a name's time sums
both streams), as in ``models/rx.py``.
"""

from __future__ import annotations

import importlib

import torch

from .. import blocks
from ..kernels import demap as kdemap
from ..mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
from ..utils.bits import bits_to_bytes
from ..utils.telemetry import stage


def _beside(block: str, attr: str):
    """A function named in a block's notes, from its factory's module."""
    module = blocks.BY_NAME[block].factory.rpartition(".")[0]
    return getattr(importlib.import_module(module), attr)


def _init_stream_state(n_mux: int, device) -> dict:
    return {
        "viterbi": _beside("viterbi_decoder", "init_state")(n_mux, device),
        "deint_tail": _beside("convolutional_deinterleaver", "init_state")(
            n_mux, device),
        "descr_phase": torch.zeros(n_mux, dtype=torch.int32, device=device),
        "descr_locked": torch.zeros(n_mux, dtype=torch.bool, device=device),
    }


def init_block_rx_state(mode: DvbtMode, n_mux: int, device) -> dict:
    """Carried state: Viterbi tail, outer-deinterleaver tail, descrambler
    phase lock, one row per mux; in hierarchical modes the LP stream's own
    under ``"lp"``."""
    state = _init_stream_state(n_mux, device)
    if mode.hierarchical:
        state["lp"] = _init_stream_state(n_mux, device)
    return state


def _make_stream_decoder(rate: str, n_packets: int, device):
    """One stream's chain from its coded metrics.  Returns (depuncture,
    decode): depuncture(coded uint8 (n_mux, n_coded)) -> K3's inputs at
    ``rate``; decode(state, steps) -> (state', ts uint8 (n_mux, n_packets,
    188), rs_corrected, rs_uncorrectable)."""
    make = blocks.resolve
    n_bytes = n_packets * RS_PACKET
    n_bits = n_bytes * 8
    depuncture = _beside("inner_coder", "make_depuncture")(n_bits, rate)
    viterbi = make("viterbi_decoder")(n_bits)
    out_dilv = make("convolutional_deinterleaver")(n_bytes, device)
    rs_dec = make("reed_solomon_dec")(device)
    descramble = make("energy_descramble")(n_packets, device)
    detect = _beside("energy_descramble", "detect_dispersal_phase")

    def depunct(coded: torch.Tensor) -> list:
        return [s.contiguous() for s in depuncture(coded)]

    def decode(state: dict, steps: list):
        n_mux = steps[0].shape[0]
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
        return new_state, ts, rs_corr, rs_bad

    return depunct, decode


def make_block_receiver(mode: DvbtMode, device, n_samples_in: int,
                        n_frames_out: int, max_int_cfo: int = 8):
    """Returns (rx, n_packets).

    rx(state, capture): complex64 (n_mux, n_samples_in) raw baseband ->
    (state', ts uint8 (n_mux, n_packets, 188), info) with the
    synchronizer's estimates, rs_corrected / rs_uncorrectable (n_mux,
    n_packets) and tps_bits (n_mux, n_frames_out, 68).  In hierarchical
    modes ts is the (ts_hp, ts_lp) pair, n_packets the (n_hp, n_lp) pair,
    and info holds the LP stream's counters with an ``lp_`` prefix, as
    ``models/rx.make_receiver`` gives them."""
    if n_frames_out % mode.frames_per_block:
        raise ValueError(f"n_frames_out={n_frames_out} is not a multiple of "
                         f"{mode.frames_per_block} frames per block")
    make = blocks.resolve
    hier = mode.hierarchical
    n_sym = n_frames_out * SYMBOLS_PER_FRAME

    def stream_packets(stream: str) -> int:
        return mode.stream_packets_per_block(stream) * n_frames_out \
            // mode.frames_per_block

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
    n_hp = stream_packets("hp")
    hp_depunct, hp_decode = _make_stream_decoder(mode.code_rate, n_hp,
                                                 device)
    if hier:
        n_lp = stream_packets("lp")
        lp_depunct, lp_decode = _make_stream_decoder(mode.code_rate_lp,
                                                     n_lp, device)

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
            coded = kdemap.split_streams(mode, bit_dilv(cells))  # {0, 15}
            steps = hp_depunct(coded[0])
        new_state, ts, rs_corr, rs_bad = hp_decode(state, steps)
        info = dict(info, rs_corrected=rs_corr, rs_uncorrectable=rs_bad,
                    tps_bits=tps_bits)
        if hier:
            with stage("lp_decode"):
                with stage("bit_inner_interleaver"):
                    steps = lp_depunct(coded[1])
                lp_state, ts_lp, lp_corr, lp_bad = lp_decode(state["lp"],
                                                             steps)
            new_state["lp"] = lp_state
            info.update(lp_rs_corrected=lp_corr, lp_rs_uncorrectable=lp_bad)
            ts = (ts, ts_lp)
        return new_state, ts, info

    def rx(state: dict, capture: torch.Tensor):
        with stage("block_rx"):
            return decode(state, capture)

    return rx, ((n_hp, n_lp) if hier else n_hp)
