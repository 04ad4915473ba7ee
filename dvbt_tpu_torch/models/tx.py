"""The DVB-T transmit chain, batched over muxes.

Counterpart of dvbt_tpu/models/tx.py: per stream, energy dispersal -> RS
encode -> outer interleave -> inner coder (kernel K2); then bit interleave
-> QAM map -> frame build (symbol interleave + pilots + TPS) -> IFFT +
cyclic prefix.  Hierarchical modes carry two transport streams, HP at
``code_rate`` and LP at ``code_rate_lp``, each through its own pipeline;
their coded bits are zipped into v-bit cell slots, 2 HP bits then v-2 LP
bits, the layout the hierarchical bit interleaver reads [EN300744
§4.3.4.1].  Every tensor carries a leading mux axis, where the JAX package
vmaps; the carried state is a dict of (n_mux, ...) tensors with the JAX
leaves.  The stages carry the JAX package's ``named_scope`` names as
profiler ranges.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function as scope

from ..mode import RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode

from ..ops import (
    bit_interleaver,
    energy,
    inner_coder,
    mapper,
    ofdm,
    outer_interleaver,
    reed_solomon,
    reference_signals,
)
from ..utils.streams import split

_STREAM_KEYS = ("dispersal_phase", "outer_tail", "coder_state")


def _init_stream_state(n_mux: int, device) -> dict:
    return {
        "dispersal_phase": torch.zeros(n_mux, dtype=torch.int32,
                                       device=device),
        "outer_tail": outer_interleaver.init_state(n_mux, device),
        "coder_state": inner_coder.init_state(n_mux, device),
    }


def init_tx_state(mode: DvbtMode, n_mux: int, device) -> dict:
    """Carried TX state, one row per mux: the HP stream's dispersal phase,
    outer-interleaver tail and coder state, the superframe position
    (frame_idx % 4), and in hierarchical modes the LP stream's own under
    ``"lp"``."""
    state = _init_stream_state(n_mux, device)
    state["frame_idx"] = torch.zeros(n_mux, dtype=torch.int32, device=device)
    if mode.hierarchical:
        state["lp"] = _init_stream_state(n_mux, device)
    return state


def _make_stream_pipeline(mode: DvbtMode, stream: str, n_blocks: int,
                          device):
    """Per-stream bit pipeline (T1..T4).  Returns (run, n_packets):
    run(state, packets uint8 (n_mux, n_packets, 188)) -> (state', coded
    bits uint8 (n_mux, n_coded))."""
    n_packets = mode.stream_packets_per_block(stream) * n_blocks
    n_bytes = n_packets * RS_PACKET
    rate = mode.code_rate if stream == "hp" else mode.code_rate_lp
    disperse = energy.make_energy_dispersal(n_packets, device)
    rs_enc = reed_solomon.make_rs_encoder(device)
    out_ilv = outer_interleaver.make_outer_interleaver(n_bytes, device)
    coder = inner_coder.make_inner_coder(n_bytes, rate)

    def run(state: dict, packets: torch.Tensor):
        n_mux = packets.shape[0]
        if tuple(packets.shape[1:]) != (n_packets, 188):
            raise ValueError(f"{stream} packets {tuple(packets.shape)} are "
                             f"not (n_mux, {n_packets}, 188)")
        with scope("energy_dispersal"):
            phase, randomized = disperse(state["dispersal_phase"], packets)
        with scope("rs_encode"):
            coded204 = rs_enc(randomized)
        with scope("outer_interleave"):
            tail, interleaved = out_ilv(state["outer_tail"],
                                        coded204.reshape(n_mux, n_bytes))
        with scope("inner_coder"):
            cstate, coded_bits = coder(state["coder_state"], interleaved)
        return {"dispersal_phase": phase, "outer_tail": tail,
                "coder_state": cstate}, coded_bits

    return run, n_packets


def make_transmitter(mode: DvbtMode, device, n_frames: int | None = None):
    """Returns (tx, n_packets, n_samples).

    tx(state, packets): packets uint8 (n_mux, n_packets, 188), in
    hierarchical modes the (packets_hp, packets_lp) pair with n_packets
    the (n_hp, n_lp) pair -> (state', iq complex64 (n_mux, n_samples))."""
    if n_frames is None:
        n_frames = mode.frames_per_block
    if n_frames % mode.frames_per_block:
        raise ValueError(f"n_frames={n_frames} is not a multiple of "
                         f"{mode.frames_per_block} frames per block")
    n_blocks = n_frames // mode.frames_per_block
    n_samples = n_frames * SYMBOLS_PER_FRAME * mode.symbol_len
    hier = mode.hierarchical

    hp_pipe, n_hp = _make_stream_pipeline(mode, "hp", n_blocks, device)
    if hier:
        lp_pipe, n_lp = _make_stream_pipeline(mode, "lp", n_blocks, device)
    bit_ilv = bit_interleaver.make_bit_interleaver(mode, device)
    qmap = mapper.make_mapper(mode, device)
    builder = reference_signals.make_frame_builder(mode, device)
    modulator = ofdm.make_ofdm_modulator(mode, device)
    frame_offsets = torch.arange(n_frames, dtype=torch.int32, device=device)
    slots = (n_frames, SYMBOLS_PER_FRAME, mode.n_payload)

    def tx(state: dict, packets):
        if hier != isinstance(packets, (tuple, list)):
            raise ValueError("a hierarchical mode takes a (packets_hp, "
                             "packets_lp) pair, any other mode one tensor")
        pks = split(packets, hier)
        n_mux = pks[0].shape[0]
        hp_state, hp_bits = hp_pipe({k: state[k] for k in _STREAM_KEYS},
                                    pks[0])
        if hier:
            lp_state, lp_bits = lp_pipe(state["lp"], pks[1])
            per_sym = torch.cat(
                [hp_bits.reshape(n_mux, *slots, 2),
                 lp_bits.reshape(n_mux, *slots, mode.v - 2)], dim=-1)
        else:
            per_sym = hp_bits
        per_sym = per_sym.reshape(n_mux, n_frames, SYMBOLS_PER_FRAME, -1)
        fidx = state["frame_idx"][:, None] + frame_offsets
        with scope("bit_interleave"):
            cells = bit_ilv(per_sym)
        with scope("qam_map"):
            points = qmap(cells)
        with scope("frame_build"):
            carriers = builder(fidx, points)
        with scope("ofdm_mod"):
            iq = modulator(carriers).reshape(n_mux, n_samples)
        new_state = dict(hp_state,
                         frame_idx=(state["frame_idx"] + n_frames) % 4)
        if hier:
            new_state["lp"] = lp_state
        return new_state, iq

    n_packets = (n_hp, n_lp) if hier else n_hp
    return tx, n_packets, n_samples
