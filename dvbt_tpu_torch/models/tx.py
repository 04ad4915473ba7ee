"""The DVB-T transmit chain, batched over muxes (non-hierarchical).

Counterpart of dvbt_tpu/models/tx.py: energy dispersal -> RS encode ->
outer interleave -> inner coder (kernel K2) -> bit interleave -> QAM map ->
frame build (symbol interleave + pilots + TPS) -> IFFT + cyclic prefix.
Every tensor carries a leading mux axis, where the JAX package vmaps; the
carried state is a dict of (n_mux, ...) tensors with the JAX leaves.  The
stages carry the JAX package's ``named_scope`` names as profiler ranges.
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


def _check_mode(mode: DvbtMode) -> None:
    if mode.hierarchical:
        raise NotImplementedError(
            "hierarchical modes are not ported yet (ROADMAP queue 1, item 20)")


def init_tx_state(mode: DvbtMode, n_mux: int, device) -> dict:
    """Carried TX state: dispersal phase, outer-interleaver tail, coder
    state and superframe position (frame_idx % 4), one row per mux."""
    _check_mode(mode)
    return {
        "dispersal_phase": torch.zeros(n_mux, dtype=torch.int32,
                                       device=device),
        "outer_tail": outer_interleaver.init_state(n_mux, device),
        "coder_state": inner_coder.init_state(n_mux, device),
        "frame_idx": torch.zeros(n_mux, dtype=torch.int32, device=device),
    }


def make_transmitter(mode: DvbtMode, device, n_frames: int | None = None):
    """Returns (tx, n_packets, n_samples).

    tx(state, packets): packets uint8 (n_mux, n_packets, 188) ->
    (state', iq complex64 (n_mux, n_samples))."""
    _check_mode(mode)
    if n_frames is None:
        n_frames = mode.frames_per_block
    if n_frames % mode.frames_per_block:
        raise ValueError(f"n_frames={n_frames} is not a multiple of "
                         f"{mode.frames_per_block} frames per block")
    n_blocks = n_frames // mode.frames_per_block
    n_packets = mode.packets_per_block * n_blocks
    n_bytes = n_packets * RS_PACKET
    n_samples = n_frames * SYMBOLS_PER_FRAME * mode.symbol_len

    disperse = energy.make_energy_dispersal(n_packets, device)
    rs_enc = reed_solomon.make_rs_encoder(device)
    out_ilv = outer_interleaver.make_outer_interleaver(n_bytes, device)
    coder = inner_coder.make_inner_coder(n_bytes, mode.code_rate)
    bit_ilv = bit_interleaver.make_bit_interleaver(mode, device)
    qmap = mapper.make_mapper(mode, device)
    builder = reference_signals.make_frame_builder(mode, device)
    modulator = ofdm.make_ofdm_modulator(mode, device)
    frame_offsets = torch.arange(n_frames, dtype=torch.int32, device=device)

    def tx(state: dict, packets: torch.Tensor):
        n_mux = packets.shape[0]
        with scope("energy_dispersal"):
            phase, randomized = disperse(state["dispersal_phase"], packets)
        with scope("rs_encode"):
            coded204 = rs_enc(randomized)
        with scope("outer_interleave"):
            tail, interleaved = out_ilv(state["outer_tail"],
                                        coded204.reshape(n_mux, n_bytes))
        with scope("inner_coder"):
            cstate, coded_bits = coder(state["coder_state"], interleaved)
        per_sym = coded_bits.reshape(n_mux, n_frames, SYMBOLS_PER_FRAME, -1)
        fidx = state["frame_idx"][:, None] + frame_offsets
        with scope("bit_interleave"):
            cells = bit_ilv(per_sym)
        with scope("qam_map"):
            points = qmap(cells)
        with scope("frame_build"):
            carriers = builder(fidx, points)
        with scope("ofdm_mod"):
            iq = modulator(carriers).reshape(n_mux, n_samples)
        new_state = {
            "dispersal_phase": phase,
            "outer_tail": tail,
            "coder_state": cstate,
            "frame_idx": (state["frame_idx"] + n_frames) % 4,
        }
        return new_state, iq

    return tx, n_packets, n_samples
