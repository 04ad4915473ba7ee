"""Block registry of the port: machine-readable descriptors of every public
block, the counterpart of dvbt_tpu/blocks.py.

The same 19 block ids, reference blocks, port signatures and notes as the
JAX package's registry; every factory is a path in this package, and
``device`` is among the parameters wherever the factory takes it.  Tensors
carry a leading mux axis throughout the port.  ``resolve(name)`` imports a
block's factory, so a flowgraph can be composed from the registry alone
(models/flowgraph.py does so for the receive chain).

    python -m dvbt_tpu_torch.blocks OUT_DIR

writes one YAML descriptor per block into OUT_DIR.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import sys

ENUMS = {
    "transmission": ["2k", "8k"],
    "constellation": ["qpsk", "16qam", "64qam"],
    "code_rate": ["1/2", "2/3", "3/4", "5/6", "7/8"],
    "guard": ["1/32", "1/16", "1/8", "1/4"],
    "alpha": [0, 1, 2, 4],
}

MODE_PARAMS = {
    "transmission": "enum:transmission",
    "constellation": "enum:constellation",
    "code_rate": "enum:code_rate (HP)",
    "code_rate_lp": "enum:code_rate (LP, hierarchical)",
    "guard": "enum:guard",
    "alpha": "enum:alpha (0 = non-hierarchical)",
    "cell_id": "int",
}


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    factory: str                 # python path of the make_* factory
    reference: str               # reference class (SURVEY.md §2 id)
    inputs: str
    outputs: str
    params: tuple = ()
    notes: str = ""


_P = "dvbt_tpu_torch."

BLOCKS = (
    Block("energy_dispersal", _P + "ops.energy.make_energy_dispersal",
          "T1 energy_dispersal", "uint8 (P, 188) TS packets + group phase",
          "uint8 (P, 188) randomized + phase'", ("n_packets", "device")),
    Block("reed_solomon_enc", _P + "ops.reed_solomon.make_rs_encoder",
          "T2 reed_solomon_enc", "uint8 (..., P, 188)", "uint8 (..., P, 204)",
          ("device",)),
    Block("convolutional_interleaver",
          _P + "ops.outer_interleaver.make_outer_interleaver",
          "T3 convolutional_interleaver",
          "uint8 (n,) byte stream + 2244-byte tail",
          "uint8 (n,) interleaved + tail'", ("n_bytes", "device"),
          "n_bytes must be a multiple of 204 (whole RS packets)"),
    Block("inner_coder", _P + "ops.inner_coder.make_inner_coder",
          "T4 inner_coder", "uint8 (n_bytes,) byte stream + 6-bit state",
          "uint8 (8*n_bytes/rate,) punctured coded bits + state'",
          ("n_bytes", "code_rate"),
          "takes the outer interleaver's byte stream (the contract of the "
          "JAX package's coder_pallas kernel; CUDA kernel K2); "
          "depuncture: ops.inner_coder.make_depuncture"),
    Block("bit_inner_interleaver",
          _P + "ops.bit_interleaver.make_bit_interleaver",
          "T5 bit_inner_interleaver",
          "uint8 (..., 68, n_payload*v) coded bits",
          "int32 (..., 68, n_payload) cells", ("mode", "device"),
          "inverse: make_bit_deinterleaver"),
    Block("symbol_inner_interleaver",
          _P + "ops.symbol_interleaver.make_symbol_interleaver",
          "T6/R5 symbol_inner_interleaver",
          "(..., n_sym, n_payload) cells", "same, H(q)-permuted",
          ("mode", "device", "n_sym", "deinterleave"),
          "fused into reference_signals.make_frame_builder / "
          "make_cell_deinterleaver on the hot path"),
    Block("dvbt_map", _P + "ops.mapper.make_mapper", "T7 dvbt_map",
          "int32 cells", "complex64 points (incl. hierarchical alpha)",
          ("mode", "device")),
    Block("reference_signals",
          _P + "ops.reference_signals.make_frame_builder",
          "T8 reference_signals",
          "(..., 68, n_payload) points + frame index",
          "(..., 68, K) carriers with pilots/TPS", ("mode", "device")),
    Block("ofdm_modulator", _P + "ops.ofdm.make_ofdm_modulator",
          "T9 (external fft_vcc + cyclic_prefixer)",
          "(..., n_sym, K) carriers", "complex64 baseband at 64/7 Msps",
          ("mode", "device")),
    Block("ofdm_sym_acquisition", _P + "ops.ofdm.make_symbol_acquisition",
          "R1 ofdm_sym_acquisition", "complex64 (n,) raw baseband",
          "(theta, cfo_frac)", ("mode", "n_samples")),
    Block("synchronizer", _P + "ops.sync.make_synchronizer",
          "R1+R3 acquisition & sync",
          "complex64 capture (unknown delay/CFO/frame phase)",
          "aligned CFO-corrected block + estimates",
          ("mode", "n_samples_in", "n_frames_out", "device", "max_int_cfo")),
    Block("ofdm_demodulator", _P + "ops.ofdm.make_ofdm_demodulator",
          "R2 (external fft_vcc)", "complex64 symbol-aligned baseband",
          "(..., n_sym, K) carriers", ("mode", "device", "n_sym")),
    Block("demod_reference_signals",
          _P + "ops.reference_signals.make_channel_estimator",
          "R3 demod_reference_signals (channel est/equalize half)",
          "(..., 68, K) carriers", "(..., 68, K) channel estimate",
          ("mode", "device"),
          "payload extraction fused with R5: make_cell_deinterleaver; "
          "TPS decode: make_tps_decoder"),
    Block("dvbt_demap", _P + "ops.mapper.make_demapper", "R4 dvbt_demap",
          "complex64 equalized cells", "int32 hard-decision cell values",
          ("mode", "device")),
    Block("viterbi_decoder",
          _P + "kernels.viterbi.make_viterbi_decoder",
          "R7 viterbi_decoder (SSE2 kernel)",
          "depunctured mother bits x/y + erasure masks + warmup state",
          "uint8 decoded info bits + state'",
          ("n_bits", "body", "overlap"),
          "CUDA kernel K3 (plain PyTorch version on CPU tensors); "
          "depuncture: ops.inner_coder.make_depuncture"),
    Block("convolutional_deinterleaver",
          _P + "ops.outer_interleaver.make_outer_deinterleaver",
          "R8 convolutional_deinterleaver",
          "uint8 (n,) byte stream + tail", "uint8 (n,) MUX-aligned + tail'",
          ("n_bytes", "device"),
          "n_bytes must be a multiple of 204 (whole RS packets)"),
    Block("reed_solomon_dec", _P + "ops.reed_solomon.make_rs_decoder",
          "R9 reed_solomon_dec", "uint8 (..., P, 204)",
          "(uint8 (..., P, 188), n_corrected, uncorrectable)", ("device",),
          "CUDA kernel csrc/rs.cu (plain PyTorch version on CPU tensors)"),
    Block("energy_descramble", _P + "ops.energy.make_energy_dispersal",
          "R10 energy_descramble",
          "uint8 (P, 188) + phase (detect: detect_dispersal_phase)",
          "uint8 (P, 188) clean TS + phase'", ("n_packets", "device"),
          "scrambling is an involution; same op as T1"),
    Block("dvbt_tx", _P + "models.tx.make_transmitter",
          "TX flowgraph (apps/)", "TS packets (+ LP stream if hierarchical)",
          "complex64 baseband", ("mode", "device", "n_frames")),
    Block("dvbt_rx", _P + "models.rx.make_receiver",
          "RX flowgraph (apps/)", "symbol-aligned baseband",
          "TS packets (+ LP) + metrics", ("mode", "device", "n_frames")),
)

BY_NAME = {b.name: b for b in BLOCKS}


def resolve(name: str):
    """The factory of block `name`, imported from its registry path."""
    module, _, attr = BY_NAME[name].factory.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def to_yaml(b: Block) -> str:
    lines = [
        f"id: {b.name}",
        f"factory: {b.factory}",
        f"reference: {b.reference}",
        f"inputs: {b.inputs}",
        f"outputs: {b.outputs}",
    ]
    if b.params:
        lines.append("parameters:")
        for p in b.params:
            if p == "mode":
                lines.append("  mode:  # DvbtMode fields")
                for k, v in MODE_PARAMS.items():
                    lines.append(f"    {k}: {v}")
            else:
                lines.append(f"  {p}:")
    if b.notes:
        lines.append(f"notes: {b.notes}")
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m dvbt_tpu_torch.blocks OUT_DIR")
    out = argv[0]
    os.makedirs(out, exist_ok=True)
    for b in BLOCKS:
        with open(os.path.join(out, f"dvbt_{b.name}.yml"), "w") as f:
            f.write(to_yaml(b))
    print(f"wrote {len(BLOCKS)} descriptors to {out}/")


if __name__ == "__main__":
    main()
