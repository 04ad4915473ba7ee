"""Peaks of the card and the work of a stage, counted from the cell's shapes.

A stage's bound is the least time the card could take for its work: the
larger of its bytes (each input read once, each output written once)
over the memory's bandwidth and its operations over the peak rate of
their kind.  The counts are the algorithm's own work, whatever kernel or
window geometry implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet and the
# Hopper architecture white paper): 3.35 TB/s of HBM3; 132 SMs of 128
# 32-bit lanes at a boost clock of 1.98 GHz.  The DPX instruction
# __viaddmax_s16x2 does two 16-bit additions and two maxima on one lane
# in one instruction, 4 operations a lane and clock.
HBM_BYTES_S = 3.35e12
LANES_S = 132 * 128 * 1.98e9
INT16_DPX_OPS_S = 4 * LANES_S

# One add-compare-select of a 64-state trellis step: two additions of a
# branch metric to a path metric and one maximum.
ACS_OPS = 3
STATES = 64
TS_BYTES, RS_BYTES = 188, 204


def bound_s(n_bytes: float, n_ops: float, ops_s: float) -> float:
    return max(n_bytes / HBM_BYTES_S, n_ops / ops_s)


def viterbi_bound_s(n_mux: int, n_packets: int, code_rate: str) -> float:
    """The punctured Viterbi decode of one step: every information bit is
    one trellis step of 64 add-compare-selects; it reads one soft metric
    byte a coded bit and writes the decoded bytes."""
    num, den = (int(x) for x in code_rate.split("/"))
    info_bits = n_mux * n_packets * RS_BYTES * 8
    coded_bits = info_bits * den / num
    n_bytes = coded_bits + info_bits / 8
    n_ops = info_bits * STATES * ACS_OPS
    return bound_s(n_bytes, n_ops, INT16_DPX_OPS_S)


def rs_decode_bound_s(n_mux: int, n_packets: int) -> float:
    """RS(204, 188) decode of one step: 204 bytes in and 188 out a packet."""
    return n_mux * n_packets * (RS_BYTES + TS_BYTES) / HBM_BYTES_S


def streams(reading: dict) -> list:
    """[[n_packets, code_rate], ...] of a head-end reading, one a stream
    and HP first: its ``streams`` where it has them (a hierarchical
    mode), else its one stream.  A step's bound is the sum of its
    streams' bounds: each stream's decode is bound by the same resource
    (Viterbi by its operations at every code rate, RS by its bytes), so
    the sum is also the bound of their work together."""
    return reading.get("streams") or [[reading["n_packets"],
                                       reading["code_rate"]]]
