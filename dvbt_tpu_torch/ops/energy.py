"""Energy dispersal / descrambling (T1 / R10), EN300744 §4.3.1.

Counterpart of dvbt_tpu/ops/energy.py: the PRBS is a precomputed (8, 188)
XOR pattern, one row per packet position in the 8-packet dispersal group.
The carried state is the group phase of the block's first packet, one per
mux.  Scrambling is an involution, so the same function descrambles.
"""

from __future__ import annotations

import torch

from .. import tables


def make_energy_dispersal(n_packets: int, device):
    """Returns apply(phase, packets) -> (phase', packets').

    phase: int32 (n_mux,) group index (0..7) of each mux's first packet;
    packets: uint8 (n_mux, n_packets, 188)."""
    pat = torch.as_tensor(tables.dispersal_pattern(), device=device)
    offsets = torch.arange(n_packets, dtype=torch.int64, device=device)

    def apply(phase: torch.Tensor, packets: torch.Tensor):
        idx = (phase.to(torch.int64)[:, None] + offsets) % 8
        out = packets ^ pat[idx]
        return ((phase + n_packets) % 8).to(torch.int32), out

    return apply


def detect_dispersal_phase(packets: torch.Tensor) -> torch.Tensor:
    """Group phase from the sync bytes of scrambled packets.

    packets uint8 (n_mux, n, 188) -> int32 (n_mux,).  Packet i carries the
    inverted sync 0xB8 iff (phase + i) % 8 == 0; the phase scoring most
    0xB8 where expected and 0x47 elsewhere wins (lowest on ties)."""
    n = packets.shape[-2]
    i = torch.arange(n, device=packets.device)
    is_b8 = (packets[..., 0] == 0xB8).to(torch.int32)
    is_47 = (packets[..., 0] == 0x47).to(torch.int32)
    q = torch.arange(8, device=packets.device)
    sel = ((q[:, None] + i[None, :]) % 8 == 0).to(torch.int32)    # (8, n)
    scores = (sel * is_b8[..., None, :]
              + (1 - sel) * is_47[..., None, :]).sum(-1)          # (.., 8)
    return torch.argmax(scores, dim=-1).to(torch.int32)
