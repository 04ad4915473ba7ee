"""QAM mapper / hard demapper (T7 / R4), EN300744 §4.3.5 Fig 9.

Counterpart of dvbt_tpu/ops/mapper.py.  Mapping is a gather from the 2^v
constellation table.  Hard demapping is the reference's per-axis scaled
rounding: the nearest level index per axis is clip(round((|z|*scale -
alpha)/2)) and a small table turns (sign, index) into that axis' cell bits.
Ties on decision-boundary midpoints resolve by round-half-to-even (as
``jnp.round``), so the demapper agrees with the JAX package bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mode import DvbtMode


def make_mapper(mode: DvbtMode, device):
    """Returns qam_map(cells): int (...,) -> complex64 points (...,)."""
    table = torch.as_tensor(mode.constellation_table().astype(np.complex64),
                            device=device)

    def qam_map(cells: torch.Tensor) -> torch.Tensor:
        return table[cells.to(torch.int64)]

    return qam_map


def _axis_tables(mode: DvbtMode):
    """(scale, alpha, m, i_contrib, q_contrib) of the per-axis demapper."""
    c = mode.constellation_table().astype(np.complex64)
    v = mode.v
    h = v // 2
    m = 1 << (h - 1)                       # levels per half-axis
    alpha = mode.alpha_eff
    scale = (alpha + 2 * (m - 1)) / np.max(c.real)
    cells = np.arange(2 ** v)
    i_idx = np.zeros(2 ** v, np.int64)
    q_idx = np.zeros(2 ** v, np.int64)
    for b in range(h):
        i_idx |= ((cells >> (v - 1 - 2 * b)) & 1) << (h - 1 - b)
        q_idx |= ((cells >> (v - 2 - 2 * b)) & 1) << (h - 1 - b)
    i_levels = np.zeros(2 ** h, np.float32)
    q_levels = np.zeros(2 ** h, np.float32)
    i_levels[i_idx] = c.real
    q_levels[q_idx] = c.imag
    # (sign, |level| rank) -> cell-value contribution of that axis' bits
    i_contrib = np.zeros(2 * m, np.int32)
    q_contrib = np.zeros(2 * m, np.int32)
    for s_, sign in ((0, 1.0), (1, -1.0)):
        for ka in range(m):
            lvl = sign * (alpha + 2 * ka) / scale
            bi = int(np.argmin(np.abs(i_levels - lvl)))
            bq = int(np.argmin(np.abs(q_levels - lvl)))
            for b in range(h):
                i_contrib[s_ * m + ka] |= (
                    (bi >> (h - 1 - b)) & 1) << (v - 1 - 2 * b)
                q_contrib[s_ * m + ka] |= (
                    (bq >> (h - 1 - b)) & 1) << (v - 2 - 2 * b)
    return float(np.float32(scale)), alpha, m, i_contrib, q_contrib


def make_demapper(mode: DvbtMode, device):
    """Returns qam_demap(y): complex64 (...,) -> int32 hard cells (...,)."""
    scale, alpha, m, i_np, q_np = _axis_tables(mode)
    i_contrib = torch.as_tensor(i_np, device=device)
    q_contrib = torch.as_tensor(q_np, device=device)

    def axis(z, contrib):
        neg = (z < 0).to(torch.int64)
        if m == 1:
            return contrib[neg]
        ka = torch.clamp(torch.round((z.abs() * scale - alpha) * 0.5),
                         0, m - 1).to(torch.int64)
        return contrib[ka + m * neg]

    def qam_demap(y: torch.Tensor) -> torch.Tensor:
        return axis(y.real, i_contrib) | axis(y.imag, q_contrib)

    return qam_demap
