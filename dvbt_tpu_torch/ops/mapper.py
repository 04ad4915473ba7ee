"""QAM mapper, hard and soft demappers (T7 / R4), EN300744 §4.3.5 Fig 9.

Counterpart of dvbt_tpu/ops/mapper.py.  Mapping is a gather from the 2^v
constellation table.  Hard demapping is the reference's per-axis scaled
rounding: the nearest level index per axis is clip(round((|z|*scale -
alpha)/2)) and a small table turns (sign, index) into that axis' cell bits.
Ties on decision-boundary midpoints resolve by round-half-to-even (as
``jnp.round``), so the demapper agrees with the JAX package bit for bit.

The soft demapper gives the JAX package's max-log per-bit metrics, but per
axis: DVB-T's Gray mapping puts the even cell bits on the I level and the
odd ones on the Q level (uniform and hierarchical alike), so the max over
the 2^v points of a bit's score splits into a max over one axis' 2^(v/2)
levels plus a term that cancels.  The JAX package builds the (..., 2^v)
score plane (105 MB a mux-frame at 8K 64-QAM); this builds two (..., 2^(v/2))
planes.  The LLRs agree in exact arithmetic; in float32 they round
differently, so a quantized metric can differ by one level where its value
sits on a rounding boundary (tests/test_torch_soft.py states how often).
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


def _axis_levels(mode: DvbtMode):
    """(I levels, Q levels) float32 (2^(v/2),), indexed by the axis' cell
    bits MSB first (I: y0, y2, ...; Q: y1, y3, ...)."""
    c = mode.constellation_table().astype(np.complex64)
    v = mode.v
    h = v // 2
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
    if not (np.allclose(i_levels[i_idx], c.real)
            and np.allclose(q_levels[q_idx], c.imag)):
        raise ValueError(f"{mode.constellation} alpha={mode.alpha} is not "
                         "separable per axis")
    return i_levels, q_levels


def _axis_tables(mode: DvbtMode):
    """(scale, alpha, m, i_contrib, q_contrib) of the per-axis demapper."""
    c = mode.constellation_table().astype(np.complex64)
    v = mode.v
    h = v // 2
    m = 1 << (h - 1)                       # levels per half-axis
    alpha = mode.alpha_eff
    scale = (alpha + 2 * (m - 1)) / np.max(c.real)
    i_levels, q_levels = _axis_levels(mode)
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


def soft_tables(mode: DvbtMode):
    """(((I levels, I levels^2 / 2), (Q levels, Q levels^2 / 2)), dmin2):
    float32 (2^(v/2),) per axis, and the constellation's least squared
    distance, of the soft demapper."""
    c = mode.constellation_table().astype(np.complex64)
    d2 = np.abs(c[:, None] - c[None, :]) ** 2
    np.fill_diagonal(d2, np.inf)
    axes = tuple((lv, lv * lv / np.float32(2)) for lv in _axis_levels(mode))
    return axes, float(d2.min())


def make_soft_demapper(mode: DvbtMode, device):
    """Max-log-MAP per-bit soft demapper, 4-bit quantized, CSI-weighted.

    Returns soft_demap(y, csi=None): complex64 (...,) -> uint8 (..., v)
    metrics 0..15 (bit e = y_e; 7/8 = erasure, 15 = a confident 1),
    round(7.5 + 7.5 * llr / dmin2) clipped, with round-half-to-even as
    ``jnp.round``; llr = max score over the points whose bit is 1 minus
    the max over those whose bit is 0, score = |y|^2 - |y - c|^2 halved,
    and dmin2 the constellation's least squared distance.  ``csi``
    (optional, float32, broadcastable to y) scales the LLRs before
    quantization: after zero-forcing the noise on a carrier is amplified
    by 1/|H|^2, so the true LLR is the equalized one times |H|^2."""
    h = mode.v // 2
    np_axes, dmin2 = soft_tables(mode)
    axes = [tuple(torch.as_tensor(a, device=device) for a in pair)
            for pair in np_axes]

    def axis_llr(z: torch.Tensor, levels, half_sq) -> list:
        """z (...,) -> [llr (...,)] of the axis' h bits, MSB first."""
        s = z.unsqueeze(-1) * levels - half_sq             # (..., 2^h)
        out = []
        for j in range(h):
            # level index k = (high j bits, bit j, low bits): split the
            # bit's own axis out and take the max over the others
            g = s.reshape(*z.shape, 1 << j, 2, 1 << (h - 1 - j))
            m = g.amax(dim=(-3, -1))                       # (..., 2)
            out.append(m[..., 1] - m[..., 0])
        return out

    def soft_demap(y: torch.Tensor, csi: torch.Tensor | None = None
                   ) -> torch.Tensor:
        llr_i = axis_llr(y.real.to(torch.float32), *axes[0])
        llr_q = axis_llr(y.imag.to(torch.float32), *axes[1])
        llr = torch.stack([x for pair in zip(llr_i, llr_q) for x in pair],
                          dim=-1)                          # (..., v)
        if csi is not None:
            llr = llr * csi.unsqueeze(-1)
        s = torch.clamp(torch.round(7.5 + 7.5 * llr / dmin2), 0.0, 15.0)
        return s.to(torch.uint8)

    return soft_demap
