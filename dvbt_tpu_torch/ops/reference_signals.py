"""Frame adaptation, pilots & TPS (T8) and their RX-side duals (R3),
EN300744 §4.4 (frame adaptation), §4.5 (pilots), §4.6 (TPS).

Counterpart of dvbt_tpu/ops/reference_signals.py.  A frame is 68 symbols;
the scattered-pilot pattern repeats with period 4 and the continual/TPS
carrier sets are fixed, so everything but the TPS payload is a static
table, and every per-symbol carrier permutation depends only on the symbol
index mod 4.  Those permutations are gathers along the carrier axis with a
(4, P) index per phase (``_row_take``), which is what the JAX package's
``ops/permute.make_row_take4`` computes with TPU-friendly row takes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dvbt_tpu import tables
from dvbt_tpu.mode import SYMBOLS_PER_FRAME, DvbtMode

from . import symbol_interleaver as si

PILOT_BOOST = 4.0 / 3.0  # scattered/continual pilot amplitude [§4.5.2]
_TILE = SYMBOLS_PER_FRAME // 4


@functools.lru_cache(maxsize=None)
def _frame_tables(mode: DvbtMode):
    """Static numpy tables for one 68-symbol frame."""
    K = mode.n_carriers
    kmax = mode.kmax
    w = tables.wk_sequence(K).astype(np.int64)
    sign_w = (1 - 2 * w).astype(np.float32)
    cp = mode.continual_pilots()
    tp = mode.tps_carriers()

    # periodic in l mod 4: pilot amplitudes and payload carrier indices
    pilot_rows = np.zeros((4, K), dtype=np.float32)
    data_idx = np.zeros((4, mode.n_payload), dtype=np.int32)
    sp_list = []
    for l in range(4):
        sp = tables.scattered_pilot_carriers(l, kmax)
        sp_list.append(sp)
        boosted = np.union1d(sp, cp)
        pilot_rows[l, boosted] = PILOT_BOOST * sign_w[boosted]
        is_data = np.ones(K, dtype=bool)
        is_data[boosted] = False
        is_data[tp] = False
        d = np.nonzero(is_data)[0]
        assert len(d) == mode.n_payload, (l, len(d))
        data_idx[l] = d

    # TPS cell signs for each of the 4 frame numbers: DBPSK chain from the
    # w_k-initialised state, same bit on every TPS carrier [§4.6]
    tps_cells = np.zeros((4, SYMBOLS_PER_FRAME, len(tp)), dtype=np.float32)
    for f in range(4):
        s = mode.tps_bits(f)
        fac = np.ones(SYMBOLS_PER_FRAME, dtype=np.float32)
        for l in range(1, SYMBOLS_PER_FRAME):
            fac[l] = fac[l - 1] * (1.0 - 2.0 * float(s[l]))
        tps_cells[f] = fac[:, None] * sign_w[tp][None, :]

    # scattered-pilot carriers per phase, padded to the max count
    n_sp_max = max(len(sp) for sp in sp_list)
    sp_idx = np.zeros((4, n_sp_max), dtype=np.int32)
    for l in range(4):
        sp_idx[l, :len(sp_list[l])] = sp_list[l]
        sp_idx[l, len(sp_list[l]):] = sp_list[l][-1]
    pilot_ref = PILOT_BOOST * sign_w[sp_idx]  # (4, n_sp_max)
    return dict(pilot_rows=pilot_rows, data_idx=data_idx, tp=tp,
                tps_cells=tps_cells, sp_idx=sp_idx, pilot_ref=pilot_ref)


def _row_take(idx4: np.ndarray, device):
    """idx4 (4, P) -> f(x): (..., S, K) -> (..., S, P) with
    out[..., l, j] = x[..., l, idx4[l % 4, j]], S % 4 == 0."""
    idx = torch.as_tensor(np.asarray(idx4, np.int64), device=device)

    def take(x: torch.Tensor) -> torch.Tensor:
        *b, S, K = x.shape
        x4 = x.reshape(*b, S // 4, 4, K)
        out = torch.gather(x4, -1, idx.expand(*b, S // 4, 4, idx.shape[1]))
        return out.reshape(*b, S, idx.shape[1])

    return take


def make_frame_builder(mode: DvbtMode, device):
    """TX: symbol interleaver + cell placement + pilots/TPS (T6 + T8).

    Returns build(frame_idx, points): frame_idx int (..., ) frame numbers
    (mod 4 selects the TPS payload), points complex64 (..., 68, n_payload)
    in pre-symbol-interleave order -> carriers (..., 68, K)."""
    t = _frame_tables(mode)
    pair = si._perm_pair(mode, deinterleave=False)
    K = mode.n_carriers
    # carrier k of phase p reads points[TX_IDX[p, k]] where it is a data
    # carrier, else the pilot/TPS template
    tx_idx = np.zeros((4, K), np.int64)
    is_data = np.zeros((4, K), bool)
    for p in range(4):
        inv = np.zeros(K, np.int64)
        inv[t["data_idx"][p]] = np.arange(mode.n_payload)
        is_data[p, t["data_idx"][p]] = True
        tx_idx[p] = pair[p % 2][inv]
    take_tx = _row_take(tx_idx, device)
    mask = torch.as_tensor(np.tile(is_data, (_TILE, 1)), device=device)
    # (4 frame numbers, 68 symbols, K): pilots plus that frame's TPS cells
    ref_np = np.tile(t["pilot_rows"].astype(np.complex64)[None],
                     (4, _TILE, 1))
    ref_np[:, :, t["tp"]] = t["tps_cells"].astype(np.complex64)
    ref = torch.as_tensor(ref_np, device=device)

    def build(frame_idx: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        placed = take_tx(points)
        return torch.where(mask, placed, ref[frame_idx.to(torch.int64) % 4])

    return build


def make_time_channel_estimator(mode: DvbtMode, device):
    """RX channel estimation at reference density: scattered pilots
    combined across the 4-symbol pattern (the most recent pilot per
    carrier) give an every-third-carrier grid, then linear interpolation in
    frequency fills the rest.

    Returns estimate(tail, valid, Y) -> (tail', H):
      Y     complex64 (n_mux, S, K) frame-aligned carriers, S % 4 == 0;
      tail  complex64 (n_mux, 3, n_sp) LS pilot estimates of the 3 symbols
            before row 0; valid bool (n_mux,) — False at stream start, when
            rows 1..3 of this block stand in for the history."""
    t = _frame_tables(mode)
    pilot_ref = torch.as_tensor(t["pilot_ref"].astype(np.complex64),
                                device=device)            # (4, n_sp)
    take_sp = _row_take(t["sp_idx"], device)
    n_sp = t["sp_idx"].shape[1]
    K = mode.n_carriers
    n3 = mode.kmax // 3 + 1
    off = (0, 3, 2, 1)
    w = torch.as_tensor(((np.arange(K) % 3) / 3.0).astype(np.float32),
                        device=device)

    def estimate(tail: torch.Tensor, valid: torch.Tensor, Y: torch.Tensor):
        *b, S, _ = Y.shape
        if S % 4:
            raise ValueError(f"{S} symbols is not a whole pilot period")
        Hp = take_sp(Y) / pilot_ref.repeat(S // 4, 1)     # (..., S, n_sp)
        tail_eff = torch.where(valid.reshape(*b, 1, 1), tail, Hp[..., 1:4, :])
        ext = torch.cat([tail_eff, Hp], dim=-2)            # (..., S+3, n_sp)
        cols = []
        for l in range(4):
            HpL = ext[..., (l + 3) % 4::4, :]              # phase-l symbols
            R = HpL.repeat_interleave(4, dim=-2)
            cols.append(R[..., off[l]:off[l] + S, :])
        G = torch.stack(cols, dim=-1)                      # (..., S, n_sp, 4)
        C = G.reshape(*b, S, 4 * n_sp)[..., :n3]           # /3 grid, slot s
        Cp = torch.cat([C, C[..., -1:]], dim=-1)
        R3 = Cp.repeat_interleave(3, dim=-1)               # R3[k] = C[k//3]
        H = R3[..., :K] * (1.0 - w) + R3[..., 3:K + 3] * w
        return Hp[..., S - 3:, :], H

    return estimate


def init_time_channel_state(mode: DvbtMode, n_mux: int, device):
    """(tail, valid) leaves of the carried RX state."""
    n_sp = _frame_tables(mode)["sp_idx"].shape[1]
    return (torch.zeros(n_mux, 3, n_sp, dtype=torch.complex64, device=device),
            torch.zeros(n_mux, dtype=torch.bool, device=device))


def make_cell_deinterleaver(mode: DvbtMode, device):
    """RX payload extraction fused with the symbol deinterleaver (R3+R5):
    f(cells) (..., 68k, K) -> (..., 68k, n_payload) deinterleaved."""
    t = _frame_tables(mode)
    pair = si._perm_pair(mode, deinterleave=True)
    idx = np.stack([t["data_idx"][p][pair[p % 2]] for p in range(4)])
    return _row_take(idx, device)
