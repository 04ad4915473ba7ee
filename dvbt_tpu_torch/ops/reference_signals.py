"""Frame adaptation, pilots & TPS (T8) and their RX-side duals (R3),
EN300744 §4.4 (frame adaptation), §4.5 (pilots), §4.6 (TPS).

Counterpart of dvbt_tpu/ops/reference_signals.py: the TX frame builder
and frame adapter, and on the RX side the two channel estimators (time
and frequency interpolation), payload extraction, the cell deinterleaver
and the TPS decoder.  A frame is 68 symbols;
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

from .. import tables
from ..mode import SYMBOLS_PER_FRAME, DvbtMode
from ..utils.cplx import cis

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

    # scattered-pilot carriers per phase, padded to the max count, and for
    # every (l, k) the left pilot slot and linear weight of the frequency
    # interpolation
    n_sp_max = max(len(sp) for sp in sp_list)
    sp_idx = np.zeros((4, n_sp_max), dtype=np.int32)
    left_slot = np.zeros((4, K), dtype=np.int32)
    weight = np.zeros((4, K), dtype=np.float32)
    for l in range(4):
        sp = sp_list[l]
        n_sp = len(sp)
        sp_idx[l, :n_sp] = sp
        sp_idx[l, n_sp:] = sp[-1]
        pos = (np.arange(K) - sp[0]) / 12.0
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_sp - 2)
        weight[l] = np.clip(pos - i0, 0.0, 1.0).astype(np.float32)
        left_slot[l] = i0.astype(np.int32)
    pilot_ref = PILOT_BOOST * sign_w[sp_idx]  # (4, n_sp_max)
    return dict(pilot_rows=pilot_rows, data_idx=data_idx, tp=tp,
                tps_cells=tps_cells, sp_idx=sp_idx, pilot_ref=pilot_ref,
                left_slot=left_slot, weight=weight)


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


def make_chan_tail_retimer(mode: DvbtMode, device):
    """f(tail, adj) -> tail' compensating a sample-clock timing step.

    Consuming ``adj`` extra samples before a block moves the FFT window
    later, so the channel's delay drops by adj and every later H(k) picks
    up the linear phase e^{+j 2 pi f(k) adj / N}, f(k) = k - kmax/2 the
    signed subcarrier frequency (exact for integer adj).  The carried
    pilot history gets the same phase so that it stays coherent with the
    next block's pilots.  tail: complex64 (n_mux, 3, n_sp); adj: integer
    (n_mux,).  adj == 0 multiplies by exactly 1+0j."""
    t = _frame_tables(mode)
    f = torch.as_tensor(t["sp_idx"][1:4].astype(np.float32)
                        - np.float32(mode.kmax // 2), device=device)
    two_pi_over_n = float(np.float32(2.0 * np.pi / mode.fft_len))

    def retime(tail: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        ang = two_pi_over_n * adj.to(torch.float32)
        return (tail * cis(ang[:, None, None] * f)).to(torch.complex64)

    return retime


def cell_deinterleaver_index(mode: DvbtMode) -> np.ndarray:
    """(4, n_payload) carrier of each deinterleaved payload cell, by symbol
    index mod 4: the payload carriers composed with the even/odd H(q)."""
    t = _frame_tables(mode)
    pair = si._perm_pair(mode, deinterleave=True)
    return np.stack([t["data_idx"][p][pair[p % 2]] for p in range(4)])


def make_cell_deinterleaver(mode: DvbtMode, device):
    """RX payload extraction fused with the symbol deinterleaver (R3+R5):
    f(cells) (..., 68k, K) -> (..., 68k, n_payload) deinterleaved."""
    return _row_take(cell_deinterleaver_index(mode), device)


def make_frame_adapter(mode: DvbtMode, device):
    """TX frame adaptation (the ``reference_signals`` step without the
    symbol interleaver).  Returns apply(frame_idx, data): data complex64
    (..., 68, n_payload) -> carriers (..., 68, K); frame_idx int (...)
    frame numbers, mod 4 selecting the TPS payload."""
    t = _frame_tables(mode)
    ref_np = np.tile(t["pilot_rows"].astype(np.complex64)[None],
                     (4, _TILE, 1))
    ref_np[:, :, t["tp"]] = t["tps_cells"].astype(np.complex64)
    ref = torch.as_tensor(ref_np, device=device)      # (4, 68, K)
    data_idx = torch.as_tensor(np.tile(t["data_idx"], (_TILE, 1)).astype(
        np.int64), device=device)                     # (68, n_payload)

    def apply(frame_idx, data: torch.Tensor) -> torch.Tensor:
        fidx = torch.as_tensor(frame_idx, device=data.device)
        tmpl = ref[fidx.to(torch.int64) % 4]
        out = tmpl.expand(*data.shape[:-1], ref.shape[-1]).clone()
        return out.scatter_(-1, data_idx.expand(data.shape),
                            data.to(torch.complex64))

    return apply


def make_channel_estimator(mode: DvbtMode, device):
    """RX LS channel estimate with linear frequency interpolation between
    the current symbol's scattered pilots (every 12th carrier; the
    ``demod_reference_signals`` block, ``chan_est="freq"``).  Stateless.

    Returns estimate(Y): complex64 (..., S, K) -> H (..., S, K), row phase
    = row index mod 4, S % 4 == 0."""
    t = _frame_tables(mode)
    pilot_ref = torch.as_tensor(t["pilot_ref"].astype(np.complex64),
                                device=device)            # (4, n_sp)
    weight = torch.as_tensor(t["weight"], device=device)  # (4, K)
    take_sp = _row_take(t["sp_idx"], device)
    take_hl = _row_take(t["left_slot"], device)
    take_hr = _row_take(t["left_slot"] + 1, device)

    def estimate(Y: torch.Tensor) -> torch.Tensor:
        S = Y.shape[-2]
        if S % 4:
            raise ValueError(f"{S} symbols is not a whole pilot period")
        w = weight.repeat(S // 4, 1)
        Hp = take_sp(Y) / pilot_ref.repeat(S // 4, 1)
        return take_hl(Hp) * (1.0 - w) + take_hr(Hp) * w

    return estimate


def make_payload_extractor(mode: DvbtMode, device):
    """RX: the n_payload data cells of each symbol, in carrier order.
    Returns extract(X): (..., S, K) -> (..., S, n_payload), S % 4 == 0."""
    return _row_take(_frame_tables(mode)["data_idx"], device)


def make_tps_decoder(mode: DvbtMode, device):
    """RX: DBPSK-demodulate the TPS bits of frame-aligned symbols.

    Returns decode(Y): complex64 (..., 68, K) -> (bits uint8 (..., 68),
    frame_num int32 (...)).  Bit l >= 1 is the majority vote over the TPS
    carriers of the differential phase between symbols l-1 and l; s0 is
    reported as 0 (the modulation init, not data); frame_num is s23 s24."""
    tp = torch.as_tensor(_frame_tables(mode)["tp"].astype(np.int64),
                         device=device)

    def decode(Y: torch.Tensor):
        cells = Y.index_select(-1, tp)                   # (..., 68, n_tps)
        diff = cells[..., 1:, :] * cells[..., :-1, :].conj()
        votes = diff.real.sum(-1)                        # (..., 67)
        bits = (votes < 0).to(torch.uint8)
        s = torch.cat([torch.zeros_like(bits[..., :1]), bits], dim=-1)
        frame_num = ((s[..., 23].to(torch.int32) << 1)
                     | s[..., 24].to(torch.int32))
        return s, frame_num

    return decode


def expected_tps_bits(mode: DvbtMode, frame_idx: int) -> np.ndarray:
    """Host-side TPS reference (s0 zeroed like the decoder)."""
    s = mode.tps_bits(frame_idx).copy()
    s[0] = 0
    return s
