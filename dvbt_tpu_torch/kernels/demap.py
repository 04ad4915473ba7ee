"""Demap and deinterleave of the receiver's payload cells (R3 + R4 + R5 +
R6; the ``demap_deinterleave`` stage): the CUDA kernel and its plain
version.

Replaces no TPU kernel: the JAX package leaves the stage to XLA, which
fuses it.  The plain version is the port's composition: the cell
deinterleaver (payload extraction fused with the symbol deinterleaver),
the hard demapper (saturated metrics {0, 15}) or the CSI-weighted per-axis
max-log soft demapper, the bit deinterleaver and, in hierarchical modes,
the HP/LP split.  On the card that is ~30 operations, each writing a
full-size intermediate to HBM; the kernel (``csrc/demap.cu``) does the
whole stage in one launch, one block a symbol row, with every intermediate
in shared memory: it is bound by the carriers (and channel estimate) it
reads and the metrics it writes.

Dispatch is by tensor device only: CPU tensors take the plain version,
CUDA tensors the kernel (or an error).  ``_build.launches`` counts its
launches as ``demap``, one a call whatever the number of streams.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..mode import DvbtMode
from ..ops import bit_interleaver, mapper, reference_signals
from . import _build

BLOCK_CELLS = tables.BIT_ILV_BLOCK
CONSTS_WORDS = 52          # csrc/demap.cu's DemapConsts


def _check_demap(demap: str) -> None:
    if demap not in ("hard", "soft"):
        raise ValueError(f"demap={demap!r} is not 'hard' or 'soft'")


def make_stream_metrics(mode: DvbtMode, device, demap: str = "hard"):
    """The K1 inputs of each stream from cell-deinterleaved equalized
    cells, as the plain version computes them.  Returns metrics(cells,
    H=None, rows=slice(None)) -> (bits_hp,) or, in hierarchical modes,
    (bits_hp, bits_lp), each uint8 (n_mux, n_coded) soft metrics 0..15.

    cells: the cell-deinterleaved equalized payload cells (n_mux, S, P) of
    the symbol rows ``rows``; H: the channel estimate (n_mux, S0, K) over
    every row, or None without equalization.  ``demap="hard"``: hard
    decisions as saturated metrics {0, 15}; ``"soft"``: max-log metrics
    weighted by the channel state |H|^2, normalized over each symbol's
    carriers and permuted like the cells.  Of each cell's v bits the first
    2 go to HP and the rest to LP [EN300744 §4.3.4.1]."""
    _check_demap(demap)
    soft = demap == "soft"
    if soft:
        cell_dilv = reference_signals.make_cell_deinterleaver(mode, device)
        soft_demap = mapper.make_soft_demapper(mode, device)
        bit_dilv = bit_interleaver.make_soft_bit_deinterleaver(mode, device)
    else:
        qdemap = mapper.make_demapper(mode, device)
        bit_dilv = bit_interleaver.make_bit_deinterleaver(mode, device,
                                                          scale=15)

    def metrics(cells: torch.Tensor, H: torch.Tensor | None = None,
                rows: slice = slice(None)):
        if soft:
            # CSI: noise after zero-forcing is amplified by 1/|H|^2, so
            # faded carriers must speak softly
            csi = None
            if H is not None:
                csi = H.abs() ** 2
                csi = cell_dilv(csi / csi.mean(-1, keepdim=True))[:, rows]
            bits = bit_dilv(soft_demap(cells, csi))
        else:
            bits = bit_dilv(qdemap(cells))
        return split_streams(mode, bits)

    return metrics


def split_streams(mode: DvbtMode, bits: torch.Tensor) -> tuple:
    """Bit-deinterleaved metrics (n_mux, ...) in coded order -> (bits_hp,)
    or, in hierarchical modes, (bits_hp, bits_lp), each (n_mux, n_coded):
    of each cell's v bits the first 2 go to HP and the rest to LP
    [EN300744 §4.3.4.1]."""
    n = bits.shape[0]
    if not mode.hierarchical:
        return (bits.reshape(n, -1),)
    grouped = bits.reshape(n, -1, mode.n_payload, mode.v)
    return (grouped[..., :2].reshape(n, -1),
            grouped[..., 2:].reshape(n, -1))


def make_demap_deinterleave_plain(mode: DvbtMode, device,
                                  demap: str = "hard"):
    """The plain version: run(X, H=None) -> (bits_hp,) or (bits_hp,
    bits_lp) from the equalized carriers X (n_mux, S, K) and, for the soft
    CSI, the channel estimate H alike: ``cell_dilv`` then
    ``make_stream_metrics``."""
    cell_dilv = reference_signals.make_cell_deinterleaver(mode, device)
    metrics = make_stream_metrics(mode, device, demap)
    soft = demap == "soft"

    def run(X: torch.Tensor, H: torch.Tensor | None = None) -> tuple:
        return metrics(cell_dilv(X), H if soft else None)

    return run


def stream_widths(mode: DvbtMode) -> tuple:
    """(first cell bit, bits a cell) of each stream: HP takes each cell's
    first 2 bits and LP the rest in hierarchical modes [EN300744
    §4.3.4.1]; otherwise one stream takes all v."""
    if mode.hierarchical:
        return ((0, 2), (2, mode.v - 2))
    return ((0, mode.v),)


def kernel_tables(mode: DvbtMode, demap: str = "hard") -> dict:
    """The kernel's tables as numpy arrays: ``cell_idx`` int16 (4, P), the
    carrier of each deinterleaved payload cell by symbol mod 4;
    ``perm`` uint16 (126 v), each stream's in-block table in turn, entry r
    of a stream's 126-cell block (r < 126 w) reading cell ``perm >> 3`` of
    the block and bit ``perm & 7`` (y0 the cell's MSB); ``consts`` int32
    (CONSTS_WORDS,), ``DemapConsts``: the hard demapper's scale, alpha and
    (sign, level) -> cell-bit tables, the soft one's float32 1 / dmin2
    and per-axis levels and levels^2 / 2."""
    _check_demap(demap)
    v = mode.v
    inv = bit_interleaver._inverse(mode, "cpu").numpy()    # (126 v,)
    perm = []
    for j0, w in stream_widths(mode):
        r = np.arange(BLOCK_CELLS * w)
        src = inv[(r // w) * v + j0 + r % w]               # c * v + bit
        perm.append(((src // v) << 3) | (src % v))
    words = np.zeros(CONSTS_WORDS, np.int32)
    floats = words.view(np.float32)
    if demap == "hard":
        scale, alpha, m, i_contrib, q_contrib = mapper._axis_tables(mode)
        floats[0:2] = scale, alpha
        words[4:4 + 2 * m] = i_contrib
        words[12:12 + 2 * m] = q_contrib
    else:
        axes, dmin2 = mapper.soft_tables(mode)
        # the plain version on the card multiplies by the float32
        # reciprocal where it divides by dmin2
        floats[2] = np.float32(1) / np.float32(dmin2)
        for a, (lv, hsq) in enumerate(axes):
            floats[20 + 16 * a:20 + 16 * a + lv.size] = lv
            floats[28 + 16 * a:28 + 16 * a + lv.size] = hsq
    idx = reference_signals.cell_deinterleaver_index(mode)
    return {"cell_idx": idx.astype(np.int16),
            "perm": np.concatenate(perm).astype(np.uint16),
            "consts": words}


def _check_input(mode: DvbtMode, what: str, t: torch.Tensor,
                 device=None) -> None:
    """Raise unless t is a contiguous complex64 (n_mux, S, K) tensor, S a
    positive multiple of 4, on ``device`` where given."""
    if t.dtype != torch.complex64:
        raise TypeError(f"demap_deinterleave: {what} must be complex64, not "
                        f"{t.dtype}")
    if t.dim() != 3 or t.shape[-1] != mode.n_carriers:
        raise ValueError(f"demap_deinterleave: {what} {tuple(t.shape)} are "
                         f"not (n_mux, S, {mode.n_carriers})")
    if t.shape[1] == 0 or t.shape[1] % 4:
        raise ValueError(f"demap_deinterleave: {t.shape[1]} symbols is not "
                         "a positive multiple of 4 (whole pilot periods)")
    if not t.is_contiguous():
        raise ValueError(f"demap_deinterleave: {what} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"demap_deinterleave: {what} on {t.device}, not "
                         f"{device}")


def make_demap_deinterleave(mode: DvbtMode, device, demap: str = "hard"):
    """The ``demap_deinterleave`` stage: run(X, H=None) -> (bits_hp,) or,
    in hierarchical modes, (bits_hp, bits_lp), each uint8 (n_mux,
    S * n_payload * w) K1 metrics 0..15 in coded order, from the
    equalized carriers X complex64 (n_mux, S, K) (row 0 a frame's symbol
    0, S a multiple of 4) and, for the soft demap's CSI, the channel
    estimate H alike (None: unweighted; the hard demap ignores it).

    CUDA tensors run the kernel in one launch, CPU tensors the plain
    version; the kernel's tables are made here, outside any CUDA graph
    capture, when ``device`` is a CUDA device."""
    device = torch.device(device)
    plain = make_demap_deinterleave_plain(mode, device, demap)
    soft = demap == "soft"
    lp = mode.hierarchical
    widths = [w for _, w in stream_widths(mode)]
    dev_tables = None
    if device.type == "cuda":
        np_tables = kernel_tables(mode, demap)
        dev_tables = {k: torch.from_numpy(v.view(np.int16) if k == "perm"
                                          else v).to(device)
                      for k, v in np_tables.items()}

    def run(X: torch.Tensor, H: torch.Tensor | None = None) -> tuple:
        _check_input(mode, "X", X)
        H = H if soft else None
        if H is not None:
            _check_input(mode, "H", H, X.device)
            if H.shape != X.shape:
                raise ValueError(f"demap_deinterleave: H {tuple(H.shape)} "
                                 f"is not X's {tuple(X.shape)}")
        if X.device.type == "cpu":
            return plain(X, H)
        if dev_tables is None or X.device != dev_tables["perm"].device:
            raise ValueError(f"demap_deinterleave: X on {X.device}; the "
                             f"kernel's tables were made for {device}")
        n_mux, S, K = X.shape
        P = mode.n_payload
        outs = [torch.empty(n_mux, S * P * w, dtype=torch.uint8,
                            device=X.device) for w in widths]
        code = _build.library().dvbt_demap(
            X.data_ptr(), None if H is None else H.data_ptr(),
            dev_tables["cell_idx"].data_ptr(), dev_tables["perm"].data_ptr(),
            dev_tables["consts"].data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if lp else None, n_mux * S, S, K, P, mode.v,
            int(soft), torch.cuda.current_stream(X.device).cuda_stream)
        _build.check(code, "dvbt_demap", kernel="demap")
        return tuple(outs)

    return run
