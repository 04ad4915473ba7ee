"""Time-axis parallelism: one DVB-T stream sharded over ranks.

Counterpart of dvbt_tpu/parallel/time_sharding.py, with its contracts and
without its ``shard_map`` formulation: rank d of D processes block
s*D + d of step s.  No carried state passes along the chain; each rank
recomputes the state entering its block from a bounded halo of its left
neighbour's data (overlap-save):

  TX state from the last 12 packets of the previous block: dispersal phase
  and frame index are functions of the block index; the outer-interleaver
  tail is the last 2244 bytes of the re-encoded halo; the coder state is
  the last 6 bits of the interleaved stream before the block.
  RX state from the last H symbol periods of the previous block's signal:
  the halo is decoded with a cold Viterbi (kernel K3), whose garbage start
  dies out long before the tail that is kept; the deinterleaver tail is the
  last 2244 decoded bytes, the Viterbi warm-up the last ``overlap``
  depunctured steps, the channel estimator's pilot history the last 3
  symbols (CHAN_WARMUP extra halo symbols make it exact), the scrambler
  phase analytic.

The halos ride the halo ring (parallel/ring.py: K4 on the card with
``halo="ring"``, plain send/recv with ``halo="ppermute"``); rank 0's halo
is the tail of the previous step, which every rank carries.  The result is
byte-identical to the single-process streaming chain.  Each rank's tx/rx
run one block with a mux axis of 1; the hierarchical and soft-demap
variants of the JAX module are not ported yet (ROADMAP queue 1, items 20
and 19).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..mode import OUTER_I, RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
from ..kernels import viterbi as kvit
from ..models import rx as rxm
from ..models import tx as txm
from ..ops import (bit_interleaver, energy, inner_coder, mapper, ofdm,
                   outer_interleaver, reed_solomon, reference_signals,
                   viterbi)
from ..utils.bits import bits_to_bytes
from . import multihost, ring

HALO_PACKETS = 12  # > (2244 + 1) / 204
CHAN_WARMUP = 3    # extra halo symbols feeding the time channel estimator


def _stream_rate(mode: DvbtMode, stream: str) -> str:
    return mode.code_rate if stream == "hp" else mode.code_rate_lp


def rx_halo_symbols(mode: DvbtMode) -> int:
    """Symbols needed to recompute the RX carried state: 2244
    deinterleaver-tail bytes + Viterbi cold-start slack, plus CHAN_WARMUP
    symbols of pilot history; hierarchical modes take the max over their
    HP and LP streams."""
    streams = ("hp", "lp") if mode.hierarchical else ("hp",)
    h = 0
    for stream in streams:
        need_bits = ((outer_interleaver.TAIL + 64) * 8
                     + viterbi.effective_overlap(_stream_rate(mode, stream)))
        per_sym = int(mode.stream_info_bits_per_symbol(stream))
        h = max(h, -(-need_bits // per_sym))
    h += CHAN_WARMUP
    if h >= SYMBOLS_PER_FRAME:
        raise ValueError(f"halo of {h} symbols is not under one frame")
    return h


def make_tx_state_from_halo(mode: DvbtMode, device):
    """f(block_idx, halo uint8 (n_mux, 12, 188)) -> the TX carried state
    (n_mux, ...) that streaming TX carries into block ``block_idx``, from
    the last 12 packets before it.  Block 0's state is the initial one;
    the caller substitutes it, as the JAX package does."""
    rxm.check_ported(mode)
    n_halo_bytes = HALO_PACKETS * RS_PACKET
    disperse = energy.make_energy_dispersal(HALO_PACKETS, device)
    rs_enc = reed_solomon.make_rs_encoder(device)
    shifts = torch.arange(5, -1, -1, dtype=torch.uint8, device=device)
    p_blk = mode.packets_per_block

    def recompute(block_idx: int, halo: torch.Tensor) -> dict:
        n = halo.shape[0]
        first_pk = block_idx * p_blk

        def full(v: int) -> torch.Tensor:
            return torch.full((n,), v, dtype=torch.int32, device=device)

        _, randomized = disperse(full((first_pk - HALO_PACKETS) % 8), halo)
        bstream = rs_enc(randomized).reshape(n, -1)       # (n, 2448)
        # interleaved byte at global position G-1 (G = block start): branch
        # j = (G-1) % 12 reads stream byte (G-1) - j*204
        j = (first_pk * RS_PACKET - 1) % OUTER_I
        src = n_halo_bytes - 1 - j * RS_PACKET
        return {
            "dispersal_phase": full(first_pk % 8),
            "outer_tail": bstream[:, -outer_interleaver.TAIL:],
            "coder_state": (bstream[:, src:src + 1] >> shifts) & 1,
            "frame_idx": full((block_idx * mode.frames_per_block) % 4),
        }

    return recompute


def make_rx_state_from_halo(mode: DvbtMode, device, demap: str = "hard"):
    """f(block_idx, halo_iq complex64 (n_mux, H * symbol_len)) -> the RX
    carried state (n_mux, ...) that the streaming receiver carries into
    block ``block_idx``.  halo_iq are the last H symbol periods of the
    previous block; block_idx 0 means stream start (zero state)."""
    rxm.check_ported(mode, demap=demap)
    H = rx_halo_symbols(mode)
    Hd = H - CHAN_WARMUP          # symbols decoded for the byte state
    n_blk_sym = mode.frames_per_block * SYMBOLS_PER_FRAME
    rate = mode.code_rate
    n_info = Hd * int(mode.stream_info_bits_per_symbol("hp"))
    ov = viterbi.effective_overlap(rate)
    p_blk = mode.packets_per_block

    demod = ofdm.make_ofdm_demodulator(mode, device, n_sym=H)
    chan_est = reference_signals.make_time_channel_estimator(mode, device)
    cell_dilv = reference_signals.make_cell_deinterleaver(mode, device)
    qdemap = mapper.make_demapper(mode, device)
    bit_dilv = bit_interleaver.make_bit_deinterleaver(mode, device, scale=15)
    depunct = inner_coder.make_depuncture(n_info, rate)
    vit = kvit.make_viterbi_decoder(n_info, body=min(1024, n_info),
                                    overlap=ov)
    # the halo symbols sit at frame rows (n_blk_sym - H .. n_blk_sym - 1)
    # mod 68, and the estimator and deinterleaver tables are indexed by
    # row, so the halo is embedded into a 68-row board at first_sym.  Its
    # first CHAN_WARMUP symbols only feed the estimator's pilot history.
    first_sym = (n_blk_sym - H) % SYMBOLS_PER_FRAME
    if first_sym + H > SYMBOLS_PER_FRAME:
        raise ValueError("the halo straddles a frame boundary")
    rows = slice(first_sym + CHAN_WARMUP, first_sym + H)

    def decode(halo_iq: torch.Tensor) -> dict:
        n = halo_iq.shape[0]
        spec = demod(halo_iq)                               # (n, H, K)
        board = spec.new_zeros(n, SYMBOLS_PER_FRAME, mode.n_carriers)
        board[:, first_sym:first_sym + H] = spec
        # the zero rows and valid=False only affect rows < first_sym + 3,
        # which are never decoded; chan_tail comes out as the pilot
        # estimates of rows 65..67 = the block's last 3 symbols
        tail0, valid0 = reference_signals.init_time_channel_state(mode, n,
                                                                  device)
        chan_tail, Hh = chan_est(tail0, valid0, board)
        # demap only the decoded rows (the demap is elementwise, so it
        # commutes with the cell permutation): the estimate of a row next
        # to the zero rows may be 0, and 0/0 must not reach the demapper
        cells = qdemap(cell_dilv(board / Hh)[:, rows])      # (n, Hd, P)
        bits = bit_dilv(cells).reshape(n, -1)               # {0, 15}
        x, y, xm, ym = (s.contiguous() for s in depunct(bits))
        _, info = vit(kvit.init_state(n, device, ov), x, y, xm, ym)
        # the halo ends on a byte boundary of the stream; drop the bits
        # before the first whole byte
        sbytes = bits_to_bytes(info[:, n_info % 8:])
        return {
            "deint_tail": sbytes[:, -outer_interleaver.TAIL:],
            "viterbi": {k: v[:, -ov:].contiguous() for k, v in
                        zip(("x", "y", "xm", "ym"), (x, y, xm, ym))},
            "chan_tail": chan_tail,
        }

    def recompute(block_idx: int, halo_iq: torch.Tensor) -> dict:
        n = halo_iq.shape[0]
        first = block_idx == 0
        if first:
            # stream start: nothing before the block, the zero state (the
            # JAX package decodes the halo and masks the result to it)
            tail, _ = reference_signals.init_time_channel_state(mode, n,
                                                                device)
            st = {"deint_tail": outer_interleaver.init_state(n, device),
                  "viterbi": kvit.init_state(n, device, ov),
                  "chan_tail": tail}
        else:
            st = decode(halo_iq)
        # the stream entering RS at block b starts at TS packet b*P - 11
        # (outer delay): the phase the streaming detector converges to
        st["descr_phase"] = torch.full((n,), (block_idx * p_blk - 11) % 8,
                                       dtype=torch.int32, device=device)
        st["descr_locked"] = torch.ones(n, dtype=torch.bool, device=device)
        st["chan_valid"] = torch.full((n,), not first, dtype=torch.bool,
                                      device=device)
        return st

    return recompute


def make_time_sharded_loopback(mode: DvbtMode, device, group=None,
                               halo: str = "ring", demap: str = "hard"):
    """Returns (step, n_pk_blk, carry0, close); every rank of ``group``
    (None: the world) calls ``step`` once per step, and ``close()`` once
    at the end (collective: it frees the halo rings' IPC buffers).

    step(carry, packets uint8 (P, 188) of this rank's block)
      -> (carry', ts uint8 (P, 188), fleet metrics)

    Rank d transmits and receives block step*D + d.  carry = (prev_pk
    uint8 (12, 188), prev_iq complex64 (H * symbol_len,), step_idx int):
    the last rank's packet and sample tails of the previous step, the same
    on every rank.  ``halo="ring"`` moves the halos with K4 on CUDA
    tensors; ``"ppermute"`` with plain send/recv.  fleet holds
    ``rs_uncorrectable_total``, summed over the ranks."""
    if halo not in ("ring", "ppermute"):
        raise ValueError(f"halo={halo!r} is not 'ring' or 'ppermute'")
    rxm.check_ported(mode, demap=demap)
    D = dist.get_world_size(group)
    d = dist.get_rank(group)
    tx, n_pk, _ = txm.make_transmitter(mode, device)
    rx, _, _ = rxm.make_receiver(mode, device, metrics="min")
    tx_state_of = make_tx_state_from_halo(mode, device)
    rx_state_of = make_rx_state_from_halo(mode, device, demap)
    halo_samp = rx_halo_symbols(mode) * mode.symbol_len
    if halo == "ring":
        rings = (ring.make_ring_shift(group), ring.make_ring_shift(group))
        shift_pk, shift_iq = rings
    else:
        rings = ()

        def shift_pk(x):
            return ring.ring_shift_plain(x, group)
        shift_iq = shift_pk

    def step(carry, packets: torch.Tensor):
        prev_pk, prev_iq, step_idx = carry
        block_idx = step_idx * D + d
        # --- TX ----------------------------------------------------------
        my_tail_pk = packets[-HALO_PACKETS:]
        halo_pk = shift_pk(my_tail_pk)
        if d == 0:
            halo_pk = prev_pk
        if block_idx == 0:
            tstate = txm.init_tx_state(mode, 1, device)
        else:
            tstate = tx_state_of(block_idx, halo_pk[None])
        _, iq = tx(tstate, packets[None])
        # --- RX (sample halo from the left neighbour's TX output) --------
        my_tail_iq = iq[0, -halo_samp:]
        halo_iq = shift_iq(my_tail_iq)
        if d == 0:
            halo_iq = prev_iq
        rstate = rx_state_of(block_idx, halo_iq[None])
        _, ts, metrics = rx(rstate, iq)
        fleet = {"rs_uncorrectable_total": multihost.all_reduce_sum(
            metrics["rs_uncorrectable"].sum(), group)}
        # the next step's rank 0 continues from the last rank's tails
        last_pk = multihost.broadcast(my_tail_pk, D - 1, group)
        last_iq = multihost.broadcast(my_tail_iq, D - 1, group)
        for r in rings:
            r.check()
        return (last_pk, last_iq, step_idx + 1), ts[0], fleet

    carry0 = (torch.zeros(HALO_PACKETS, 188, dtype=torch.uint8,
                          device=device),
              torch.zeros(halo_samp, dtype=torch.complex64, device=device),
              0)
    def close():
        for r in rings:
            r.close()

    return step, n_pk, carry0, close
