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

With ``demap="soft"`` the halo decode computes the receiver's own
CSI-weighted soft metrics.  Hierarchical modes carry two transport
streams: the packet halos, the TX state and the halo decode's byte state
are per stream (HP and LP, each at its own rate), while the sample halo
and the channel state are shared; a step then moves three halos (HP
packets, LP packets, IQ).

The halos ride the halo ring (parallel/ring.py: K4 on the card with
``halo="ring"``, plain send/recv with ``halo="ppermute"``); rank 0's halo
is the tail of the previous step, which every rank carries.  The result is
byte-identical to the single-process streaming chain.  Each rank's tx/rx
run one block with a mux axis of 1.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..mode import OUTER_I, RS_PACKET, SYMBOLS_PER_FRAME, DvbtMode
from ..kernels import viterbi as kvit
from ..models import rx as rxm
from ..models import tx as txm
from ..ops import (energy, inner_coder, ofdm, outer_interleaver,
                   reed_solomon, reference_signals, viterbi)
from ..utils.bits import bits_to_bytes
from ..utils.streams import join, split
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


def halo_decode_shapes(mode: DvbtMode) -> dict:
    """{stream: (n_info, rate, body, overlap)}: the K3 decode of each
    stream's RX halo, its info bits over the decoded halo symbols (an LP
    stream's need not be whole bytes), its code rate, window body and
    overlap."""
    n_sym = rx_halo_symbols(mode) - CHAN_WARMUP
    shapes = {}
    for stream in mode.streams:
        n_info = n_sym * int(mode.stream_info_bits_per_symbol(stream))
        rate = _stream_rate(mode, stream)
        shapes[stream] = (n_info, rate, min(1024, n_info),
                          viterbi.effective_overlap(rate))
    return shapes


def make_tx_state_from_halo(mode: DvbtMode, device, stream: str = "hp"):
    """f(block_idx, halo uint8 (n_mux, 12, 188)) -> the TX carried state
    (n_mux, ...) of ``stream`` that streaming TX carries into block
    ``block_idx``, from the stream's last 12 packets before it (the HP
    state also holds frame_idx).  Block 0's state is the initial one; the
    caller substitutes it, as the JAX package does."""
    n_halo_bytes = HALO_PACKETS * RS_PACKET
    disperse = energy.make_energy_dispersal(HALO_PACKETS, device)
    rs_enc = reed_solomon.make_rs_encoder(device)
    shifts = torch.arange(5, -1, -1, dtype=torch.uint8, device=device)
    p_blk = mode.stream_packets_per_block(stream)

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
        st = {
            "dispersal_phase": full(first_pk % 8),
            "outer_tail": bstream[:, -outer_interleaver.TAIL:],
            "coder_state": (bstream[:, src:src + 1] >> shifts) & 1,
        }
        if stream == "hp":     # the frame counter rides the HP state
            st["frame_idx"] = full((block_idx * mode.frames_per_block) % 4)
        return st

    return recompute


def make_rx_state_from_halo(mode: DvbtMode, device, demap: str = "hard"):
    """f(block_idx, halo_iq complex64 (n_mux, H * symbol_len)) -> the RX
    carried state (n_mux, ...) that the streaming receiver carries into
    block ``block_idx`` (in hierarchical modes with the LP stream's under
    ``"lp"``).  halo_iq are the last H symbol periods of the previous
    block; block_idx 0 means stream start (zero state).  ``demap`` must
    match the receiver the state feeds: the halo decode reproduces its
    metrics, the CSI-weighted soft ones with ``"soft"``."""
    stream_metrics = rxm.make_stream_metrics(mode, device, demap)
    H = rx_halo_symbols(mode)
    n_blk_sym = mode.frames_per_block * SYMBOLS_PER_FRAME

    demod = ofdm.make_ofdm_demodulator(mode, device, n_sym=H)
    chan_est = reference_signals.make_time_channel_estimator(mode, device)
    cell_dilv = reference_signals.make_cell_deinterleaver(mode, device)
    sdec = {s_: (inner_coder.make_depuncture(n_info, rate),
                 kvit.make_viterbi_decoder(n_info, body=body, overlap=ov),
                 n_info, ov)
            for s_, (n_info, rate, body, ov) in halo_decode_shapes(mode).items()}
    # the halo symbols sit at frame rows (n_blk_sym - H .. n_blk_sym - 1)
    # mod 68, and the estimator and deinterleaver tables are indexed by
    # row, so the halo is embedded into a 68-row board at first_sym.  Its
    # first CHAN_WARMUP symbols only feed the estimator's pilot history.
    first_sym = (n_blk_sym - H) % SYMBOLS_PER_FRAME
    if first_sym + H > SYMBOLS_PER_FRAME:
        raise ValueError("the halo straddles a frame boundary")
    rows = slice(first_sym + CHAN_WARMUP, first_sym + H)

    def stream_state(s_, bits: torch.Tensor) -> dict:
        depunct, vit, n_info, ov = sdec[s_]
        n = bits.shape[0]
        x, y, xm, ym = (t.contiguous() for t in depunct(bits))
        _, info = vit(kvit.init_state(n, device, ov), x, y, xm, ym)
        # the halo ends on a byte boundary of the stream, and an LP
        # stream's halo need not hold whole bytes: drop the bits before
        # the first whole byte
        sbytes = bits_to_bytes(info[:, n_info % 8:])
        return {
            "deint_tail": sbytes[:, -outer_interleaver.TAIL:],
            "viterbi": {k: v[:, -ov:].contiguous() for k, v in
                        zip(("x", "y", "xm", "ym"), (x, y, xm, ym))},
        }

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
        bits = stream_metrics(cell_dilv(board / Hh)[:, rows], Hh, rows)
        st = stream_state("hp", bits[0])
        if mode.hierarchical:
            st["lp"] = stream_state("lp", bits[1])
        st["chan_tail"] = chan_tail
        return st

    def zero_state(s_, n: int) -> dict:
        ov = sdec[s_][3]
        return {"deint_tail": outer_interleaver.init_state(n, device),
                "viterbi": kvit.init_state(n, device, ov)}

    def recompute(block_idx: int, halo_iq: torch.Tensor) -> dict:
        n = halo_iq.shape[0]
        first = block_idx == 0
        if first:
            # stream start: nothing before the block, the zero state (the
            # JAX package decodes the halo and masks the result to it)
            st = zero_state("hp", n)
            if mode.hierarchical:
                st["lp"] = zero_state("lp", n)
            st["chan_tail"], _ = reference_signals.init_time_channel_state(
                mode, n, device)
        else:
            st = decode(halo_iq)
        for s_ in mode.streams:
            sst = st if s_ == "hp" else st["lp"]
            # the stream entering RS at block b starts at TS packet b*P - 11
            # (outer delay): the phase the streaming detector converges to
            p_blk = mode.stream_packets_per_block(s_)
            sst["descr_phase"] = torch.full(
                (n,), (block_idx * p_blk - 11) % 8, dtype=torch.int32,
                device=device)
            sst["descr_locked"] = torch.ones(n, dtype=torch.bool,
                                             device=device)
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
    on every rank.  Hierarchical modes carry two transport streams:
    packets, ts and prev_pk are (hp, lp) pairs and n_pk_blk the (n_hp,
    n_lp) pair.  ``halo="ring"`` moves the halos with K4 on CUDA tensors;
    ``"ppermute"`` with plain send/recv.  ``demap`` is the receiver's and
    the halo decode's.  fleet holds ``rs_uncorrectable_total`` (and
    ``lp_rs_uncorrectable_total``), summed over the ranks."""
    if halo not in ("ring", "ppermute"):
        raise ValueError(f"halo={halo!r} is not 'ring' or 'ppermute'")
    if demap not in ("hard", "soft"):
        raise ValueError(f"demap={demap!r} is not 'hard' or 'soft'")
    D = dist.get_world_size(group)
    d = dist.get_rank(group)
    hier = mode.hierarchical
    tx, n_pk, _ = txm.make_transmitter(mode, device)
    rx, _, _ = rxm.make_receiver(mode, device, metrics="min", demap=demap)
    tx_state_of = {s_: make_tx_state_from_halo(mode, device, s_)
                   for s_ in mode.streams}
    rx_state_of = make_rx_state_from_halo(mode, device, demap)
    halo_samp = rx_halo_symbols(mode) * mode.symbol_len
    if halo == "ring":
        # one ring per halo: each stream's packets, then the samples
        rings = tuple(ring.make_ring_shift(group)
                      for _ in range(len(mode.streams) + 1))
        shifts = rings
    else:
        rings = ()
        shifts = (functools.partial(ring.ring_shift_plain, group=group),
                  ) * (len(mode.streams) + 1)

    def step(carry, packets):
        prev_pk, prev_iq, step_idx = carry
        block_idx = step_idx * D + d
        pks = split(packets, hier)
        prevs = split(prev_pk, hier)
        # --- TX ----------------------------------------------------------
        tails = [pk[-HALO_PACKETS:] for pk in pks]
        halos = [shift(tail) for shift, tail in zip(shifts, tails)]
        if d == 0:
            halos = prevs
        if block_idx == 0:
            tstate = txm.init_tx_state(mode, 1, device)
        else:
            tstate = tx_state_of["hp"](block_idx, halos[0][None])
            if hier:
                tstate["lp"] = tx_state_of["lp"](block_idx, halos[1][None])
        _, iq = tx(tstate, join([pk[None] for pk in pks], hier))
        # --- RX (sample halo from the left neighbour's TX output) --------
        my_tail_iq = iq[0, -halo_samp:]
        halo_iq = shifts[-1](my_tail_iq)
        if d == 0:
            halo_iq = prev_iq
        rstate = rx_state_of(block_idx, halo_iq[None])
        _, ts, metrics = rx(rstate, iq)
        fleet = {"rs_uncorrectable_total": multihost.all_reduce_sum(
            metrics["rs_uncorrectable"].sum(), group)}
        if hier:
            fleet["lp_rs_uncorrectable_total"] = multihost.all_reduce_sum(
                metrics["lp_rs_uncorrectable"].sum(), group)
        # the next step's rank 0 continues from the last rank's tails
        last_pk = tuple(multihost.broadcast(t, D - 1, group) for t in tails)
        last_iq = multihost.broadcast(my_tail_iq, D - 1, group)
        for r in rings:
            r.check()
        out_ts = join([t[0] for t in split(ts, hier)], hier)
        return (join(last_pk, hier), last_iq, step_idx + 1), out_ts, fleet

    pk0 = torch.zeros(HALO_PACKETS, 188, dtype=torch.uint8, device=device)
    carry0 = (join([pk0.clone() for _ in mode.streams], hier),
              torch.zeros(halo_samp, dtype=torch.complex64, device=device),
              0)

    def close():
        for r in rings:
            r.close()

    return step, n_pk, carry0, close
