"""Mux-batch data parallelism over ranks, and the three-stage dryrun.

Counterpart of dvbt_tpu/parallel/sharding.py.  Independent multiplexes
are spread over the ranks of a process group: rank r runs its own
``muxes_per_rank`` muxes through the port's tx/rx (batched over muxes), so
the data path moves nothing between ranks; only the fleet metrics are
summed with ``all_reduce``.  The time axis of one stream is
parallel/time_sharding.py.

``dryrun`` runs in every rank of a group, as ``chip_smoke.py`` does on one
card with 4 ranks, and logs each stage's start and PASS (from rank 0):
  1. mux-DP, two steps: every mux's TS equals the packets sent after the
     11-packet outer-interleaver delay, and the fleet counts no
     uncorrectable packet in the second step;
  2. the time-sharded loopback with plain send/recv halos: its TS over
     D * 2 blocks equals the single-process streaming chain's,
     which rank 0 runs itself;
  3. the same loopback with the halo ring (K4 on CUDA tensors): its TS
     equals stage 2's byte for byte, in every rank.
Hierarchical modes carry (hp, lp) pairs of packets through every stage,
and every check holds for both streams.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..io.ts import make_ts_packets
from ..mode import DvbtMode
from ..models import rx as rxm
from ..models import tx as txm
from ..ops.outer_interleaver import DELAY_PACKETS
from ..utils.streams import join, split
from . import multihost
from . import time_sharding as tsh

N_STEPS = 2          # steps of each dryrun stage


def make_sharded_loopback(mode: DvbtMode, device, muxes_per_rank: int = 1,
                          group=None):
    """Returns (step, init_states, n_packets_per_mux).

    step(states, packets uint8 (muxes_per_rank, P, 188)) -> (states',
    ts (muxes_per_rank, P, 188), fleet); in hierarchical modes packets and
    ts are (hp, lp) pairs and n_packets_per_mux the (n_hp, n_lp) pair.
    fleet holds rs_corrected_total and rs_uncorrectable_total (and
    lp_rs_uncorrectable_total) summed over every mux of every rank of
    ``group`` (None: the world)."""
    tx, n_pk, _ = txm.make_transmitter(mode, device)
    rx, _, _ = rxm.make_receiver(mode, device)

    def step(states, packets):
        tstate, rstate = states
        tstate, iq = tx(tstate, packets)
        rstate, ts, m = rx(rstate, iq)
        keys = ["rs_corrected", "rs_uncorrectable"]
        if mode.hierarchical:
            keys.append("lp_rs_uncorrectable")
        fleet = {f"{k}_total": multihost.all_reduce_sum(m[k].sum(), group)
                 for k in keys}
        return (tstate, rstate), ts, fleet

    def init_states():
        return (txm.init_tx_state(mode, muxes_per_rank, device),
                rxm.init_rx_state(mode, muxes_per_rank, device))

    return step, init_states, n_pk


def _block(packets, n_pk, b: int, hier: bool, device):
    """Block b of each stream's packets, as tensors on ``device``."""
    return join([torch.as_tensor(p[b * n:(b + 1) * n], device=device)
                 for p, n in zip(split(packets, hier), split(n_pk, hier))],
                hier)


def streaming_reference(mode: DvbtMode, device, packets, n_blocks: int,
                        demap: str = "hard"):
    """The single-process streaming chain, one mux: TS of n_blocks blocks
    of ``packets`` (n_blocks * P, 188) through tx/rx with carried state
    (in hierarchical modes both the packets and the TS are (hp, lp)
    pairs)."""
    hier = mode.hierarchical
    tx, n_pk, _ = txm.make_transmitter(mode, device)
    rx, _, _ = rxm.make_receiver(mode, device, metrics="min", demap=demap)
    tst = txm.init_tx_state(mode, 1, device)
    rst = rxm.init_rx_state(mode, 1, device)
    outs = [[] for _ in mode.streams]
    for b in range(n_blocks):
        pk = _block(packets, n_pk, b, hier, device)
        tst, iq = tx(tst, join([p[None] for p in split(pk, hier)], hier))
        rst, ts, _ = rx(rst, iq)
        for o, t in zip(outs, split(ts, hier)):
            o.append(t[0].cpu().numpy())
    return join([np.concatenate(o) for o in outs], hier)


def run_time_sharded(mode: DvbtMode, device, packets, n_steps: int,
                     halo: str, demap: str = "hard"):
    """This rank's TS (n_steps, P, 188) (in hierarchical modes the (hp,
    lp) pair) and the fleet's rs_uncorrectable_total per step, from the
    time-sharded loopback over the world's ranks and ``packets``
    (D * n_steps * P, 188), the same on every rank."""
    D = dist.get_world_size()
    d = dist.get_rank()
    hier = mode.hierarchical
    step, n_pk, carry, close = tsh.make_time_sharded_loopback(
        mode, device, halo=halo, demap=demap)
    outs, bad = [[] for _ in mode.streams], []
    for s in range(n_steps):
        carry, ts, fleet = step(carry, _block(packets, n_pk, s * D + d, hier,
                                              device))
        for o, t in zip(outs, split(ts, hier)):
            o.append(t)
        bad.append(int(fleet["rs_uncorrectable_total"]))
    close()
    return join([torch.stack(o) for o in outs], hier), bad


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun(mode: DvbtMode, n_ranks: int, muxes_per_rank: int = 1,
           device=None, demap: str = "hard") -> dict:
    """Run the three stages in this rank (a collective call over the
    world); raises on any mismatch.  ``device`` defaults to the rank's
    card; ``demap`` is the time-sharded stages' receiver's.  Hierarchical
    modes run both streams through every stage and check each.  Returns
    each stage's seconds and the fleet counts."""
    D = dist.get_world_size()
    d = dist.get_rank()
    if D != n_ranks:
        raise ValueError(f"dryrun for {n_ranks} ranks in a group of {D}")
    device = multihost.rank_device(d) if device is None else device
    hier = mode.hierarchical
    name = (f"{mode.transmission} {mode.constellation} {mode.code_rate}"
            + (f" alpha {mode.alpha} LP {mode.code_rate_lp}" if hier else ""))

    def log(msg):
        if d == 0:
            print(f"[dryrun] {msg}", flush=True)

    out = {}
    # --- stage 1: mux-DP ---------------------------------------------------
    t0 = time.monotonic()
    log(f"stage 1/3 mux-dp start ({name}, {D} ranks x {muxes_per_rank} "
        "mux)")
    step, init_states, n_pk = make_sharded_loopback(mode, device,
                                                    muxes_per_rank)
    lo = d * muxes_per_rank
    sent = [np.stack([make_ts_packets(n, seed=1000 * k + i)
                      for i in range(lo, lo + muxes_per_rank)])
            for k, n in enumerate(split(n_pk, hier))]
    pk = join([torch.as_tensor(x, device=device) for x in sent], hier)
    states = init_states()
    got, bad = [[] for _ in sent], []
    for _ in range(N_STEPS):
        states, ts, fleet = step(states, pk)
        for g, t in zip(got, split(ts, hier)):
            g.append(t.cpu().numpy())
        bad.append(sum(int(v) for k, v in fleet.items()
                       if k.endswith("uncorrectable_total")))
    for g, x in zip(got, sent):
        g = np.concatenate(g, axis=1)
        want = np.concatenate([x] * N_STEPS, axis=1)
        _require(np.array_equal(g[:, DELAY_PACKETS:],
                                want[:, :-DELAY_PACKETS]),
                 f"rank {d}: mux-DP TS differs from the packets sent")
    _require(all(b == 0 for b in bad[1:]),
             f"mux-DP: uncorrectable packets after warm-up: {bad}")
    out["mux_dp"] = {"seconds": time.monotonic() - t0,
                     "rs_uncorrectable_total": bad}
    log(f"stage 1/3 mux-dp PASS ({out['mux_dp']['seconds']:.1f}s)")

    # --- stage 2: time-sharded loopback, plain send/recv halos -------------
    t0 = time.monotonic()
    log(f"stage 2/3 time-ppermute start ({D} ranks x {N_STEPS} steps, "
        f"{demap} demap)")
    n_blocks = D * N_STEPS
    packets = join([make_ts_packets(n * n_blocks, seed=5 + 100 * k)
                     for k, n in enumerate(split(n_pk, hier))], hier)
    ts_p, bad = run_time_sharded(mode, device, packets, N_STEPS, "ppermute",
                                 demap)
    every = [multihost.all_gather(t).cpu().numpy()     # (D, S, P, 188)
             for t in split(ts_p, hier)]
    if d == 0:
        ref = split(streaming_reference(mode, device, packets, n_blocks,
                                           demap), hier)
        for e, r in zip(every, ref):
            sharded = e.transpose(1, 0, 2, 3).reshape(-1, 188)
            _require(np.array_equal(sharded, r),
                     "time-sharded TS differs from the streaming chain")
    _require(bad[0] <= DELAY_PACKETS and all(b == 0 for b in bad[1:]),
             f"time-sharded: uncorrectable packets per step {bad}")
    out["time_ppermute"] = {"seconds": time.monotonic() - t0,
                            "rs_uncorrectable_total": bad}
    log(f"stage 2/3 time-ppermute PASS "
        f"({out['time_ppermute']['seconds']:.1f}s)")

    # --- stage 3: the halo ring == plain send/recv --------------------------
    t0 = time.monotonic()
    kind = "K4 CUDA IPC" if device.type == "cuda" else "plain send/recv"
    log(f"stage 3/3 ring-halo start ({kind} ring @ {name})")
    ts_r, bad = run_time_sharded(mode, device, packets, N_STEPS, "ring",
                                 demap)
    _require(all(torch.equal(r, p) for r, p in zip(split(ts_r, hier),
                                                   split(ts_p, hier))),
             f"rank {d}: ring halo path diverged from the send/recv path")
    out["time_ring"] = {"seconds": time.monotonic() - t0,
                        "rs_uncorrectable_total": bad}
    log(f"stage 3/3 ring-halo PASS ({out['time_ring']['seconds']:.1f}s)")
    return out
