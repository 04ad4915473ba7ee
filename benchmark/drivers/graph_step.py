"""The head-end step: TX then symbol-aligned RX of every mux, replayed as
the program's CUDA graph (``dvbt_tpu_torch.bench.GraphStep``).

Step k sends packet set k mod ``packet_sets`` of a pool made on the device
from the seed, distinct for every mux.  Every step's TS is compared on the
device with the packets sent 11 packets earlier, and its uncorrectable
count must be 0; the samples of two steps drawn from the seed are kept and,
once the window has closed, compared with the plain reference transmitter
(``benchmark/reference/tx.py``) run over the same packets.

The graph step is composed here from the program's public
``make_transmitter``, ``make_receiver`` and ``GraphStep``, as ``make_step``
composes it, so that the receiver takes the configuration's ``demap`` and
the harness can keep the transmitted samples (the graph's ``iq`` buffer,
rewritten by each replay).  On a CPU device the same step runs eagerly.
"""

from __future__ import annotations

import time

import numpy as np

from .. import common
from ..reference import tx as reference

# steps before the window (the first, from zero state, is not checked)
WARMUP_STEPS = 3
# window steps among which the two sampled steps are drawn
SAMPLE_SPAN = 64


def _build(ctx):
    import torch
    from dvbt_tpu_torch import DvbtMode
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm

    dev = torch.device(ctx.device)
    mode = DvbtMode(**ctx.config["mode"])
    n_mux, n_frames = ctx.mix["n_mux"], ctx.mix["frames"]
    tx, n_pk, n_samp = txm.make_transmitter(mode, dev, n_frames)
    rx, _, _ = rxm.make_receiver(mode, dev, n_frames,
                                 **ctx.config["receiver"])
    held: dict = {}

    def eager(tst, rst, packets):
        tst, iq = tx(tst, packets)
        rst, ts, met = rx(rst, iq)
        held["iq"] = iq
        return tst, rst, ts, met["rs_uncorrectable"]

    tst = txm.init_tx_state(mode, n_mux, dev)
    rst = rxm.init_rx_state(mode, n_mux, dev)
    if dev.type == "cuda":
        from dvbt_tpu_torch.bench import GraphStep
        step = GraphStep(eager, tst, rst, torch.zeros(
            n_mux, n_pk, 188, dtype=torch.uint8, device=dev))
    else:
        step = eager
    return step, eager, tst, rst, held, n_pk, n_samp


class _Checker:
    """Per step, on the device: mux-steps with any wrong packet or RS
    failure, wrong packets, uncorrectable packets."""

    def __init__(self, pool):
        import torch
        d = common.DELAY_PACKETS
        S = pool.shape[0]
        self.expected = torch.stack([torch.cat(
            [pool[(s - 1) % S][:, -d:], pool[s][:, :-d]], dim=1)
            for s in range(S)])
        self.acc = torch.zeros(3, dtype=torch.int64, device=pool.device)

    def __call__(self, k: int, ts, bad) -> None:
        with common.check_scope():
            wrong = (ts != self.expected[k % len(self.expected)]).any(-1)
            self.acc[0] += (wrong | bad).any(-1).sum()
            self.acc[1] += wrong.sum()
            self.acc[2] += bad.sum()


def tx_error(cfg: dict, pool, k: int, iq) -> float:
    """Largest distance of a step's samples from the reference's, over the
    reference's RMS: the reference transmits sets k-1 and k from its start
    and the second half is step k (the step carries nothing older)."""
    import torch
    S = pool.shape[0]
    packets = torch.cat([pool[(k - 1) % S], pool[k % S]], dim=1)
    ref = reference.transmit(reference.mode_from(cfg), packets)
    ref = ref[:, ref.shape[1] // 2:]
    err = (iq.to(torch.complex128) - ref).abs().max()
    return float(err / ref.abs().pow(2).mean().sqrt())


def packet_pool(ctx, n_pk: int):
    if ctx.mix["frames"] % 4 or n_pk % 8:
        raise ValueError("a step must be whole superframes of whole energy-"
                         "dispersal groups: the reference restarts there")
    gen = common.generator(ctx.seed, ctx.device)
    return common.ts_packets(gen, (ctx.mix["packet_sets"], ctx.mix["n_mux"],
                                   n_pk, 188), ctx.device)


def run(ctx) -> dict:
    import torch
    step, eager, tst, rst, held, n_pk, n_samp = _build(ctx)
    dev = torch.device(ctx.device)
    pool = packet_pool(ctx, n_pk)
    S = pool.shape[0]
    check = _Checker(pool)
    flight = common.InFlight(dev)
    sent = 0           # steps sent; step k sends set k mod S
    keep: set = set()
    saved = []

    def one():
        nonlocal tst, rst, sent
        k = sent
        tst, rst, ts, bad = step(tst, rst, pool[k % S])
        sent += 1
        if k:          # the first step's TS starts with the empty tail
            check(k, ts, bad)
        if k in keep:
            with common.check_scope():
                saved.append((k, copies[len(saved)].copy_(held["iq"])))
        flight.mark()

    for _ in range(WARMUP_STEPS):
        one()
    # the two kept steps' samples, allocated before any window
    copies = [torch.empty_like(held["iq"]) for _ in range(2)]
    out: dict = {}
    rng = np.random.default_rng(ctx.seed)
    if ctx.trace:
        from .. import trace as tr
        tr.warm_profiler(one)
        common.sync(dev)
        check.acc.zero_()
        first, n = sent, ctx.mix["trace_steps"]
        keep.update(first + int(p) for p in rng.choice(n, 2, replace=False))
        ctx.start_window()
        with tr.profiled(dev) as h:
            for _ in range(n):
                one()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        graph = h["trace"]
        with tr.profiled(dev) as h2:
            for _ in range(ctx.mix["eager_steps"]):
                eager(tst, rst, pool[sent % S])
        ranges = {k: v / ctx.mix["eager_steps"]
                  for k, v in h2["trace"].range_us().items()}
        out["reading"] = {
            "kind": "txrx", "units": n, "ranges": ranges,
            "n_mux": ctx.mix["n_mux"], "n_packets": n_pk,
            "code_rate": ctx.config["mode"]["code_rate"]}
        out["trace"] = graph
    else:
        common.sync(dev)
        check.acc.zero_()
        first = sent
        keep.update(first + int(p) for p in
                    rng.choice(SAMPLE_SPAN, 2, replace=False))
        t0 = ctx.start_window()
        deadline = t0 + ctx.seconds
        while True:
            one()
            if time.perf_counter() >= deadline:
                break
        common.sync(dev)
        elapsed = time.perf_counter() - t0
        n = sent - first
        out["metrics"] = {
            "txrx_msps": n * ctx.mix["n_mux"] * n_samp / elapsed / 1e6}
        common.log(f"graph step: {n} steps in {elapsed:.3f} s")
        if dev.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    bad_steps, bad_packets, bad_rs = (int(x) for x in check.acc.cpu())
    if len(saved) < 2:        # a window shorter than the draws
        saved.append((sent - 1, held["iq"]))
    del step, held
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    err = max(tx_error(ctx.config, pool, k, iq) for k, iq in saved)
    out["checks"] = [
        common.Check("tx_err", err, ctx.config["checks"]["tx_err"]),
        common.Check("ts_bad_packets", bad_packets, 0),
        common.Check("rs_uncorrectable", bad_rs, 0)]
    out["attempted"] = n * ctx.mix["n_mux"]
    out["failed"] = bad_steps
    return out

