"""The head-end step: TX then symbol-aligned RX of every mux, replayed as
the program's CUDA graph (``dvbt_tpu_torch.bench.GraphStep``).

Step k sends packet set k mod ``packet_sets`` of a pool made on the device
from the seed, distinct for every mux.  Every step's TS is compared on the
device with the packets sent 11 packets earlier, and its uncorrectable
count must be 0; the samples of two steps drawn from the seed are kept and,
once the window has closed, compared with the plain reference transmitter
(``benchmark/reference/tx.py``) run over the same packets.  A hierarchical
configuration carries two streams, HP and LP: its packets, TS and
uncorrectable flags are (HP, LP) pairs, each stream has a pool of its own
(HP drawn first) and each is checked against its own packets.

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


def streams(x) -> tuple:
    """``x`` as a tuple of per-stream values, HP first: a hierarchical
    mode's (HP, LP) pair itself, anything else as its one stream."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def join(xs: tuple):
    """The inverse of ``streams``: the form the program takes and gives."""
    return xs[0] if len(xs) == 1 else tuple(xs)


def compose(ctx):
    """The program's eager step over the configuration's mode and
    receiver: (eager, TX state, RX state, held, packets a step per
    stream, samples a step).  ``eager(tst, rst, packets) -> (tst', rst',
    ts, rs_uncorrectable)`` leaves its samples in ``held["iq"]``."""
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
    # the receiver's uncorrectable flags of each stream
    flags = ("rs_uncorrectable", "lp_rs_uncorrectable")[:len(streams(n_pk))]
    held: dict = {}

    def eager(tst, rst, packets):
        tst, iq = tx(tst, packets)
        rst, ts, met = rx(rst, iq)
        held["iq"] = iq
        return tst, rst, ts, join(tuple(met[f] for f in flags))

    tst = txm.init_tx_state(mode, n_mux, dev)
    rst = rxm.init_rx_state(mode, n_mux, dev)
    return eager, tst, rst, held, streams(n_pk), n_samp


class Pool:
    """Per stream, HP first, ``packet_sets`` sets (S, n_mux, n, 188) of
    packets drawn from the seed; ``pool[k]`` is what step k sends (set k
    mod S), in the form the program takes."""

    def __init__(self, sets: tuple):
        self.sets = sets

    def __len__(self) -> int:
        return self.sets[0].shape[0]

    def __getitem__(self, k: int):
        return join(tuple(p[k % len(self)] for p in self.sets))


def static_packets(n_mux: int, n_pk: tuple, device):
    """Zeroed packets of a step in the form the program takes: the CUDA
    graph's static input."""
    import torch
    return join(tuple(torch.zeros(n_mux, n, 188, dtype=torch.uint8,
                                  device=device) for n in n_pk))


class _Checker:
    """Per step, on the device: mux-steps with any wrong packet or RS
    failure on any stream, wrong packets, uncorrectable packets."""

    def __init__(self, pool: Pool):
        import torch
        d = common.DELAY_PACKETS
        S = len(pool)
        self.expected = tuple(torch.stack([torch.cat(
            [p[(s - 1) % S][:, -d:], p[s][:, :-d]], dim=1)
            for s in range(S)]) for p in pool.sets)
        self.acc = torch.zeros(3, dtype=torch.int64,
                               device=pool.sets[0].device)

    def __call__(self, k: int, ts, bad) -> None:
        with common.check_scope():
            for i, (exp, t, b) in enumerate(zip(
                    self.expected, streams(ts), streams(bad), strict=True)):
                wrong = (t != exp[k % len(exp)]).any(-1)
                mux = (wrong | b).any(-1)
                faulty = mux if i == 0 else faulty | mux
                self.acc[1] += wrong.sum()
                self.acc[2] += b.sum()
            self.acc[0] += faulty.sum()


def tx_error(cfg: dict, pool: Pool, k: int, iq) -> float:
    """Largest distance of a step's samples from the reference's, over the
    reference's RMS: the reference transmits sets k-1 and k from its start
    and the second half is step k (the step carries nothing older)."""
    import torch
    S = len(pool)
    packets = join(tuple(torch.cat([p[(k - 1) % S], p[k % S]], dim=1)
                         for p in pool.sets))
    ref = reference.transmit(reference.mode_from(cfg), packets)
    ref = ref[:, ref.shape[1] // 2:]
    err = (iq.to(torch.complex128) - ref).abs().max()
    return float(err / ref.abs().pow(2).mean().sqrt())


def packet_pool(ctx, n_pk: tuple) -> Pool:
    if ctx.mix["frames"] % 4 or any(n % 8 for n in n_pk):
        raise ValueError("a step must be whole superframes of whole energy-"
                         "dispersal groups: the reference restarts there")
    gen = common.generator(ctx.seed, ctx.device)
    return Pool(tuple(common.ts_packets(
        gen, (ctx.mix["packet_sets"], ctx.mix["n_mux"], n, 188), ctx.device)
        for n in n_pk))


def run(ctx) -> dict:
    import torch
    eager, tst, rst, held, n_pk, n_samp = compose(ctx)
    dev = torch.device(ctx.device)
    if dev.type == "cuda":
        from dvbt_tpu_torch.bench import GraphStep
        step = GraphStep(eager, tst, rst,
                         static_packets(ctx.mix["n_mux"], n_pk, dev))
    else:
        step = eager
    pool = packet_pool(ctx, n_pk)
    check = _Checker(pool)
    flight = common.InFlight(dev)
    sent = 0           # steps sent; step k sends set k mod S
    keep: set = set()
    saved = []

    def one():
        nonlocal tst, rst, sent
        k = sent
        tst, rst, ts, bad = step(tst, rst, pool[k])
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
        traced = h["trace"]
        with tr.profiled(dev) as h2:
            for _ in range(ctx.mix["eager_steps"]):
                eager(tst, rst, pool[sent])
        ranges = {k: v / ctx.mix["eager_steps"]
                  for k, v in h2["trace"].range_us().items()}
        mode = ctx.config["mode"]
        out["reading"] = {
            "kind": "txrx", "units": n, "ranges": ranges,
            "n_mux": ctx.mix["n_mux"]}
        if len(n_pk) == 1:
            out["reading"].update(n_packets=n_pk[0],
                                  code_rate=mode["code_rate"])
        else:
            out["reading"]["streams"] = [
                [n, rate] for n, rate in
                zip(n_pk, (mode["code_rate"], mode["code_rate_lp"]))]
        out["trace"] = traced
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

