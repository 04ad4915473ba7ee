"""The program's stage telemetry in a traced run: one more window of the
cell's unit, after the driver's own, with a
``dvbt_tpu_torch.utils.telemetry.Recorder`` and the profiler off.  The
readers of the ``graph_*`` and ``host_ms.*`` metrics read its
``Recorder.summary()``.

- Head-end cells (driver ``graph_step``): the driver's step, on one
  stream or two, captured by ``GraphStep`` with the recorder, so that each
  stage's CUDA events are nodes of the graph; one replay to warm, then
  ``trace_steps`` replays over the seed's packet pool, each followed by a
  synchronize and ``collect()``.  The device time of each stage in the
  replayed graph, and the graph's time in no named stage
  (``graph_step``'s self time).
- The capture cell (driver ``capture_passes``): ``warm_passes`` passes,
  then ``trace_passes`` passes of the block path over the seed's captures
  with the recorder active, each followed by a synchronize and
  ``collect()``.  The host time a pass spends issuing the block path
  (``block_rx``), the device's queue empty at its start.

The window is neither checked nor counted, and runs after the driver has
returned: the traced run's other metrics, ``setup_s`` and the checks do not
see it.  A reader gets only the driver's reading, so the window takes the
cell and seed from the run's command line (``--workload``, ``--seed``,
``--trace 1``), runs once a run and keeps its summary in the reading under
``"telemetry"``.  It runs nothing, and the readers find nothing, where the
command line names no traced cell or the program has no telemetry (a
checkout older than it).  On a CPU device the head-end step runs eagerly
with the recorder active, as the driver's does, and no device time is
taken.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from . import common, run

KEY = "telemetry"


def stage_ms(r: dict, kind: str, name: str, field: str):
    """``field`` (``device_ms``, ``host_ms``, ``self_device_ms``, ...) of
    stage ``name`` in the window's summary, for a reading of ``kind``; None
    for another kind or where the window found nothing."""
    if r.get("kind") != kind:
        return None
    if KEY not in r:
        ctx = command_line_context()
        r[KEY] = None if ctx is None else window(ctx)
    row = (r[KEY] or {}).get(name)
    return None if row is None else row[field]


def command_line_context() -> common.Context | None:
    """The traced run's context from its command line, as
    ``benchmark.run`` makes it; None unless it names a cell, a seed and
    ``--trace 1``."""
    import torch
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False,
                                 exit_on_error=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trace", type=int)
    try:
        args, _ = ap.parse_known_args(sys.argv[1:])
    except argparse.ArgumentError:
        return None
    if args.workload is None or args.seed is None or args.trace != 1 \
            or not torch.cuda.is_available():
        return None
    _, config, mix = run.cell(run.spec(), args.workload)
    return common.Context(args.workload, config, mix, args.seed, 0.0, True,
                          torch.device("cuda", 0))


def window(ctx: common.Context) -> dict | None:
    """The recorder's summary of the cell's telemetry window."""
    try:
        from dvbt_tpu_torch.utils import telemetry
    except ImportError:            # a program without stage telemetry
        return None
    units = {"graph_step": _headend, "capture_passes": _capture}
    unit = units.get(ctx.mix["driver"])
    if unit is None:
        return None
    return unit(ctx, telemetry.Recorder(ctx.device))


def _headend(ctx, rec) -> dict:
    import torch

    from .drivers import graph_step

    dev = torch.device(ctx.device)
    eager, tst, rst, _, n_pk, _ = graph_step.compose(ctx)
    pool = graph_step.packet_pool(ctx, n_pk)
    if dev.type == "cuda":
        from dvbt_tpu_torch.bench import GraphStep
        step = GraphStep(eager, tst, rst, graph_step.static_packets(
            ctx.mix["n_mux"], n_pk, dev), telemetry=rec)
        recording = contextlib.nullcontext()
    else:
        step, recording = eager, rec
    for k in range(1 + ctx.mix["trace_steps"]):     # the first warms
        with recording if k else contextlib.nullcontext():
            tst, rst, _, _ = step(tst, rst, pool[k])
        common.sync(dev)
        if k:
            rec.collect()
    return rec.summary()


def _capture(ctx, rec) -> dict:
    import torch
    from dvbt_tpu_torch import DvbtMode
    from dvbt_tpu_torch.models import flowgraph

    from .drivers import capture_passes
    from .reference import tx as reference

    cfg, mix = ctx.config, ctx.mix
    dev = torch.device(ctx.device)
    rmode = reference.mode_from(cfg)
    n_cap = mix["capture_symbols"] * rmode.symbol_len
    caps = capture_passes.make_captures(ctx, rmode, n_cap)[0]
    mode = DvbtMode(**cfg["mode"])
    rx, _ = flowgraph.make_block_receiver(mode, dev, n_cap, mix["frames"])
    state0 = flowgraph.init_block_rx_state(mode, mix["n_mux"], dev)
    warm = mix["warm_passes"]
    for p in range(warm + mix["trace_passes"]):
        with rec if p >= warm else contextlib.nullcontext():
            rx(state0, caps[p % caps.shape[0]])
        common.sync(dev)
        rec.collect()
    return rec.summary()
