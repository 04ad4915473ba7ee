"""The control of a cell, and its planted faults, on the card.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...] \\
        [--seconds 5] [--fault <name> [<name> ...]]

``control`` (the default) is the cell's control: for the head-end cells
the plain reference transmitter in the program's place, computed in
bfloat16 (``ref_bf16``); for the receiver cells, whose numbers are exact
counts and limits the configuration states, the guarantee "every packet
delivered equals the packet sent" broken by one byte where the TS is
produced (``altered``).  Every fault and reading of ``benchmark/faults.py``
runs the whole cell, window and checks included, with it planted, through
the driver's own ``run``.  One JSON line per seed and fault on standard
output, with ``correct`` and every number compared (a run that raises,
such as a stream that never locks, is not correct).  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import common, faults, run

CONTROL = {"graph_step": "ref_bf16", "stream_feeder": "altered",
           "capture_passes": "altered"}


def read(ctx: common.Context, fault: str) -> dict:
    name = ctx.mix["driver"]
    if fault == "control":
        fault = CONTROL[name]
    with faults.planted(name, fault, ctx):
        res = run.driver(ctx.mix).run(ctx)
    return {"fault": fault, "correct": all(c.ok for c in res["checks"]),
            "checks": {c.name: c.value for c in res["checks"]},
            "limits": {c.name: c.limit for c in res["checks"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", nargs="+", default=["control"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        common.log("the control runs on a CUDA card")
        return 1
    _, config, mix = run.cell(run.spec(), args.workload)
    for fault in args.fault:
        for seed in args.seeds:
            ctx = common.Context(args.workload, config, mix, seed,
                                 args.seconds, False, torch.device("cuda", 0))
            out = dict(workload=args.workload, seed=seed)
            try:
                out.update(read(ctx, fault))
            except RuntimeError as e:     # such as a stream that never locks
                out.update(fault=fault, correct=False, raised=str(e))
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
