"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell is found by name in
``BENCHMARK.json``; its configuration file under ``benchmark/configs/``
and its traffic mix under ``benchmark/traffic/`` name what to run, and the
mix's ``driver`` names the module of ``benchmark/drivers/`` that runs it.
With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<metric name>.py`` from the traced window.  Each
number compared for ``correct`` is printed beside its limit, last on
standard error and last in the result's line.

Exits nonzero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, or when a module of JAX or of the JAX
package has been loaded.  ``setup_build`` in the result's line says
whether the run built the program's libraries (a checkout's first run)
and in how many of the ``setup_s`` seconds.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import common  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dvbt_tpu")


def process_start() -> float:
    """Wall-clock time the process started (Linux), else this module's
    import."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        t = time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT
    return t if _T_IMPORT - 60 < t <= _T_IMPORT else _T_IMPORT


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) by name."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return w, config, mix


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"] if reports(m, workload)]


def per_layer(bench: dict, workload: str) -> list:
    moved = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if m["moves"] in moved and reports(m, workload)]


def reader(name: str):
    """``read(trace, reading) -> float | None`` of
    benchmark/metrics/<name>.py: ``trace`` is the traced window's
    ``benchmark.trace.Trace``, ``reading`` the driver's dict of the cell's
    kind, units in the window, shapes and device time a unit inside each
    profiler range."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver(mix: dict):
    return importlib.import_module(f"benchmark.drivers.{mix['driver']}")


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def build_libraries() -> dict:
    """The program's kernel and native libraries, built or found, first
    thing in set-up: ``built`` says whether this run built them (a
    checkout's first run does, with nvcc and g++) and ``seconds`` what
    that took, so that such a run's ``setup_s`` is recorded apart."""
    from dvbt_tpu_torch import native
    from dvbt_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    built = not (_build.library_path().exists()
                 and native.library_path().exists())
    _build.library()
    native.library()
    return {"built": built, "seconds": time.perf_counter() - t0}


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def assemble(bench: dict, ctx: common.Context, res: dict,
             setup_s: float, build: dict) -> dict:
    """The result line from a driver's result."""
    import torch
    checks = res["checks"]
    unit = {m["name"]: m["unit"] for m in
            bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if ctx.trace:
        for m in per_layer(bench, ctx.workload):
            value = reader(m["name"])(res["trace"], res["reading"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": unit[m["name"]]}
    else:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in end_to_end(bench, ctx.workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1,
              "memory_peak_bytes": int(res.get("memory_peak_bytes", 0))}
    line = {"correct": all(c.ok for c in checks),
            "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": metrics, "device": device}
    if ctx.trace:
        t = res["trace"]
        device["busy_s"] = t.busy_us() / 1e6
        device["window_s"] = t.wall_us / 1e6
        line["breakdown"] = {"device_ops": t.top_ops(),
                             "idle_gaps": t.idle_gaps()}
    line["power_limit_w"] = power_limit_w()
    line["setup_build"] = build
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec()
    w, config, mix = cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available():
        common.log("torch.cuda.is_available() is false: the benchmark runs "
                   "on a CUDA card")
        return 1
    if torch.cuda.device_count() < w["chips"]:
        common.log(f"{args.workload} needs {w['chips']} cards, "
                   f"{torch.cuda.device_count()} found")
        return 1
    ctx = common.Context(args.workload, config, mix, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0))
    build = build_libraries()
    common.log(f"set-up: the program's libraries "
               f"{'built' if build['built'] else 'found'} in "
               f"{build['seconds']:.3f} s")
    res = driver(mix).run(ctx)
    setup_s = ctx.window_start - (time.perf_counter() - time.time()
                                  + t_start)
    bad = forbidden_modules()
    if bad:
        common.log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    line = assemble(bench, ctx, res, setup_s, build)
    for name, c in line["checks"].items():
        common.log(f"check {name} {c['value']!r} limit {c['limit']!r} "
                   f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
