"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole), and its reference and arithmetic load
nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    code = """
import json, torch
from benchmark import common, run
from benchmark.drivers import graph_step
bench = run.spec()
for w in bench["workloads"]:
    run.driver(run.cell(bench, w["name"])[2])
for m in bench["per_layer"]:
    run.reader(m["name"])
import benchmark.control, benchmark.faults
cfg = json.load(open("benchmark/configs/uk_8k64qam23.json"))
cfg["mode"] = dict(transmission="2k", constellation="qpsk", code_rate="1/2",
                   guard="1/32", alpha=0, code_rate_lp="1/2")
mix = dict(json.load(open("benchmark/traffic/headend_8mux.json")),
           n_mux=1, frames=8)
res = graph_step.run(common.Context("t", cfg, mix, 7, 0.2, False,
                                    torch.device("cpu")))
assert all(c.ok for c in res["checks"])
print(run.forbidden_modules())
"""
    assert _run(code) == "[]"


def test_the_reference_loads_nothing_of_the_program():
    code = """
import sys
import benchmark.reference.tx, benchmark.trace, benchmark.roofline
print(sorted({m.split('.')[0] for m in sys.modules}
             & {'dvbt_tpu_torch', 'dvbt_tpu', 'jax', 'jaxlib', 'flax'}))
"""
    assert _run(code) == "[]"


def test_forbidden_names_compare_whole():
    code = """
import sys, types
from benchmark import run
sys.modules['dvbt_tpu_torch_x'] = types.ModuleType('dvbt_tpu_torch_x')
sys.modules['jaxfoo'] = types.ModuleType('jaxfoo')
a = run.forbidden_modules()
sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')
print(a, run.forbidden_modules())
"""
    assert _run(code) == "[] ['jax']"
