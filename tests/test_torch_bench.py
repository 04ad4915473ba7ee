"""The port's flagship bench (dvbt_tpu_torch.bench) on the CPU, at 2K.

The bench runs on a CUDA card; here its step takes the kernels' plain
versions, and these tests hold its result line and its hard checks: the
line carries the keys of the JAX package's bench.py (read from its source,
never imported: importing it sets DVBT_* environment defaults that would
leak into the JAX tests of the same worker), less its TPU knob fields;
the parity gates hold; a corrupted kernel that the RS decoder would hide,
an uncorrectable packet and a wrong TS each make the bench raise; the
CUDA graph step refuses the CPU; and the module exits nonzero, printing no
line, without CUDA."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from dvbt_tpu_torch import MODE_2K_QPSK, bench
from dvbt_tpu_torch.kernels import coder as kcoder
from dvbt_tpu_torch.kernels import viterbi as kvit
from dvbt_tpu_torch.models import rx as rxm
from dvbt_tpu_torch.models import tx as txm
from dvbt_tpu_torch.ops import reed_solomon

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = ["1/2", "2/3", "3/4", "5/6", "7/8"]
# bench.py's fields that name TPU knobs; the port reports its own choices
TPU_KNOBS = {"fft_impl", "ilv_dtype", "viterbi_style", "fused_step",
             "tx_chunk"}
N_MUX = 2


def _jax_bench_keys() -> set:
    """The keys of bench.py's result line: the literal keys of ``result``
    in ``main`` and of the dict that ``hw_parity`` returns."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    keys = set()
    for node in ast.walk(funcs["main"]):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets] == ["result"]):
            keys |= {k.value for k in node.value.keys if k is not None}
    for node in ast.walk(funcs["hw_parity"]):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
    assert {"metric", "value", "coder_hw_parity"} <= keys
    return keys


def _run(**kw):
    args = dict(n_mux=N_MUX, n_frames=1, seconds=0.0, warmup=0, graph=False)
    return bench.run(MODE_2K_QPSK, "cpu", **{**args, **kw})


def test_line_has_the_jax_bench_keys():
    line = _run()
    want = _jax_bench_keys() - TPU_KNOBS
    assert want <= set(line), sorted(want - set(line))
    assert not TPU_KNOBS & set(line)
    n_samp = txm.make_transmitter(MODE_2K_QPSK, "cpu", 1)[2]
    assert line["metric"] == "tx_rx_loopback_throughput_2kqpsk12"
    assert line["block_samples"] == N_MUX * n_samp
    assert line["iters"] == 3 and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] * 7 / 64,
                                                abs=2e-3)
    assert line["rs_uncorrectable_last_block"] == 0
    assert line["coder_hw_parity"] is True
    assert line["viterbi_hw_parity"] is True
    assert line["cuda_graph"] is False and line["viterbi_body"] == 1024
    assert line["device"] == "cpu" and line["power_limit_w"] is None


@pytest.mark.parametrize("rate", RATES)
def test_hw_parity_holds_on_the_cpu(rate):
    assert bench.hw_parity("cpu", rate, n_bits=13440) == {
        "coder_hw_parity": True, "viterbi_hw_parity": True}


def _flip_first_bit(fn):
    def corrupted(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, tuple):
            state, coded = out
            return state, torch.cat([coded[..., :1] ^ 1, coded[..., 1:]], -1)
        return torch.cat([out[..., :1] ^ 1, out[..., 1:]], -1)
    return corrupted


@pytest.mark.parametrize("module,name,gate", [
    (kvit, "viterbi_punct_plain", "viterbi_hw_parity"),
    (kcoder, "byte_coder_plain", "coder_hw_parity"),
], ids=["decoder", "coder"])
def test_a_corrupted_kernel_fails_its_gate(monkeypatch, module, name, gate):
    """One wrong bit a block: the Viterbi decoder or the RS decoder repairs
    it in the loopback, so only the parity gate sees it."""
    monkeypatch.setattr(module, name, _flip_first_bit(getattr(module, name)))
    with pytest.raises(bench.BenchFailure, match=f"^{gate} is false$"):
        _run()


def test_an_uncorrectable_packet_fails_the_run(monkeypatch):
    make = reed_solomon.make_rs_decoder

    def make_marking(device):
        decode = make(device)

        def marking(cw):
            msg, corr, bad = decode(cw)
            bad = bad.clone()
            bad[0, 20] = True
            return msg, corr, bad
        return marking

    monkeypatch.setattr(reed_solomon, "make_rs_decoder", make_marking)
    with pytest.raises(bench.BenchFailure,
                       match="^rs_uncorrectable is 1 in the last step$"):
        _run(parity=False)


def test_a_wrong_ts_fails_the_run(monkeypatch):
    make = rxm.make_receiver

    def make_wrong(*args, **kw):
        rx, n_pk, n_samp = make(*args, **kw)

        def wrong(state, iq):
            state, ts, met = rx(state, iq)
            ts = ts.clone()
            ts[1, 30, 100] ^= 1
            return state, ts, met
        return wrong, n_pk, n_samp

    monkeypatch.setattr(rxm, "make_receiver", make_wrong)
    with pytest.raises(bench.BenchFailure, match=r"the TS of muxes \[1\]"):
        _run(parity=False)


def test_eager_step_leaves_its_inputs_alone():
    """The graph's warm-up runs the step on its static inputs."""
    step = bench.make_step(MODE_2K_QPSK, "cpu", N_MUX, 1, graph=False)
    tst = txm.init_tx_state(MODE_2K_QPSK, N_MUX, "cpu")
    rst = rxm.init_rx_state(MODE_2K_QPSK, N_MUX, "cpu")
    pk = torch.randint(0, 256, (N_MUX, step.n_packets, 188),
                       dtype=torch.uint8)
    before = [(n, t.clone()) for n, t in bench.state_leaves(tst, rst)]
    pk0 = pk.clone()
    new_t, new_r, _, _ = step(tst, rst, pk)
    assert torch.equal(pk, pk0)
    for (name, t0), (_, t) in zip(before, bench.state_leaves(tst, rst)):
        assert torch.equal(t, t0), name
    assert [n for n, _ in bench.state_leaves(new_t, new_r)] == \
        [n for n, _ in before]


def test_new_state_check_refuses_aliases_and_mismatches():
    a, b = torch.zeros(4), torch.zeros(3)
    static = [("tx.a", a), ("tx.b", b)]
    bench._check_new_state([("tx.a", torch.ones(4)), ("tx.b", b)], static)
    with pytest.raises(RuntimeError, match="aliases the static input tx.a"):
        bench._check_new_state([("tx.a", torch.ones(4)), ("tx.b", a[:3])],
                               static)
    with pytest.raises(RuntimeError, match="leaf for leaf"):
        bench._check_new_state([("tx.a", torch.ones(4)),
                                ("tx.b", torch.ones(3, dtype=torch.int32))],
                               static)


def test_graph_step_needs_cuda():
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        bench.make_step(MODE_2K_QPSK, "cpu", N_MUX, 1, graph=True)
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        _run(graph=True)


def test_module_without_cuda_exits_nonzero_and_prints_no_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "dvbt_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()
