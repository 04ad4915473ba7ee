"""The program's CUDA-graph step (dvbt_tpu_torch.bench) on the CPU, at 2K.

The graph is captured only on a CUDA card; here the eager step takes the
kernels' plain versions, and these tests hold what the capture rests on:
the eager step leaves its inputs alone (the graph's warm-up runs it on its
static inputs), the new-state check refuses aliases and mismatches, and
the graph step refuses the CPU."""

import pytest
import torch

from dvbt_tpu_torch import MODE_2K_QPSK, bench
from dvbt_tpu_torch.models import rx as rxm
from dvbt_tpu_torch.models import tx as txm

torch.set_num_threads(1)

N_MUX = 2


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
