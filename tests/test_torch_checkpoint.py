"""Checkpoint and resume of the port's streaming receiver
(utils/checkpoint.py, StreamingReceiver.save/restore) on the CPU, as
tests/test_checkpoint.py holds the JAX package's: a receiver saved
mid-stream and restored into a new one gives byte-identical output; a
state round-trips with its extras; and a file the port writes has the
keys the JAX package writes for the same receiver, with the same
values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import MODE_2K_QPSK
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu.models.loopback import StreamingReceiver as JaxReceiver
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models.loopback import StreamingReceiver
from dvbt_tpu_torch.utils import checkpoint as ckpt
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

CPU = torch.device("cpu")
MODE = MODE_2K_QPSK
N_BLOCKS = 6


def _stream():
    tx, n_pk, _ = j_tx.make_transmitter(MODE)
    packets = tsio.make_ts_packets(n_pk * N_BLOCKS, seed=2)
    st = j_tx.init_tx_state(MODE)
    chunks = []
    for b in range(N_BLOCKS):
        st, iq = tx(st, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
        chunks.append(np.asarray(iq))
    return np.concatenate(chunks)


STREAM = _stream()


@pytest.mark.parametrize("pipeline", [0, 2])
def test_streaming_receiver_checkpoint_resume(tmp_path, pipeline):
    mode = port_mode(MODE)
    half = len(STREAM) // 2
    ref = StreamingReceiver(mode, CPU, pipeline=pipeline)
    want = [r.packets for r in ref.feed(STREAM) + ref.flush()]

    a = StreamingReceiver(mode, CPU, pipeline=pipeline)
    got = [r.packets for r in a.feed(STREAM[:half])]
    path = str(tmp_path / "rx_ckpt.npz")
    a.save(path)                 # flushes a's in-flight blocks first
    got += [r.packets for r in a.flush()]
    del a
    b = StreamingReceiver(mode, CPU, pipeline=pipeline)
    b.restore(path)
    got += [r.packets for r in b.feed(STREAM[half:]) + b.flush()]
    assert len(got) == len(want) > 3
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_state_roundtrip(tmp_path):
    mode = port_mode(MODE)
    st = t_rx.init_rx_state(mode, 1, CPU)
    st["descr_phase"] = torch.tensor([5], dtype=torch.int32)
    st["chan_tail"] = torch.full_like(st["chan_tail"], 0.5 - 0.25j)
    p = str(tmp_path / "s.npz")
    ckpt.save_state(p, st, note=42)
    st2, extra = ckpt.load_state(p, t_rx.init_rx_state(mode, 1, CPU))
    assert int(st2["descr_phase"][0]) == 5
    assert int(extra["note"]) == 42
    flat, flat2 = ckpt.state_to_arrays(st), ckpt.state_to_arrays(st2)
    assert flat.keys() == flat2.keys()
    for k in flat:
        assert flat2[k].dtype == flat[k].dtype, k
        assert np.array_equal(flat2[k], flat[k]), k
    # a missing leaf and a wrong shape are refused
    with pytest.raises(KeyError, match="missing leaf 'lp/"):
        ckpt.load_state(p, dict(t_rx.init_rx_state(mode, 1, CPU),
                                lp={"deint_tail": st["deint_tail"]}))
    with pytest.raises(ValueError, match="leaf 'deint_tail'"):
        ckpt.load_state(p, t_rx.init_rx_state(mode, 2, CPU))


def test_file_keys_and_values_match_jax(tmp_path):
    """The same half stream through both receivers, each saved: the same
    keys.  The one difference, named: the port's state leaves and scalar
    extras carry its leading mux axis of 1, the JAX package's do not."""
    half = len(STREAM) // 2
    j = JaxReceiver(MODE)
    j.feed(STREAM[:half])
    j.save(str(tmp_path / "jax.npz"))
    t = StreamingReceiver(port_mode(MODE), CPU)
    t.feed(STREAM[:half])
    t.save(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as zj, \
            np.load(tmp_path / "port.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            w, g = zj[k], zt[k]
            if k in ("__extra__/buf", "__extra__/stream_pos",
                     "__extra__/locked"):
                assert g.shape == w.shape, k
            else:
                assert g.shape == (1,) + w.shape, k    # the mux axis
                g = g[0]
            assert g.dtype == w.dtype, k
            if np.issubdtype(w.dtype, np.inexact) and k != "__extra__/buf":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                           err_msg=k)
            else:
                assert np.array_equal(g, w), k
