"""The port's streaming receiver (models/loopback.py) and the pilot-history
retimer against the JAX package, on the CPU, at 2K: the same raw streams
(delay, integer and fractional CFO, sample-clock offset, a mid-stream
dropout, a hierarchical mode) fed in the same ragged chunks through both
receivers give the same reports; the sample-clock loop holds lock at
+-40 ppm and loses it at 250 ppm untracked (tests/test_sco.py).  Streams
come from the JAX transmitter with seeded numpy packets."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io import ts as tsio
from dvbt_tpu.mode import MODE_2K_QPSK, DvbtMode
from dvbt_tpu.models import channel as j_channel
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu.models.loopback import StreamingReceiver as JaxReceiver
from dvbt_tpu.ops import reference_signals as j_ref
from dvbt_tpu_torch.models import channel as t_channel
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.models.loopback import StreamingReceiver
from dvbt_tpu_torch.ops import reference_signals as t_ref
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

CPU = torch.device("cpu")
DELAY = 11
BACKOFF = 8
# timing_tau is a float32 phase slope over the pilots: the two
# frameworks' FFTs and channel estimates round differently
TAU_TOL = 1e-3
HIER = DvbtMode("2k", "16qam", "2/3", "1/16", alpha=2, code_rate_lp="3/4")


@functools.lru_cache(maxsize=None)
def _tx_stream(mode, n_blocks, seed):
    """(packets, or the (hp, lp) pair, and the JAX transmitter's stream)."""
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    st = j_tx.init_tx_state(mode)
    if mode.hierarchical:
        pks = tuple(tsio.make_ts_packets(n * n_blocks, seed=seed + k)
                    for k, n in enumerate(n_pk))
    else:
        pks = (tsio.make_ts_packets(n_pk * n_blocks, seed=seed),)
        n_pk = (n_pk,)
    chunks = []
    for b in range(n_blocks):
        arg = tuple(jnp.asarray(p[b * n:(b + 1) * n])
                    for p, n in zip(pks, n_pk))
        st, iq = tx(st, arg if mode.hierarchical else arg[0])
        chunks.append(np.asarray(iq))
    return pks, np.concatenate(chunks)


def _impaired(mode, n_blocks, seed, delay, cfo, ppm=0.0):
    pks, stream = _tx_stream(mode, n_blocks, seed)
    stream = np.asarray(j_channel.apply_cfo(jnp.asarray(stream), cfo,
                                            mode.fft_len))
    if ppm:
        stream = j_channel.resample_ppm(stream, ppm)
    return pks, stream[delay:]


def _feed(srx, stream, first=100_000, chunk=77_777):
    """Ragged chunks, then the in-flight blocks."""
    reports, pos, n = [], 0, first
    while pos < len(stream):
        reports += srx.feed(stream[pos:pos + n])
        pos += n
        n = chunk
    return reports + srx.flush()


def _check_reports(got, want, uncorrectable_may_differ=False):
    """Report for report: offsets, lock flags, packets, RS counts and
    uncorrectable flags exact, timing within TAU_TOL and its step equal.
    With ``uncorrectable_may_differ``, the bytes and corrected counts of
    packets both receivers flag uncorrectable are not compared: they are
    the raw decisions on a corrupted signal, where the two frameworks'
    float rounding moves some across a decision boundary."""
    assert len(got) == len(want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.stream_offset == w.stream_offset, k
        assert g.reacquired == w.reacquired, k
        assert g.packets.shape == w.packets.shape, k
        assert np.array_equal(g.rs_uncorrectable,
                              np.asarray(w.rs_uncorrectable)), k
        ok = (~g.rs_uncorrectable if uncorrectable_may_differ
              else np.ones(len(g.packets), bool))
        assert np.array_equal(g.packets[ok], np.asarray(w.packets)[ok]), k
        assert np.array_equal(g.rs_corrected[ok],
                              np.asarray(w.rs_corrected)[ok]), k
        assert abs(g.timing_tau - w.timing_tau) <= TAU_TOL, k
        assert g.timing_adj == w.timing_adj, k
        if w.packets_lp is None:
            assert g.packets_lp is None and g.lp_rs_uncorrectable is None
        else:
            assert np.array_equal(g.packets_lp, np.asarray(w.packets_lp)), k
            assert np.array_equal(g.lp_rs_uncorrectable,
                                  np.asarray(w.lp_rs_uncorrectable)), k
    for key in ("cfo_int", "start", "frame_num"):
        assert int(got[0].info[key]) == int(want[0].info[key]), key


@pytest.mark.parametrize("adj", [-3, 0, 5])
def test_retimer_matches_jax(adj):
    mode = MODE_2K_QPSK
    rng = np.random.default_rng(4)
    n_sp = j_ref._frame_tables(mode)["sp_idx"].shape[1]
    tail = (rng.standard_normal((3, n_sp))
            + 1j * rng.standard_normal((3, n_sp))).astype(np.complex64)
    want = np.asarray(j_ref.make_chan_tail_retimer(mode)(
        jnp.asarray(tail), jnp.int32(adj)))
    got = t_ref.make_chan_tail_retimer(port_mode(mode), CPU)(
        torch.from_numpy(tail)[None], torch.tensor([adj]))
    assert got.dtype == torch.complex64 and got.shape == (1, 3, n_sp)
    if adj == 0:
        assert np.array_equal(got[0].numpy(), tail)
        assert np.array_equal(want, tail)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("pipeline", [0, 2, 4])
def test_streaming_receiver_matches_jax(pipeline):
    """Delay, 1.25 subcarriers of CFO (integer 1 + fractional 0.25) and a
    +40 ppm sample clock, so that the timing loop steps too."""
    mode = MODE_2K_QPSK
    _, stream = _impaired(mode, 8, 1, 3333, 1.25, ppm=40.0)
    want = _feed(JaxReceiver(mode, pipeline=pipeline), stream)
    got = _feed(StreamingReceiver(port_mode(mode), CPU, pipeline=pipeline),
                stream)
    _check_reports(got, want)
    assert want[0].reacquired and not any(r.reacquired for r in want[1:])
    assert int(want[0].info["cfo_int"]) == 1
    assert any(r.timing_adj for r in want), "the timing loop never stepped"


def test_dropout_forces_a_relock_like_jax():
    """Samples lost mid-stream (not a whole symbol): the locked receiver
    decodes garbage, loses lock, searches again and decodes byte-exact
    from the new lock on.  In the block the dropout corrupts, both flag
    the same 57 of 63 packets uncorrectable; the raw bytes of 15 of those
    and the corrected counts of 12 differ (measured), so that block's
    uncorrectable packets are compared by their flags only."""
    mode = MODE_2K_QPSK
    (pk,), stream = _impaired(mode, 10, 2, 1500, -0.4)
    cut = 4 * mode.samples_per_block + 12_345
    stream = np.concatenate([stream[:cut], stream[cut + 50_001:]])
    want = _feed(JaxReceiver(mode), stream)
    got = _feed(StreamingReceiver(port_mode(mode), CPU), stream)
    _check_reports(got, want, uncorrectable_may_differ=True)
    relocks = [k for k, r in enumerate(got) if r.reacquired]
    assert relocks[0] == 0 and len(relocks) >= 2, relocks
    # from the re-lock on, the TS is the packets sent
    k = relocks[-1]
    n_pk = mode.packets_per_block
    after = np.concatenate([r.packets for r in got[k:]])
    b0 = round((got[k].stream_offset + 1500 + 50_001 + BACKOFF)
               / mode.samples_per_block)
    want_pk = pk[b0 * n_pk:]
    n = min(len(after) - DELAY, len(want_pk))
    assert n > n_pk
    assert np.array_equal(after[DELAY:DELAY + n], want_pk[:n])


def test_hierarchical_stream_matches_jax():
    _, stream = _impaired(HIER, 4, 5, 999, 0.3)
    want = _feed(JaxReceiver(HIER), stream)
    got = _feed(StreamingReceiver(port_mode(HIER), CPU), stream)
    _check_reports(got, want)
    assert not any(r.lp_rs_uncorrectable[DELAY:].any() for r in got[:1])
    assert not any(r.lp_rs_uncorrectable.any() for r in got[1:])


# --- the sample-clock loop (tests/test_sco.py) -----------------------------
SCO_BLOCKS = 26


@functools.lru_cache(maxsize=None)
def _sco_stream(ppm):
    mode = port_mode(MODE_2K_QPSK)
    tx, n_pk, _ = t_tx.make_transmitter(mode, CPU)
    packets = tsio.make_ts_packets(n_pk * SCO_BLOCKS, seed=5)
    st = t_tx.init_tx_state(mode, 1, CPU)
    chunks = []
    for b in range(SCO_BLOCKS):
        st, iq = tx(st, torch.from_numpy(packets[b * n_pk:(b + 1) * n_pk])
                    [None])
        chunks.append(iq[0].numpy())
    return packets, n_pk, t_channel.resample_ppm(np.concatenate(chunks), ppm)


@pytest.mark.parametrize("ppm", [40.0, -40.0])
def test_sco_tracking_holds_lock(ppm):
    mode = port_mode(MODE_2K_QPSK)
    packets, n_pk, stream = _sco_stream(ppm)
    reports = StreamingReceiver(mode, CPU).feed(stream)
    assert len(reports) >= SCO_BLOCKS - 3
    assert not any(r.reacquired for r in reports[1:])
    assert sum(int(r.rs_uncorrectable.sum()) for r in reports[1:]) == 0
    # ppm > 0 stretches the stream: the loop consumes extra samples
    total_adj = sum(r.timing_adj for r in reports)
    drift = len(stream) * ppm * 1e-6
    assert total_adj * np.sign(ppm) > 0
    assert abs(total_adj - drift) < 0.25 * abs(drift) + 6, (total_adj, drift)
    out = np.concatenate([r.packets for r in reports])
    f = 1.0 + ppm * 1e-6
    k0 = int(round((reports[0].stream_offset / f + BACKOFF)
                   / mode.samples_per_block))
    want, got = packets[k0 * n_pk:], out[DELAY:]
    n = min(len(got), len(want))
    assert n > 10 * n_pk
    assert np.array_equal(got[:n], want[:n])


def test_sco_untracked_loses_lock():
    _, _, stream = _sco_stream(250.0)
    srx = StreamingReceiver(port_mode(MODE_2K_QPSK), CPU, sco_tracking=False)
    reports = srx.feed(stream)
    bad = sum(int(r.rs_uncorrectable.sum()) for r in reports[1:])
    reacq = sum(bool(r.reacquired) for r in reports[1:])
    assert bad > 0 or reacq > 0


def test_receiver_rejects_a_block_size_off_the_mode():
    """2K QPSK 3/4 packs whole packets into 2 frames only."""
    with pytest.raises(ValueError, match="multiple of 2 frames"):
        StreamingReceiver(port_mode(DvbtMode("2k", "qpsk", "3/4")), CPU,
                          n_frames=3)
