"""The port's hierarchical (two-stream) TX and RX against the JAX package,
on the CPU: the three 2K modes of tests/test_hierarchical.py (TX IQ
within the golden tolerance of the JAX transmitter's, both streams
byte-exact through the port's loopback, the same TS and metrics as the
JAX receiver), the frozen 2K alpha=2 snapshot, TPS signalling, HP
surviving where LP fails, and the carried state with its ``lp`` sub-dict
handed over mid-stream in both directions.  Inputs come from seeded
numpy."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.mode import DvbtMode
from dvbt_tpu.models import rx as j_rx
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.ops import reference_signals as t_ref
from dvbt_tpu_torch.utils import state as t_state
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
DELAY = 11
CPU = torch.device("cpu")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MODES = [
    DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4"),
    DvbtMode("2k", "64qam", "2/3", alpha=1, code_rate_lp="5/6"),
    DvbtMode("2k", "64qam", "1/2", alpha=4, code_rate_lp="7/8"),
]


def _mid(mode) -> str:
    return (f"{mode.transmission}-{mode.constellation}-a{mode.alpha}-"
            f"{mode.code_rate}-{mode.code_rate_lp}")


@functools.lru_cache(maxsize=None)
def _port_chain(mode, demap="hard"):
    tx, n_pk, _ = t_tx.make_transmitter(port_mode(mode), CPU)
    rx, _, _ = t_rx.make_receiver(port_mode(mode), CPU, demap=demap)
    return tx, rx, n_pk


def _packets(n_pk, n_blocks, seed):
    return (make_ts_packets(n_pk[0] * n_blocks, seed=seed),
            make_ts_packets(n_pk[1] * n_blocks, seed=seed + 1))


def _block(pks, n_pk, b):
    return tuple(torch.from_numpy(p[b * n:(b + 1) * n])[None]
                 for p, n in zip(pks, n_pk))


def _port_loopback(mode, n_blocks=3, seed=0, noise=None, demap="hard"):
    """(packets (hp, lp), TS (hp, lp), metrics per block, IQ per block)
    through the port's chain; noise(b, iq) -> iq impairs block b."""
    tx, rx, n_pk = _port_chain(mode, demap)
    pks = _packets(n_pk, n_blocks, seed)
    tst = t_tx.init_tx_state(port_mode(mode), 1, CPU)
    rst = t_rx.init_rx_state(port_mode(mode), 1, CPU)
    outs, ms, iqs = ([], []), [], []
    for b in range(n_blocks):
        tst, iq = tx(tst, _block(pks, n_pk, b))
        iqs.append(iq[0].numpy())
        if noise is not None:
            iq = noise(b, iq)
        rst, ts, m = rx(rst, iq)
        for o, t in zip(outs, ts):
            o.append(t[0].numpy())
        ms.append(m)
    return pks, tuple(np.concatenate(o) for o in outs), ms, iqs


@pytest.mark.parametrize("mode", MODES, ids=_mid)
def test_hierarchical_matches_jax_and_is_byte_exact(mode):
    """TX IQ within the golden tolerance of the JAX transmitter's over two
    carried blocks, both streams byte-exact through the port's loopback,
    and the JAX receiver decoding the same IQ to the same TS and RS
    counts."""
    pks, ts, ms, iqs = _port_loopback(mode, n_blocks=2)
    tx_j, n_pk, _ = j_tx.make_transmitter(mode)
    rx_j, _, _ = j_rx.make_receiver(mode, metrics="min")
    assert n_pk == _port_chain(mode)[2]
    tst, rst = j_tx.init_tx_state(mode), j_rx.init_rx_state(mode)
    for b in range(2):
        tst, iq = tx_j(tst, tuple(jnp.asarray(p[b * n:(b + 1) * n])
                                  for p, n in zip(pks, n_pk)))
        np.testing.assert_allclose(iqs[b], np.asarray(iq), rtol=0, atol=ATOL)
        rst, ts_j, m_j = rx_j(rst, jnp.asarray(iqs[b]))
        for s, (t_j, n) in enumerate(zip(ts_j, n_pk)):
            assert np.array_equal(ts[s][b * n:(b + 1) * n], np.asarray(t_j))
        for k in ("rs_uncorrectable", "lp_rs_uncorrectable",
                  "rs_corrected", "lp_rs_corrected"):
            assert np.array_equal(ms[b][k][0].numpy(), np.asarray(m_j[k])), k
    for p, t in zip(pks, ts):
        assert np.array_equal(t[DELAY:], p[:len(t) - DELAY])
    assert {"lp_rs_uncorrectable", "lp_rs_corrected"} <= set(ms[-1])


def test_transmitter_matches_golden():
    """The port's TX against the frozen JAX snapshot of 2K 16-QAM alpha=2,
    HP 3/4, LP 1/2, GI 1/8 (tests/test_golden.py)."""
    mode = port_mode(DvbtMode("2k", "16qam", "3/4", "1/8", alpha=2,
                              code_rate_lp="1/2"))
    want = np.load(os.path.join(GOLDEN_DIR, "tx_2k_16qam_a2_34.npz"))
    tx, n_pk, _ = t_tx.make_transmitter(mode, CPU)
    pk = (torch.from_numpy(make_ts_packets(n_pk[0], seed=7))[None],
          torch.from_numpy(make_ts_packets(n_pk[1], seed=8))[None])
    st = t_tx.init_tx_state(mode, 1, CPU)
    st, iq = tx(st, pk)
    _, iq2 = tx(st, pk)
    L = mode.symbol_len
    iq, iq2 = iq[0].numpy(), iq2[0].numpy()
    np.testing.assert_allclose(iq[:4 * L], want["iq_head"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(iq2[:2 * L], want["iq2_head"], rtol=0,
                               atol=ATOL)
    assert float(np.mean(np.abs(iq) ** 2)) == pytest.approx(
        float(want["power"]), rel=1e-3)


def test_hierarchical_tps_signalling():
    mode = MODES[0]
    _, _, ms, _ = _port_loopback(mode, n_blocks=2)
    frames = ms[1]["tps_frame"][0].numpy()
    for f, bits in zip(frames, ms[1]["tps_bits"][0].numpy()):
        want = t_ref.expected_tps_bits(port_mode(mode), int(f))
        assert np.array_equal(bits, want)


def test_hierarchical_hp_more_robust_than_lp():
    """At 14 dB the HP stream (alpha=4, rate 1/2) survives while LP (rate
    7/8, the inner points) fails."""
    mode = DvbtMode("2k", "64qam", "1/2", alpha=4, code_rate_lp="7/8")
    rng = np.random.default_rng(0)

    def noise(b, iq):
        p = float((iq.abs() ** 2).mean())
        sigma = np.sqrt(p / 10 ** 1.4 / 2)
        n = rng.standard_normal((2,) + tuple(iq.shape)).astype(np.float32)
        return iq + sigma * torch.complex(torch.from_numpy(n[0]),
                                          torch.from_numpy(n[1]))

    _, _, ms, _ = _port_loopback(mode, n_blocks=3, noise=noise)
    hp_bad = sum(int(m["rs_uncorrectable"][0, DELAY if i == 0 else 0:].sum())
                 for i, m in enumerate(ms))
    lp_bad = sum(int(m["lp_rs_uncorrectable"].sum()) for m in ms)
    assert hp_bad == 0
    assert lp_bad > 0


def test_hierarchical_soft_matches_jax():
    """The soft receiver on a hierarchical mode (the embedded alpha=2
    constellation) decodes the same noisy IQ to the same TS and RS counts
    as the JAX package's, both streams."""
    mode = MODES[0]
    tx_j, n_pk, _ = j_tx.make_transmitter(mode)
    rx_j, _, _ = j_rx.make_receiver(mode, demap="soft", metrics="min")
    rx_t = _port_chain(mode, "soft")[1]
    pks = _packets(n_pk, 1, 4)
    _, iq = tx_j(j_tx.init_tx_state(mode),
                 tuple(jnp.asarray(p) for p in pks))
    iq = np.asarray(iq)
    rng = np.random.default_rng(5)
    sigma = np.sqrt(np.mean(np.abs(iq) ** 2) / 10 ** 1.5 / 2)
    iq = (iq + sigma * (rng.standard_normal(iq.shape)
                        + 1j * rng.standard_normal(iq.shape))
          ).astype(np.complex64)
    _, ts_j, m_j = rx_j(j_rx.init_rx_state(mode), jnp.asarray(iq))
    _, ts_t, m_t = rx_t(t_rx.init_rx_state(port_mode(mode), 1, CPU),
                        torch.from_numpy(iq)[None])
    for a, b in zip(ts_t, ts_j):
        assert np.array_equal(a[0].numpy(), np.asarray(b))
    for k in ("rs_corrected", "lp_rs_corrected"):
        assert np.array_equal(m_t[k][0].numpy(), np.asarray(m_j[k])), k


def _stack(state):
    """An unbatched JAX state -> numpy leaves with a mux axis of 1."""
    return jax.tree.map(lambda x: np.asarray(x)[None], state)


def _unstack(state):
    return jax.tree.map(lambda x: jnp.asarray(x[0]), state)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_lp_state_handed_over_mid_stream(direction):
    """Two blocks run by one framework hand their TX and RX state (with the
    ``lp`` sub-dict) to the other, which runs the third: its TS and IQ
    equal those of the first framework running on."""
    mode = MODES[0]
    pmode = port_mode(mode)
    tx_j, n_pk, _ = j_tx.make_transmitter(mode)
    rx_j, _, _ = j_rx.make_receiver(mode, metrics="min")
    tx_t, rx_t, _ = _port_chain(mode)
    pks = _packets(n_pk, 3, 11)
    tst, rst = j_tx.init_tx_state(mode), j_rx.init_rx_state(mode)
    pst = t_tx.init_tx_state(pmode, 1, CPU)
    prs = t_rx.init_rx_state(pmode, 1, CPU)
    for b in range(2):
        if direction == "jax_to_port":
            tst, iq = tx_j(tst, tuple(jnp.asarray(p[b * n:(b + 1) * n])
                                      for p, n in zip(pks, n_pk)))
            rst, _, _ = rx_j(rst, iq)
        else:
            pst, iq = tx_t(pst, _block(pks, n_pk, b))
            prs, _, _ = rx_t(prs, iq)
    if direction == "jax_to_port":
        pst = t_state.tx_state_from_jax(_stack(tst), CPU)
        prs = t_state.rx_state_from_jax(_stack(rst), CPU)
        assert set(pst["lp"]) == {"dispersal_phase", "outer_tail",
                                  "coder_state"}
        assert set(prs["lp"]) == {"deint_tail", "viterbi", "descr_phase",
                                  "descr_locked"}
    else:
        tst = _unstack(t_state.to_jax(pst))
        rst = _unstack(t_state.to_jax(prs))
        # round trip: numpy leaves back into the port unchanged
        back = t_state.rx_state_from_jax(t_state.to_jax(prs), CPU)
        assert torch.equal(back["lp"]["viterbi"]["x"],
                           prs["lp"]["viterbi"]["x"])
    blk = tuple(jnp.asarray(p[2 * n:3 * n]) for p, n in zip(pks, n_pk))
    _, iq_j = tx_j(tst, blk)
    _, ts_j, _ = rx_j(rst, iq_j)
    _, iq_t = tx_t(pst, _block(pks, n_pk, 2))
    _, ts_t, _ = rx_t(prs, iq_t)
    np.testing.assert_allclose(iq_t[0].numpy(), np.asarray(iq_j), rtol=0,
                               atol=ATOL)
    for a, b in zip(ts_t, ts_j):
        assert np.array_equal(a[0].numpy(), np.asarray(b))
    # past the warm-up every packet of the handed-over block is the one sent
    for a, p, n in zip(ts_t, pks, n_pk):
        assert np.array_equal(a[0].numpy(), p[2 * n - DELAY:3 * n - DELAY])


def test_state_keys_are_checked():
    """A JAX state whose ``lp`` sub-dict misses a leaf is refused."""
    mode = MODES[0]
    st = _stack(j_tx.init_tx_state(mode))
    del st["lp"]["coder_state"]
    with pytest.raises(ValueError, match="state keys"):
        t_state.tx_state_from_jax(st, CPU)


@pytest.mark.slow
def test_hierarchical_8k_loopback_byte_exact():
    mode = DvbtMode("8k", "64qam", "2/3", alpha=2, code_rate_lp="3/4")
    pks, ts, _, _ = _port_loopback(mode, n_blocks=2)
    for p, t in zip(pks, ts):
        assert np.array_equal(t[DELAY:], p[:len(t) - DELAY])
