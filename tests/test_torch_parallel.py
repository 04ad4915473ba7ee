"""The port's parallel package on the CPU, with gloo ranks: each test
spawns its ranks (one process each, ``torch.set_num_threads(1)``), which
write their outputs into a temporary directory; the test process holds
them against the JAX package (its ``_shift_kernel`` in interpret mode on
the conftest's CPU mesh, its single-chip streaming chain, its mux-DP) and
against the port's own single-process chain.  On CPU tensors the halo ring takes its
plain send/recv version, so both ``halo`` values run here; K4 itself runs
only on the card (``chip_smoke.py``).

The rank functions live at module level, and JAX is imported inside the
tests only, so that a spawned rank imports this module without JAX."""

from pathlib import Path

import numpy as np
import pytest
import torch

from dvbt_tpu_torch import MODE_2K_QPSK, DvbtMode, make_ts_packets
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.parallel import multihost, ring, sharding
from dvbt_tpu_torch.parallel import time_sharding as t_tsh

torch.set_num_threads(1)

CPU = torch.device("cpu")
HIER = DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4")
D = 4
N_STEPS = 2
DEADLINE_S = 300.0


def _payloads() -> list[np.ndarray]:
    """The three payloads of tests/test_time_sharding.py."""
    rng = np.random.default_rng(0)
    return [
        rng.integers(0, 256, (12, 188)).astype(np.uint8),
        (rng.normal(size=(257,)) + 1j * rng.normal(size=(257,))).astype(
            np.complex64),
        rng.normal(size=(64, 8)).astype(np.float32),
    ]


def _plus(x: np.ndarray, i: int) -> np.ndarray:
    if x.dtype == np.uint8:
        return (x.astype(np.int32) + i).astype(np.uint8)
    return x + np.asarray(i, x.dtype)


def _launch(fn, n_ranks, *args):
    multihost.launch(fn, n_ranks, args=args, threads=1, timeout_s=120,
                     deadline_s=DEADLINE_S)


# --- rank functions ----------------------------------------------------------

def _ring_rank(rank, n_ranks, out_dir):
    for k, x in enumerate(_payloads()):
        shift = ring.make_ring_shift()
        got = shift(torch.as_tensor(_plus(x, rank)))
        np.save(Path(out_dir) / f"ring{k}_{rank}.npy", got.numpy())


def _loopback_rank(rank, n_ranks, out_dir, mode, packets):
    for halo in ("ppermute", "ring"):
        ts, bad = sharding.run_time_sharded(mode, CPU, packets, N_STEPS, halo)
        np.save(Path(out_dir) / f"{halo}_{rank}.npy", ts.numpy())
        np.save(Path(out_dir) / f"{halo}_bad_{rank}.npy", np.asarray(bad))


def _mux_rank(rank, n_ranks, out_dir, mode, packets):
    step, init_states, n_pk, B = multihost.make_multihost_loopback(
        mode, CPU, muxes_per_rank=2)
    assert B == 2 * n_ranks
    states = init_states()
    for s in range(N_STEPS):
        mine = torch.as_tensor(packets[s, 2 * rank:2 * rank + 2])
        states, ts, fleet = step(states, mine)
        np.save(Path(out_dir) / f"ts{s}_{rank}.npy", ts.numpy())
        np.save(Path(out_dir) / f"fleet{s}_{rank}.npy", np.asarray(
            [int(fleet["rs_corrected_total"]),
             int(fleet["rs_uncorrectable_total"])]))


def _dryrun_rank(rank, n_ranks):
    out = sharding.dryrun(MODE_2K_QPSK, n_ranks, muxes_per_rank=2, device=CPU)
    assert set(out) == {"mux_dp", "time_ppermute", "time_ring"}


def _failing_rank(rank, n_ranks):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")


# --- the plain ring shift == the JAX _shift_kernel ---------------------------

@pytest.fixture(scope="module")
def ring_outputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    _launch(_ring_rank, D, str(out))
    return out


@pytest.mark.parametrize("k", range(3), ids=["uint8", "complex64",
                                             "float32"])
def test_plain_ring_shift_matches_jax_shift_kernel(ring_outputs, k):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from dvbt_tpu.parallel import ring as j_ring

    x = _payloads()[k]
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("time",))
    shift = j_ring.make_ring_shift("time", interpret=True,
                                   collective_id=k + 1)
    full = jnp.asarray(np.concatenate([_plus(x, i) for i in range(D)]))
    want = np.asarray(jax.jit(jax.shard_map(
        shift, mesh=mesh, in_specs=P("time"), out_specs=P("time"),
        check_vma=False))(full)).reshape(D, *x.shape)
    for r in range(D):
        got = np.load(ring_outputs / f"ring{k}_{r}.npy")
        assert got.dtype == x.dtype and got.shape == x.shape
        assert np.array_equal(got.view(np.uint8), want[r].view(np.uint8)), r
        assert np.array_equal(got, _plus(x, (r - 1) % D)), r


# --- the time-sharded loopback == the JAX streaming chain --------------------

@pytest.fixture(scope="module")
def loopback_outputs(tmp_path_factory):
    mode = MODE_2K_QPSK
    n_pk = mode.packets_per_block
    packets = make_ts_packets(n_pk * D * N_STEPS, seed=5)
    out = tmp_path_factory.mktemp("loopback")
    _launch(_loopback_rank, D, str(out), mode, packets)
    return out, _jax_streaming(packets, D * N_STEPS)


def _jax_streaming(packets, n_blocks):
    import jax.numpy as jnp

    from dvbt_tpu.mode import MODE_2K_QPSK as J_MODE
    from dvbt_tpu.models import rx as j_rx
    from dvbt_tpu.models import tx as j_tx

    tx, n_pk, _ = j_tx.make_transmitter(J_MODE)
    rx, _, _ = j_rx.make_receiver(J_MODE)
    tst, rst = j_tx.init_tx_state(J_MODE), j_rx.init_rx_state(J_MODE)
    outs = []
    for b in range(n_blocks):
        tst, iq = tx(tst, jnp.asarray(packets[b * n_pk:(b + 1) * n_pk]))
        rst, ts, _ = rx(rst, iq)
        outs.append(np.asarray(ts))
    return np.concatenate(outs)


@pytest.mark.parametrize("halo", ["ppermute", "ring"])
def test_time_sharded_loopback_matches_jax_streaming(loopback_outputs, halo):
    out, ref = loopback_outputs
    # rank r holds block s*D + r of step s
    got = np.stack([np.load(out / f"{halo}_{r}.npy") for r in range(D)])
    got = got.transpose(1, 0, 2, 3).reshape(-1, 188)
    assert np.array_equal(got, ref)
    for r in range(D):
        bad = np.load(out / f"{halo}_bad_{r}.npy")
        assert bad[0] <= 11 and (bad[1:] == 0).all(), bad


# --- mux-DP == the JAX package's mux-DP and the port's single-process chain -

MUX_RANKS, MUX_B = 2, 4


@pytest.fixture(scope="module")
def mux_outputs(tmp_path_factory):
    """(packets (S, B, P, 188), TS (B, P, 188) per step with the ranks'
    muxes in order, each rank's fleet totals per step)."""
    n_pk = MODE_2K_QPSK.packets_per_block
    packets = np.stack([
        np.stack([make_ts_packets(n_pk, seed=100 * s + m)
                  for m in range(MUX_B)])
        for s in range(N_STEPS)])
    out = tmp_path_factory.mktemp("mux")
    _launch(_mux_rank, MUX_RANKS, str(out), MODE_2K_QPSK, packets)
    ts = [np.concatenate([np.load(out / f"ts{s}_{r}.npy")
                          for r in range(MUX_RANKS)]) for s in range(N_STEPS)]
    fleet = [[np.load(out / f"fleet{s}_{r}.npy") for r in range(MUX_RANKS)]
             for s in range(N_STEPS)]
    return packets, ts, fleet


def test_mux_dp_matches_single_process(mux_outputs):
    packets, got_ts, got_fleet = mux_outputs
    mode = MODE_2K_QPSK
    tx, _, _ = t_tx.make_transmitter(mode, CPU)
    rx, _, _ = t_rx.make_receiver(mode, CPU)
    fleet = np.zeros((N_STEPS, 2), np.int64)   # per step, summed over muxes
    for m in range(MUX_B):
        tst = t_tx.init_tx_state(mode, 1, CPU)
        rst = t_rx.init_rx_state(mode, 1, CPU)
        for s in range(N_STEPS):
            tst, iq = tx(tst, torch.as_tensor(packets[s, m:m + 1]))
            rst, ts, met = rx(rst, iq)
            assert np.array_equal(got_ts[s][m], ts[0].numpy()), (m, s)
            fleet[s] += [int(met["rs_corrected"].sum()),
                         int(met["rs_uncorrectable"].sum())]
    for s in range(N_STEPS):
        for r in range(MUX_RANKS):
            assert np.array_equal(got_fleet[s][r], fleet[s]), (s, r)


def test_mux_dp_matches_jax_sharded_loopback(mux_outputs):
    """The ranks' TS and fleet totals equal the JAX package's mux-DP
    (``make_sharded_loopback``) on a mesh of as many CPU devices as ranks,
    with as many muxes per device as per rank."""
    import jax
    import jax.numpy as jnp

    from dvbt_tpu.mode import MODE_2K_QPSK as J_MODE
    from dvbt_tpu.parallel import sharding as j_sharding

    packets, got_ts, got_fleet = mux_outputs
    mesh = j_sharding.make_mux_mesh(jax.devices()[:MUX_RANKS])
    step, init_states, _ = j_sharding.make_sharded_loopback(
        J_MODE, mesh, MUX_B // MUX_RANKS)
    states = init_states()
    for s in range(N_STEPS):
        states, ts, fleet = step(states, jnp.asarray(packets[s]))
        assert np.array_equal(got_ts[s], np.asarray(ts)), s
        want = [int(fleet["rs_corrected_total"]),
                int(fleet["rs_uncorrectable_total"])]
        for r in range(MUX_RANKS):
            assert got_fleet[s][r].tolist() == want, (s, r)


# --- the dryrun, bootstrap failures and options not ported -------------------

def test_dryrun_runs_its_three_stages_on_cpu():
    _launch(_dryrun_rank, D)


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        _launch(_failing_rank, 2)


@pytest.mark.parametrize("mode,demap,item", [
    (MODE_2K_QPSK, "bogus", "demap"),
    (HIER, "hard", "halo"),
], ids=["soft", "hierarchical"])
def test_unported_options_raise(mode, demap, item):
    """Option values the time-sharded path does not have raise ValueError:
    a demap other than hard or soft, a halo other than ring or
    ppermute."""
    halo = "bogus" if item == "halo" else "ring"
    with pytest.raises(ValueError, match=item):
        t_tsh.make_time_sharded_loopback(mode, CPU, halo=halo, demap=demap)
    if item == "demap":
        with pytest.raises(ValueError, match=item):
            t_tsh.make_rx_state_from_halo(mode, CPU, demap=demap)


# --- soft and hierarchical: the time-sharded loopback and mux-DP -------------

def _variant_rank(rank, n_ranks, out_dir, variants):
    for name, mode, demap, packets in variants:
        for halo in ("ppermute", "ring"):
            ts, bad = sharding.run_time_sharded(mode, CPU, packets, N_STEPS,
                                                halo, demap)
            for s, t in enumerate(ts if mode.hierarchical else (ts,)):
                np.save(Path(out_dir) / f"{name}_{halo}_{s}_{rank}.npy",
                        t.numpy())


def _variants():
    """(name, mode, demap, packets) of the soft and the hierarchical
    time-sharded runs."""
    out = [("soft", MODE_2K_QPSK, "soft",
            make_ts_packets(MODE_2K_QPSK.packets_per_block * D * N_STEPS,
                            seed=6))]
    n_hp, n_lp = (HIER.stream_packets_per_block(s) for s in ("hp", "lp"))
    out.append(("hier", HIER, "hard",
                (make_ts_packets(n_hp * D * N_STEPS, seed=7),
                 make_ts_packets(n_lp * D * N_STEPS, seed=8))))
    return out


@pytest.fixture(scope="module")
def variant_outputs(tmp_path_factory):
    """The ranks' output directory and, per variant, (name, mode, demap,
    packets, the JAX streaming TS, the port's streaming TS), each stream's
    TS a list entry."""
    out = tmp_path_factory.mktemp("variants")
    variants = _variants()
    _launch(_variant_rank, D, str(out), variants)
    n_blocks = D * N_STEPS
    refs = []
    for name, mode, demap, packets in variants:
        ref_t = sharding.streaming_reference(mode, CPU, packets, n_blocks,
                                             demap)
        refs.append((name, mode, demap, packets,
                     _jax_streaming_variant(mode, demap, packets, n_blocks),
                     list(ref_t) if mode.hierarchical else [ref_t]))
    return out, refs


def _jax_mode(mode):
    from dvbt_tpu.mode import DvbtMode as JMode
    return JMode(mode.transmission, mode.constellation, mode.code_rate,
                 mode.guard, mode.alpha, mode.code_rate_lp)


def _jax_streaming_variant(mode, demap, packets, n_blocks):
    """The JAX package's streaming chain: TS per stream."""
    import jax.numpy as jnp

    from dvbt_tpu.models import rx as j_rx
    from dvbt_tpu.models import tx as j_tx

    jm = _jax_mode(mode)
    tx, n_pk, _ = j_tx.make_transmitter(jm)
    rx, _, _ = j_rx.make_receiver(jm, demap=demap)
    hier = mode.hierarchical
    pks = packets if hier else (packets,)
    nps = n_pk if hier else (n_pk,)
    tst, rst = j_tx.init_tx_state(jm), j_rx.init_rx_state(jm)
    outs = [[] for _ in pks]
    for b in range(n_blocks):
        blk = tuple(jnp.asarray(p[b * n:(b + 1) * n])
                    for p, n in zip(pks, nps))
        tst, iq = tx(tst, blk if hier else blk[0])
        rst, ts, _ = rx(rst, iq)
        for o, t in zip(outs, ts if hier else (ts,)):
            o.append(np.asarray(t))
    return [np.concatenate(o) for o in outs]


@pytest.mark.parametrize("halo", ["ppermute", "ring"])
@pytest.mark.parametrize("k", range(2), ids=["soft", "hierarchical"])
def test_time_sharded_variants_match_streaming(variant_outputs, k, halo):
    """The soft and the two-stream time-sharded loopbacks (4 gloo ranks,
    2 steps, three halos a step in the two-stream one) equal the JAX
    package's streaming chain and the port's, each stream byte for
    byte."""
    out, refs = variant_outputs
    name, mode, demap, packets, ref_j, ref_t = refs[k]
    assert len(ref_j) == len(mode.streams)
    for s, (rj, rt) in enumerate(zip(ref_j, ref_t)):
        got = np.stack([np.load(out / f"{name}_{halo}_{s}_{r}.npy")
                        for r in range(D)])
        got = got.transpose(1, 0, 2, 3).reshape(-1, 188)
        assert np.array_equal(got, rj), s
        assert np.array_equal(got, rt), s


def _hier_mux_rank(rank, n_ranks, out_dir, packets):
    step, init_states, n_pk = sharding.make_sharded_loopback(
        HIER, CPU, muxes_per_rank=2)
    states = init_states()
    for s in range(N_STEPS):
        mine = tuple(torch.as_tensor(p[s, 2 * rank:2 * rank + 2])
                     for p in packets)
        states, ts, fleet = step(states, mine)
        for k, t in enumerate(ts):
            np.save(Path(out_dir) / f"ts{s}_{k}_{rank}.npy", t.numpy())
        np.save(Path(out_dir) / f"fleet{s}_{rank}.npy", np.asarray(
            [int(fleet[f"{p}_total"]) for p in (
                "rs_corrected", "rs_uncorrectable", "lp_rs_uncorrectable")]))


def test_hierarchical_mux_dp_matches_jax_sharded_loopback(tmp_path):
    """Mux-DP with (hp, lp) pairs over 2 gloo ranks x 2 muxes equals the
    JAX package's mux-DP on a 2-device CPU mesh: both streams' TS and the
    fleet totals, LP's included."""
    import jax
    import jax.numpy as jnp

    from dvbt_tpu.parallel import sharding as j_sharding

    n_pk = tuple(HIER.stream_packets_per_block(s) for s in ("hp", "lp"))
    packets = tuple(np.stack([
        np.stack([make_ts_packets(n, seed=100 * s + 10 * k + m)
                  for m in range(MUX_B)]) for s in range(N_STEPS)])
        for k, n in enumerate(n_pk))
    _launch(_hier_mux_rank, MUX_RANKS, str(tmp_path), packets)
    mesh = j_sharding.make_mux_mesh(jax.devices()[:MUX_RANKS])
    step, init_states, _ = j_sharding.make_sharded_loopback(
        _jax_mode(HIER), mesh, MUX_B // MUX_RANKS)
    states = init_states()
    for s in range(N_STEPS):
        states, ts, fleet = step(states, tuple(jnp.asarray(p[s])
                                               for p in packets))
        for k in range(2):
            got = np.concatenate([np.load(tmp_path / f"ts{s}_{k}_{r}.npy")
                                  for r in range(MUX_RANKS)])
            assert np.array_equal(got, np.asarray(ts[k])), (s, k)
        want = [int(fleet[f"{p}_total"]) for p in (
            "rs_corrected", "rs_uncorrectable", "lp_rs_uncorrectable")]
        for r in range(MUX_RANKS):
            assert np.load(tmp_path / f"fleet{s}_{r}.npy").tolist() == want
