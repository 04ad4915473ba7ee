"""The flagship step in a hierarchical mode, on the CPU at 2K.

2K, 64-QAM, alpha = 2, HP 2/3 + LP 3/4, GI 1/32, 2 muxes, 8 frames a step
(672 HP and 1,512 LP packets, whole energy-dispersal groups), seeded
packets.  ``bench.make_step(graph=False)`` takes and gives (HP, LP) pairs:
its samples are within 1e-3 of the benchmark's plain reference transmitter
(``benchmark/reference/tx.py``, EN 300 744 in float64), the TS of each
stream are the packets sent 11 packets earlier and neither stream has an
uncorrectable packet.  A planted fault fails that comparison: the HP and LP
bits swapped in the cell slots, or the alpha = 1 map under alpha = 2.  With
a recorder each call holds the stages that only a hierarchical step has
(``lp_code``, ``stream_mux``, ``lp_decode``) once and the decoders' stages
once a stream; a non-hierarchical step holds none of them.  The graph's
launch check expects each kernel once a stream."""

import collections
import dataclasses

import pytest
import torch

from benchmark.reference import tx as reference
from dvbt_tpu_torch import MODE_2K_QPSK, DvbtMode, bench, make_ts_packets
from dvbt_tpu_torch.models import rx as rxm
from dvbt_tpu_torch.models import tx as txm
from dvbt_tpu_torch.ops import bit_interleaver, mapper
from dvbt_tpu_torch.ops.outer_interleaver import DELAY_PACKETS
from dvbt_tpu_torch.utils.telemetry import Recorder

torch.set_num_threads(1)

MODE_ARGS = {"transmission": "2k", "constellation": "64qam",
             "code_rate": "2/3", "guard": "1/32", "alpha": 2,
             "code_rate_lp": "3/4"}
MODE = DvbtMode(**MODE_ARGS)
N_MUX, N_FRAMES = 2, 8
# the benchmark's limit on the samples' distance from the reference
TX_ERR = 1e-3
NEW_STAGES = {"lp_code", "stream_mux", "lp_decode"}


def _packet_sets(n_pk: tuple, n_sets: int, seed: int) -> list:
    """``n_sets`` (HP, LP) pairs of seeded packets, (N_MUX, n, 188) each."""
    streams = [torch.as_tensor(make_ts_packets(n_sets * N_MUX * n,
                                               seed=seed + i)
                               .reshape(n_sets, N_MUX, n, 188))
               for i, n in enumerate(n_pk)]
    return [tuple(s[k] for s in streams) for k in range(n_sets)]


def _holding_samples(held: list):
    """make_transmitter whose tx appends each call's samples to ``held``."""
    make = txm.make_transmitter

    def make_holding(*args, **kw):
        tx, n_pk, n_samp = make(*args, **kw)

        def holding(state, packets):
            state, iq = tx(state, packets)
            held.append(iq)
            return state, iq
        return holding, n_pk, n_samp
    return make_holding


def _steps(sets: list, monkeypatch, rec=None) -> list:
    """make_step(graph=False) over ``sets`` from the initial state:
    [(samples, ts pair, flags pair)] of each step."""
    held: list = []
    monkeypatch.setattr(txm, "make_transmitter", _holding_samples(held))
    step = bench.make_step(MODE, "cpu", N_MUX, N_FRAMES, graph=False,
                           telemetry=rec)
    tst = txm.init_tx_state(MODE, N_MUX, "cpu")
    rst = rxm.init_rx_state(MODE, N_MUX, "cpu")
    out = []
    for pk in sets:
        tst, rst, ts, bad = step(tst, rst, pk)
        if rec is not None:
            rec.collect()
        out.append((held[-1], ts, bad))
    return out


def _tx_err(sets: list, k: int, iq: torch.Tensor) -> float:
    """Largest distance of step k's samples from the reference's, over
    the reference's RMS: the reference transmits steps 0..k from its
    start."""
    packets = tuple(torch.cat([s[i] for s in sets[:k + 1]], dim=1)
                    for i in range(2))
    ref = reference.transmit(reference.mode_from({"mode": MODE_ARGS}),
                             packets)
    ref = ref[:, ref.shape[1] * k // (k + 1):]
    err = (iq.to(torch.complex128) - ref).abs().max()
    return float(err / ref.abs().pow(2).mean().sqrt())


def _ts_exact(prev: tuple, cur: tuple, ts: tuple) -> bool:
    d = DELAY_PACKETS
    return all(torch.equal(t[:, :d], p[:, -d:]) and
               torch.equal(t[:, d:], c[:, :-d])
               for p, c, t in zip(prev, cur, ts, strict=True))


@pytest.fixture(scope="module")
def two_steps():
    """Two steps of two packet sets with a recorder active."""
    n_pk = txm.make_transmitter(MODE, "cpu", N_FRAMES)[1]
    sets = _packet_sets(n_pk, 2, seed=41)
    rec = Recorder("cpu")
    with pytest.MonkeyPatch.context() as mp:
        out = _steps(sets, mp, rec)
    return sets, out, rec


def test_step_gives_pairs(two_steps):
    sets, out, _ = two_steps
    _, ts, bad = out[0]
    assert isinstance(ts, tuple) and isinstance(bad, tuple)
    assert [t.shape for t in ts] == [p.shape for p in sets[0]]
    assert [b.shape for b in bad] == [p.shape[:2] for p in sets[0]]
    assert all(b.dtype == torch.bool for b in bad)


@pytest.mark.parametrize("k", [0, 1])
def test_samples_match_the_reference(two_steps, k):
    sets, out, _ = two_steps
    assert _tx_err(sets, k, out[k][0]) <= TX_ERR


def test_ts_is_the_packets_sent_11_earlier(two_steps):
    sets, out, _ = two_steps
    _, ts, bad = out[1]
    assert _ts_exact(sets[0], sets[1], ts)
    assert not any(b.any() for b in bad)


def _swap_slots(make):
    """The bit interleaver fed each cell's HP and LP bits in swapped slots
    (LP's v - 2 bits first)."""
    def make_swapped(*args, **kw):
        ilv = make(*args, **kw)
        return lambda per_sym: ilv(torch.roll(per_sym, -2, dims=-1))
    return make_swapped


def _alpha1_map(make):
    def make_alpha1(mode, device):
        return make(dataclasses.replace(mode, alpha=1), device)
    return make_alpha1


@pytest.mark.parametrize("fault", ["swapped", "alpha1_map"])
def test_a_planted_fault_fails(fault, monkeypatch):
    n_pk = txm.make_transmitter(MODE, "cpu", N_FRAMES)[1]
    sets = _packet_sets(n_pk, 1, seed=43)
    if fault == "swapped":
        monkeypatch.setattr(bit_interleaver, "make_bit_interleaver",
                            _swap_slots(bit_interleaver.make_bit_interleaver))
    else:
        monkeypatch.setattr(mapper, "make_mapper",
                            _alpha1_map(mapper.make_mapper))
    (iq, ts, bad), = _steps(sets, monkeypatch)
    assert _tx_err(sets, 0, iq) > TX_ERR
    if fault == "swapped":     # each stream decodes the other's bits
        zero = tuple(torch.zeros_like(p) for p in sets[0])
        assert not _ts_exact(zero, sets[0], ts)


def test_spans_of_a_hierarchical_call(two_steps):
    _, _, rec = two_steps
    assert rec.calls == 2
    for call in range(rec.calls):
        names = collections.Counter(s.name for s in rec.spans
                                    if s.call == call)
        assert {n: names[n] for n in NEW_STAGES} == dict.fromkeys(
            NEW_STAGES, 1)
        assert names["viterbi_decode"] == 2 and names["rs_decode"] == 2
        assert names["rs_encode"] == 2 and names["inner_coder"] == 2
    # the LP stream's stages run inside its span, the HP stream's in none
    spans = rec.spans
    for name, lp in (("rs_encode", "lp_code"), ("viterbi_decode",
                                                 "lp_decode")):
        assert collections.Counter(
            None if s.parent is None else spans[s.parent].name
            for s in spans if s.name == name) == {None: 2, lp: 2}


def test_a_non_hierarchical_step_holds_no_new_span():
    rec = Recorder("cpu")
    step = bench.make_step(MODE_2K_QPSK, "cpu", N_MUX, 1, graph=False,
                           telemetry=rec)
    n_pk = step.n_packets
    pk = torch.as_tensor(make_ts_packets(N_MUX * n_pk, seed=47)
                         .reshape(N_MUX, n_pk, 188))
    step(txm.init_tx_state(MODE_2K_QPSK, N_MUX, "cpu"),
         rxm.init_rx_state(MODE_2K_QPSK, N_MUX, "cpu"), pk)
    rec.collect()
    names = collections.Counter(s.name for s in rec.spans)
    assert not NEW_STAGES & set(names)
    assert names["viterbi_decode"] == names["rs_decode"] == 1


def test_launch_expectation_is_per_stream():
    """Each coding kernel once a stream; the demap kernel once a step, one
    launch for one stream and one for the (HP, LP) pair."""
    one = torch.zeros(N_MUX, 8, 188, dtype=torch.uint8)
    assert bench.captured_launches(one) == bench.CAPTURED_LAUNCHES
    assert bench.CAPTURED_LAUNCHES == {"byte_coder": 1, "viterbi_punct": 1,
                                       "rs_decode": 1, "rs_encode": 1,
                                       "demap": 1}
    assert bench.captured_launches((one, one)) == {
        "byte_coder": 2, "viterbi_punct": 2, "rs_decode": 2, "rs_encode": 2,
        "demap": 1}
