"""The block path in hierarchical modes, on the CPU at 2K.

Raw captures of a hierarchical stream made by the benchmark's plain
reference transmitter (``benchmark/reference/tx.py``, EN 300 744 in
float64), each with its own delay, carrier offset (about +-2 subcarriers)
and AWGN at 30 dB, through ``flowgraph.make_block_receiver``: both
streams' TS are the packets sent from the detected frame on, after the
outer interleaver's 11-packet delay, with no uncorrectable packet, and the
TPS bits are the reference's.  On the same aligned symbols at zero noise
each stream's TS and RS counters equal those of the port's symbol-aligned
receiver with the same chain (``make_receiver(demap="hard",
chan_est="freq")``), and a capture decoded with the state the previous one
left runs both streams on with no warm-up.  Two modes: 64-QAM alpha = 2 (HP 2/3 + LP 3/4, one
frame a block), and 16-QAM alpha = 4 (HP 1/2 + LP 3/4, two frames a block),
whose LP stream takes 2 of each cell's 4 bits.  With a recorder the LP
decoder's stages sit inside ``lp_decode``; a non-hierarchical pass has
none."""

import numpy as np
import pytest
import torch

from benchmark.reference import tx as reference
from dvbt_tpu_torch import MODE_2K_QPSK, DvbtMode
from dvbt_tpu_torch.models import flowgraph
from dvbt_tpu_torch.models import rx as rxm
from dvbt_tpu_torch.ops import sync as sync_ops
from dvbt_tpu_torch.ops.outer_interleaver import DELAY_PACKETS
from dvbt_tpu_torch.utils.telemetry import Recorder

torch.set_num_threads(1)

MODES = {
    "64qam-a2": {"transmission": "2k", "constellation": "64qam",
                 "code_rate": "2/3", "guard": "1/32", "alpha": 2,
                 "code_rate_lp": "3/4"},
    "16qam-a4": {"transmission": "2k", "constellation": "16qam",
                 "code_rate": "1/2", "guard": "1/32", "alpha": 4,
                 "code_rate_lp": "3/4"},
}
STREAM_FRAMES = 8
SNR_DB = 30.0
LP_STAGES = ("bit_inner_interleaver", "viterbi_decoder",
             "convolutional_deinterleaver", "reed_solomon_dec",
             "energy_descramble")


def _modes(name: str):
    args = MODES[name]
    return DvbtMode(**args), reference.mode_from({"mode": args})


def _stream(rmode, seed: int):
    """(HP, LP) packets (P, 188) of STREAM_FRAMES frames and the
    reference's complex128 baseband of them."""
    gen = torch.Generator().manual_seed(seed)
    packets = []
    for i in range(2):
        pk = torch.randint(0, 256, (1, round(rmode.packets_per_frame(i)
                                             * STREAM_FRAMES), 188),
                           generator=gen, dtype=torch.uint8)
        pk[..., 0] = 0x47
        packets.append(pk)
    return [p[0] for p in packets], reference.transmit(rmode,
                                                       tuple(packets))[0]


def _captures(mode, stream, imp, snr_db, n_frames, seed: int):
    """One capture a row of ``imp`` [(delay, cfo subcarriers, phase)],
    with AWGN at ``snr_db`` (None: noiseless)."""
    gen = torch.Generator().manual_seed(seed)
    n_cap = sync_ops.min_capture_samples(mode, n_frames)
    n = torch.arange(n_cap)
    caps = []
    for delay, cfo, phase in imp:
        c = stream[delay:delay + n_cap] * torch.exp(
            1j * (2 * np.pi * cfo * n / mode.fft_len + phase))
        if snr_db is not None:
            sigma = (c.abs().pow(2).mean() / 10 ** (snr_db / 10) / 2).sqrt()
            c = c + sigma * torch.complex(
                torch.randn(n_cap, generator=gen, dtype=torch.float64),
                torch.randn(n_cap, generator=gen, dtype=torch.float64))
        caps.append(c.to(torch.complex64))
    return torch.stack(caps)


def _block_rx(mode, caps, n_frames, rec=None):
    rx, n_pk = flowgraph.make_block_receiver(mode, "cpu", caps.shape[1],
                                             n_frames)
    state = flowgraph.init_block_rx_state(mode, caps.shape[0], "cpu")
    if rec is None:
        return (n_pk, *rx(state, caps))
    with rec:
        out = rx(state, caps)
    rec.collect()
    return (n_pk, *out)


@pytest.fixture(scope="module", params=sorted(MODES))
def received(request):
    """The block path over two noisy captures of a reference stream."""
    mode, rmode = _modes(request.param)
    packets, stream = _stream(rmode, seed=21)
    L = mode.symbol_len
    imp = [(41 * L + 1234, 2.3, 0.4), (9 * L + 517, -1.7, 2.9)]
    n_frames = mode.frames_per_block
    caps = _captures(mode, stream, imp, SNR_DB, n_frames, seed=22)
    n_pk, state, ts, info = _block_rx(mode, caps, n_frames)
    return {"mode": mode, "rmode": rmode, "packets": packets,
            "delays": [d for d, _, _ in imp], "n_frames": n_frames,
            "n_pk": n_pk, "state": state, "ts": ts, "info": info}


def _first_frame(r: dict, m: int) -> int:
    """The frame at which capture m's decoded block starts."""
    flen = r["rmode"].frame_len
    at = r["delays"][m] + int(r["info"]["start"][m])
    k0 = -(-at // flen)
    assert 0 <= k0 * flen - at <= r["rmode"].guard_len      # in the guard
    assert k0 % r["mode"].frames_per_block == 0
    return k0


def test_block_receiver_returns_pairs(received):
    mode, n_pk = received["mode"], received["n_pk"]
    n_frames = received["n_frames"]
    assert n_pk == tuple(mode.stream_packets_per_block(s) * n_frames
                         // mode.frames_per_block for s in ("hp", "lp"))
    ts, info, state = received["ts"], received["info"], received["state"]
    assert isinstance(ts, tuple) and len(ts) == 2
    for t, n, prefix in zip(ts, n_pk, ("", "lp_")):
        assert t.shape == (2, n, 188) and t.dtype == torch.uint8
        assert info[prefix + "rs_corrected"].shape == (2, n)
        assert info[prefix + "rs_uncorrectable"].shape == (2, n)
    assert set(state["lp"]) == set(state) - {"lp"}
    assert set(flowgraph.init_block_rx_state(mode, 2, "cpu")) == set(state)


def test_both_streams_are_the_packets_sent(received):
    d = DELAY_PACKETS
    for i, (t, sent) in enumerate(zip(received["ts"], received["packets"])):
        flags = received["info"][("rs_uncorrectable",
                                  "lp_rs_uncorrectable")[i]]
        n = received["n_pk"][i]
        per_block = n // (received["n_frames"]
                          // received["mode"].frames_per_block)
        for m in range(2):
            k0 = _first_frame(received, m)
            p0 = k0 // received["mode"].frames_per_block * per_block
            assert torch.equal(t[m, d:], sent[p0:p0 + n - d]), (i, m)
            assert not flags[m, d:].any(), (i, m)


def test_tps_bits_are_the_reference(received):
    tps = received["info"]["tps_bits"]
    assert tps.shape == (2, received["n_frames"], 68)
    for m in range(2):
        k0 = _first_frame(received, m)
        for f in range(received["n_frames"]):
            want = reference.tps_bits(received["rmode"], (k0 + f) % 4)
            np.testing.assert_array_equal(tps[m, f, 1:].numpy(), want[1:])


@pytest.mark.parametrize("name", sorted(MODES))
def test_matches_the_aligned_receiver_at_zero_noise(name):
    """Noiseless captures at their own delays, no carrier offset: the block
    path and ``make_receiver`` over the symbols the block path decodes
    give each stream the same TS and RS counters, byte for byte."""
    mode, rmode = _modes(name)
    _, stream = _stream(rmode, seed=23)
    L = mode.symbol_len
    delays = (23 * L + 301, 70 * L + 1900)
    n_frames = mode.frames_per_block
    caps = _captures(mode, stream, [(d, 0.0, 0.0) for d in delays], None,
                     n_frames, seed=0)
    n_pk, _, ts, info = _block_rx(mode, caps, n_frames)
    rx, n_pk_rx, n_samp = rxm.make_receiver(mode, "cpu", n_frames,
                                            demap="hard", chan_est="freq")
    assert n_pk_rx == n_pk
    at = [d + int(s) for d, s in zip(delays, info["start"])]
    iq = torch.stack([stream[a:a + n_samp] for a in at]).to(torch.complex64)
    _, ts_rx, met = rx(rxm.init_rx_state(mode, 2, "cpu"), iq)
    for prefix, t, t_rx in zip(("", "lp_"), ts, ts_rx):
        assert torch.equal(t, t_rx), prefix
        for k in ("rs_corrected", "rs_uncorrectable"):
            assert torch.equal(info[prefix + k], met[prefix + k]), prefix + k
        assert not info[prefix + "rs_uncorrectable"][:, DELAY_PACKETS:].any()


def test_state_carries_both_streams_across_captures():
    """Two noiseless captures a frame apart, the second decoded with the
    state the first left: both streams' TS run on with no warm-up, every
    packet the one sent and none uncorrectable; from the initial state the
    second capture's first 11 packets are the outer deinterleaver's
    warm-up."""
    mode, rmode = _modes("64qam-a2")
    packets, stream = _stream(rmode, seed=28)
    flen = rmode.frame_len
    d0 = 2 * flen - 3000
    caps = _captures(mode, stream, [(d0, 0.0, 0.0), (d0 + flen, 0.0, 0.0)],
                     None, 1, seed=0)
    rx, n_pk = flowgraph.make_block_receiver(mode, "cpu", caps.shape[1], 1)
    state0 = flowgraph.init_block_rx_state(mode, 1, "cpu")
    state, _, info = rx(state0, caps[:1])
    k0 = -(-(d0 + int(info["start"][0])) // flen)
    _, ts, info = rx(state, caps[1:])
    assert -(-(d0 + flen + int(info["start"][0])) // flen) == k0 + 1
    _, ts_fresh, _ = rx(state0, caps[1:])
    for i, (t, fresh, sent, n) in enumerate(zip(ts, ts_fresh, packets,
                                                n_pk)):
        p0 = (k0 + 1) * n - DELAY_PACKETS
        assert torch.equal(t[0], sent[p0:p0 + n]), i
        assert not torch.equal(fresh[0, :DELAY_PACKETS],
                               sent[p0:p0 + DELAY_PACKETS]), i
        flags = info[("rs_uncorrectable", "lp_rs_uncorrectable")[i]]
        assert not flags.any(), i


def test_lp_decode_holds_the_lp_stages():
    """A recorder's pass: ``lp_decode`` once, inside ``block_rx``, holding
    the LP decoder's stages, whose names therefore count twice a pass."""
    mode, rmode = _modes("64qam-a2")
    _, stream = _stream(rmode, seed=24)
    L = mode.symbol_len
    caps = _captures(mode, stream, [(5 * L + 77, 1.2, 0.0)], SNR_DB, 1,
                     seed=25)
    rec = Recorder("cpu")
    _block_rx(mode, caps, 1, rec)
    summary = rec.summary()
    assert summary["lp_decode"]["calls"] == 1
    names = [s.name for s in rec.spans]
    assert names.count("lp_decode") == 1
    lp = names.index("lp_decode")
    assert rec.spans[rec.spans[lp].parent].name == "block_rx"
    inside = [s.name for s in rec.spans if s.parent == lp]
    assert inside == list(LP_STAGES)
    for stage in LP_STAGES:
        assert names.count(stage) == 2, stage
    assert summary["lp_decode"]["host_ms"] > 0


def test_a_single_stream_pass_has_no_lp_decode():
    mode = MODE_2K_QPSK
    rmode = reference.mode_from({"mode": {
        "transmission": "2k", "constellation": "qpsk", "code_rate": "1/2",
        "guard": "1/32", "code_rate_lp": "1/2"}})
    gen = torch.Generator().manual_seed(26)
    pk = torch.randint(0, 256, (1, round(rmode.packets_per_frame())
                                * STREAM_FRAMES, 188), generator=gen,
                       dtype=torch.uint8)
    stream = reference.transmit(rmode, pk)[0]
    caps = _captures(mode, stream, [(7 * mode.symbol_len + 9, -0.6, 0.0)],
                     SNR_DB, 1, seed=27)
    rec = Recorder("cpu")
    n_pk, state, ts, info = _block_rx(mode, caps, 1, rec)
    assert isinstance(n_pk, int) and isinstance(ts, torch.Tensor)
    assert "lp" not in state and not any(k.startswith("lp_") for k in info)
    names = [s.name for s in rec.spans]
    assert "lp_decode" not in names
    assert names.count("viterbi_decoder") == 1
