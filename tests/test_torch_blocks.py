"""The port's block-level receive path against the JAX package on the CPU:
kernel K3's plain version (the viterbi_decoder block), the symbol
interleaver, the frequency-domain channel estimator, payload extractor,
frame adapter and TPS decoder, the receiver's metrics="full",
chan_est="freq" and equalize=False options, the block registry, and the
whole receive chain composed from each package's registry, from a raw
capture.  Inputs come from seeded numpy."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu import blocks as j_blocks
from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.kernels import viterbi_pallas as j_vp
from dvbt_tpu.mode import MODE_2K_QPSK, SYMBOLS_PER_FRAME, DvbtMode
from dvbt_tpu.models import channel
from dvbt_tpu.models import rx as j_rx
from dvbt_tpu.models import tx as j_tx
from dvbt_tpu.ops import inner_coder as j_ic
from dvbt_tpu.ops import reference_signals as j_ref
from dvbt_tpu.ops import symbol_interleaver as j_si
from dvbt_tpu.ops import sync as j_sync
from dvbt_tpu.ops import viterbi as j_vit
from dvbt_tpu.utils import bits as j_bits
from dvbt_tpu_torch import blocks as t_blocks
from dvbt_tpu_torch.kernels import viterbi as t_kvit
from dvbt_tpu_torch.models import flowgraph as t_flow
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.ops import reference_signals as t_ref
from dvbt_tpu_torch.ops import symbol_interleaver as t_si
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
DELAY_PACKETS = 11
MODE_2K_16QAM_34 = DvbtMode("2k", "16qam", "3/4")


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


# --- K3: the depunctured decoder -------------------------------------------


def _mother_blocks(rate, n_bits, n_blocks, flips, seed):
    """Depunctured soft streams (x, y, xm, ym) of consecutive blocks from
    one encoder, with `flips` hard errors in each of x and y (the cases of
    tests/test_viterbi_pallas.py)."""
    rng = np.random.default_rng(seed)
    coder = j_ic.make_inner_coder(n_bits, rate)
    depunct = j_ic.make_depuncture(n_bits, rate)
    st = j_ic.init_state()
    out = []
    for _ in range(n_blocks):
        st, coded = coder(st, jnp.asarray(rng.integers(0, 2, n_bits,
                                                       dtype=np.uint8)))
        x, y, xm, ym = depunct(coded * 15)
        x, y = np.array(x), np.array(y)
        for a in (x, y):
            if flips:
                pos = rng.choice(n_bits, flips, replace=False)
                a[pos] = 15 - a[pos]
        xm = np.broadcast_to(np.asarray(xm), x.shape).astype(np.uint8)
        ym = np.broadcast_to(np.asarray(ym), y.shape).astype(np.uint8)
        out.append((x, y, xm, ym))
    return out


@pytest.mark.parametrize("rate,n_bits,flips", [
    ("1/2", 4096, 0), ("2/3", 6144, 40), ("7/8", 7168, 10)])
def test_k3_plain_matches_pallas_and_jnp(rate, n_bits, flips):
    """Two blocks with the state carried, from an all-zero (erasure) start:
    bits and state equal the Pallas kernel (interpret mode) and the jnp
    decoder byte for byte.  A second mux, fed the inverted stream, rides
    along to check that muxes stay apart."""
    dec_j = j_vit.make_viterbi_decoder(n_bits, body=512, overlap=96)
    dec_p = j_vp.make_viterbi_decoder(n_bits, body=512, overlap=96,
                                      interpret=True)
    dec_t = t_kvit.make_viterbi_decoder(n_bits, body=512, overlap=96)
    sj, sp = j_vit.init_state(96), j_vp.init_state(96)
    st = t_kvit.init_state(2, "cpu", 96)
    for x, y, xm, ym in _mother_blocks(rate, n_bits, 2, flips, seed=1):
        args = tuple(jnp.asarray(a) for a in (x, y, xm, ym))
        sj, want_j = dec_j(sj, *args)
        sp, want_p = dec_p(sp, *args)
        both = [torch.from_numpy(np.stack([a, b])) for a, b in
                ((x, 15 - x), (y, 15 - y), (xm, xm), (ym, ym))]
        st, got = dec_t(st, *both)
        assert got.dtype == torch.uint8 and got.shape == (2, n_bits)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_j))
        for k in st:
            np.testing.assert_array_equal(st[k][0].numpy(),
                                          np.asarray(sp[k]))
            np.testing.assert_array_equal(st[k][0].numpy(),
                                          np.asarray(sj[k]))


@pytest.mark.parametrize("rate,n_bits", [("1/2", 4096), ("2/3", 6144),
                                         ("7/8", 7168)])
def test_k3_plain_matches_pallas_and_jnp_soft_input(rate, n_bits):
    """Graded soft values: x and y are the sent value 0/15 plus integer
    noise clipped to 0..15, also where the mask says the bit was not sent
    (the mask must silence it), so the branch metrics take every value
    from 0 to 30.  Two blocks with the state carried from an all-zero
    start: bits and state equal the Pallas kernel (interpret mode) and the
    jnp decoder byte for byte; a second mux with the inverted stream rides
    along."""
    rng = np.random.default_rng(7)
    coder = j_ic.make_inner_coder(n_bits, rate)
    depunct = j_ic.make_depuncture(n_bits, rate)
    dec_j = j_vit.make_viterbi_decoder(n_bits, body=512, overlap=96)
    dec_p = j_vp.make_viterbi_decoder(n_bits, body=512, overlap=96,
                                      interpret=True)
    dec_t = t_kvit.make_viterbi_decoder(n_bits, body=512, overlap=96)
    sj, sp = j_vit.init_state(96), j_vp.init_state(96)
    st = t_kvit.init_state(2, "cpu", 96)
    cst = j_ic.init_state()
    for _ in range(2):
        cst, coded = coder(cst, jnp.asarray(rng.integers(0, 2, n_bits,
                                                         dtype=np.uint8)))
        x, y, xm, ym = (np.array(np.broadcast_to(np.asarray(a), (n_bits,)),
                                 dtype=np.int32)
                        for a in depunct(coded * 15))
        x, y = (np.clip(a + rng.integers(-9, 10, n_bits), 0, 15).astype(
            np.uint8) for a in (x, y))
        xm, ym = xm.astype(np.uint8), ym.astype(np.uint8)
        args = tuple(jnp.asarray(a) for a in (x, y, xm, ym))
        sj, want_j = dec_j(sj, *args)
        sp, want_p = dec_p(sp, *args)
        both = [torch.from_numpy(np.stack([a, b])) for a, b in
                ((x, 15 - x), (y, 15 - y), (xm, xm), (ym, ym))]
        st, got = dec_t(st, *both)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_j))
        for k in st:
            np.testing.assert_array_equal(st[k][0].numpy(),
                                          np.asarray(sp[k]))
            np.testing.assert_array_equal(st[k][0].numpy(),
                                          np.asarray(sj[k]))


def test_k3_plain_decodes_noiseless_exactly():
    """Default geometry (auto_body, overlap 128) at 3/4: the decoded bits
    are the sent bits, as the Pallas decoder's."""
    rate, n_bits = "3/4", 6144
    bits = np.random.default_rng(2).integers(0, 2, n_bits, dtype=np.uint8)
    _, coded = j_ic.make_inner_coder(n_bits, rate)(j_ic.init_state(),
                                                   jnp.asarray(bits))
    x, y, xm, ym = j_ic.make_depuncture(n_bits, rate)(coded * 15)
    steps = [np.array(np.broadcast_to(np.asarray(a), (n_bits,)),
                      dtype=np.uint8) for a in (x, y, xm, ym)]
    _, got = t_kvit.make_viterbi_decoder(n_bits)(
        t_kvit.init_state(1, "cpu"), *(torch.from_numpy(a)[None]
                                       for a in steps))
    np.testing.assert_array_equal(got[0].numpy(), bits)
    _, want = j_vp.make_viterbi_decoder(n_bits, interpret=True)(
        j_vp.init_state(), *(jnp.asarray(a) for a in steps))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("n_bits", [100, 32_000, 102_816, 6_580_224])
def test_auto_body_matches_jax(n_bits):
    assert t_kvit.auto_body(n_bits) == j_vp.auto_body(n_bits)


def test_k3_wrapper_rejects_other_devices():
    z = torch.zeros(1, 64, dtype=torch.uint8, device="meta")
    tail = torch.zeros(1, 4, 8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_kvit.viterbi_depunct(z, z, z, z, tail, 32)


# --- the RX ops of the slice -----------------------------------------------


@pytest.mark.parametrize("deinterleave", [False, True])
@pytest.mark.parametrize("tx", ["2k", "8k"])
def test_symbol_interleaver_matches_jax(tx, deinterleave):
    mode = DvbtMode(tx, "qpsk", "1/2")
    rng = np.random.default_rng(3)
    cells = rng.integers(0, 64, (2, 68, mode.n_payload), dtype=np.int32)
    got = t_si.make_symbol_interleaver(port_mode(mode), "cpu", 68,
                                       deinterleave)(torch.from_numpy(cells))
    fn = j_si.make_symbol_interleaver(mode, 68, deinterleave)
    for m in range(2):
        np.testing.assert_array_equal(got[m].numpy(),
                                      np.asarray(fn(jnp.asarray(cells[m]))))
    back = t_si.make_symbol_interleaver(port_mode(mode), "cpu", 68,
                                        not deinterleave)(got)
    np.testing.assert_array_equal(back.numpy(), cells)


@functools.lru_cache(maxsize=None)
def _tx_carriers(mode):
    """Frame-aligned carriers (68, K) of the JAX transmitter, frame 0."""
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    _, iq = tx(j_tx.init_tx_state(mode),
               jnp.asarray(make_ts_packets(n_pk, seed=30)))
    iq = np.asarray(iq).reshape(68, mode.symbol_len)[:, mode.guard_len:]
    spec = np.fft.fft(iq, axis=-1, norm="ortho")
    k = np.arange(mode.n_carriers)
    return spec[:, (k - mode.kmax // 2) % mode.fft_len].astype(np.complex64)


@pytest.mark.parametrize("mode", [MODE_2K_QPSK, MODE_2K_16QAM_34],
                         ids=["2k_qpsk_12", "2k_16qam_34"])
def test_channel_estimator_payload_and_adapter_match_jax(mode):
    rng = np.random.default_rng(4)
    Y = _cplx(rng, (2, 68, mode.n_carriers))
    pm = port_mode(mode)
    H = t_ref.make_channel_estimator(pm, "cpu")(torch.from_numpy(Y))
    P = t_ref.make_payload_extractor(pm, "cpu")(torch.from_numpy(Y))
    data = _cplx(rng, (2, 68, mode.n_payload))
    fidx = np.array([1, 2], np.int32)
    A = t_ref.make_frame_adapter(pm, "cpu")(torch.from_numpy(fidx),
                                            torch.from_numpy(data))
    est_j = j_ref.make_channel_estimator(mode)
    ext_j = j_ref.make_payload_extractor(mode)
    ada_j = j_ref.make_frame_adapter(mode)
    for m in range(2):
        np.testing.assert_allclose(H[m].numpy(),
                                   np.asarray(est_j(jnp.asarray(Y[m]))),
                                   rtol=0, atol=ATOL)
        np.testing.assert_array_equal(P[m].numpy(),
                                      np.asarray(ext_j(jnp.asarray(Y[m]))))
        np.testing.assert_allclose(
            A[m].numpy(), np.asarray(ada_j(jnp.int32(fidx[m]),
                                           jnp.asarray(data[m]))),
            rtol=0, atol=ATOL)
    # on an ideal frame the estimate is the unit channel
    H1 = t_ref.make_channel_estimator(pm, "cpu")(
        torch.from_numpy(_tx_carriers(mode)))
    np.testing.assert_allclose(H1.numpy(), 1.0, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", [MODE_2K_QPSK, DvbtMode("8k", "64qam",
                                                         "2/3", "1/8")],
                         ids=["2k_qpsk_12", "8k_64qam_23"])
def test_tps_decoder_matches_jax(mode):
    """On a transmitted frame with noise at 10 dB: bits and frame number
    exact against the JAX decoder and against expected_tps_bits."""
    rng = np.random.default_rng(5)
    Y = _tx_carriers(mode)
    Y = np.stack([Y + 0.3 * _cplx(rng, Y.shape) for _ in range(2)])
    pm = port_mode(mode)
    bits, fnum = t_ref.make_tps_decoder(pm, "cpu")(torch.from_numpy(Y))
    dec_j = j_ref.make_tps_decoder(mode)
    want = t_ref.expected_tps_bits(pm, 0)
    np.testing.assert_array_equal(want, j_ref.expected_tps_bits(mode, 0))
    for m in range(2):
        bj, fj = dec_j(jnp.asarray(Y[m]))
        np.testing.assert_array_equal(bits[m].numpy(), np.asarray(bj))
        assert int(fnum[m]) == int(fj) == 0
        np.testing.assert_array_equal(bits[m].numpy(), want)
    assert bits.dtype == torch.uint8 and fnum.dtype == torch.int32


# --- the receiver's options ------------------------------------------------


@pytest.mark.parametrize("options", [
    {"metrics": "full", "chan_est": "freq"},
    {"metrics": "full", "chan_est": "time"},
    {"metrics": "min", "equalize": False},
], ids=["full_freq", "full_time", "min_noeq"])
def test_receiver_options_match_jax(options):
    """Two blocks of 2 muxes of 2K 16-QAM 3/4 at 25 dB (none at
    equalize=False, which takes a flat unit channel): TS, RS counters, TPS
    bits and frame numbers exact; mer_db within 1e-3 dB (float32 sums in
    another order); timing_tau within 1e-4 samples where it is reported."""
    mode = MODE_2K_16QAM_34
    rx_t, n_pk, n_samp = t_rx.make_receiver(port_mode(mode), "cpu",
                                            **options)
    rx_j, _, _ = j_rx.make_receiver(mode, **options)
    tx_j, _, _ = j_tx.make_transmitter(mode)
    rng = np.random.default_rng(6)
    sigma = 0.0 if options.get("equalize") is False else \
        np.sqrt(10 ** (-25 / 10) / 2)
    sent = make_ts_packets(n_pk * 4, seed=31).reshape(2, 2, n_pk, 188)
    st_t = t_rx.init_rx_state(port_mode(mode), 2, "cpu")
    st_j = [j_rx.init_rx_state(mode) for _ in range(2)]
    tx_st = [j_tx.init_tx_state(mode) for _ in range(2)]
    for blk in range(2):
        iq = []
        for m in range(2):
            tx_st[m], x = tx_j(tx_st[m], jnp.asarray(sent[blk, m]))
            iq.append(np.asarray(x) + sigma * _cplx(rng, (n_samp,)))
        iq = np.stack(iq).astype(np.complex64)
        st_t, ts, met = rx_t(st_t, torch.from_numpy(iq))
        assert ("timing_tau" in met) == options.get("equalize", True)
        assert ("mer_db" in met) == (options["metrics"] == "full")
        for m in range(2):
            st_j[m], ts_j, met_j = rx_j(st_j[m], jnp.asarray(iq[m]))
            np.testing.assert_array_equal(ts[m].numpy(), np.asarray(ts_j))
            assert set(met) == set(met_j)
            for k in ("rs_corrected", "rs_uncorrectable", "tps_bits",
                      "tps_frame"):
                if k in met:
                    np.testing.assert_array_equal(met[k][m].numpy(),
                                                  np.asarray(met_j[k]))
            if "mer_db" in met:
                assert abs(float(met["mer_db"][m])
                           - float(met_j["mer_db"])) <= 1e-3
                assert 20.0 < float(met["mer_db"][m]) < 30.0
            if "timing_tau" in met:
                np.testing.assert_allclose(met["timing_tau"][m].numpy(),
                                           np.asarray(met_j["timing_tau"]),
                                           rtol=0, atol=1e-4)
    if options["metrics"] == "full":
        for m in range(2):
            np.testing.assert_array_equal(
                met["tps_bits"][m, 0].numpy(),
                t_ref.expected_tps_bits(port_mode(mode), 1))


# --- the registry ----------------------------------------------------------


def test_registry_matches_jax():
    """Same block ids, references, ports, params and notes as the JAX
    registry (the decoders' notes name their CUDA kernels); params add
    ``device`` exactly where the factory takes it.
    The one contract that differs is the inner coder's: the port's takes
    the byte stream (the JAX package's coder_pallas kernel contract)."""
    import inspect
    jb = {b.name: b for b in j_blocks.BLOCKS}
    tb = t_blocks.BY_NAME
    assert [b.name for b in t_blocks.BLOCKS] == [b.name for b in
                                                 j_blocks.BLOCKS]
    assert t_blocks.ENUMS == j_blocks.ENUMS
    assert t_blocks.MODE_PARAMS == j_blocks.MODE_PARAMS
    for name, b in tb.items():
        j = jb[name]
        assert b.factory.startswith("dvbt_tpu_torch.")
        assert b.reference == j.reference, name
        fn = t_blocks.resolve(name)
        sig = inspect.signature(fn).parameters
        assert ("device" in b.params) == ("device" in sig), name
        params = tuple(p for p in b.params if p != "device")
        if name == "inner_coder":
            assert params == ("n_bytes", "code_rate")
            assert "byte stream" in b.inputs and "K2" in b.notes
            continue
        assert b.inputs == j.inputs and b.outputs == j.outputs, name
        assert params == j.params, name
        if name not in ("viterbi_decoder", "reed_solomon_dec"):
            assert b.notes == j.notes, name
    assert "CUDA kernel" in tb["reed_solomon_dec"].notes
    assert tb["viterbi_decoder"].factory == \
        "dvbt_tpu_torch.kernels.viterbi.make_viterbi_decoder"


def test_registry_yaml(tmp_path):
    t_blocks.main([str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"dvbt_{b.name}.yml" for b in t_blocks.BLOCKS)
    vit = (tmp_path / "dvbt_viterbi_decoder.yml").read_text()
    assert "factory: dvbt_tpu_torch.kernels.viterbi.make_viterbi_decoder" \
        in vit
    for b in t_blocks.BLOCKS:
        assert t_blocks.to_yaml(b) == j_blocks.to_yaml(
            j_blocks.Block(**dataclasses.asdict(b)))
    with pytest.raises(SystemExit):
        t_blocks.main([])


# --- the whole block chain from a raw capture ------------------------------


def _jax_block_chain(mode, cap, n_frames_out):
    """The same chain from the JAX registry's factories, one mux at a
    time; the Viterbi stage is the jnp depunctured decoder at the Pallas
    block's geometry, where the two decode alike."""
    jb = {b.name: b for b in j_blocks.BLOCKS}

    def make(name):
        module, _, attr = jb[name].factory.rpartition(".")
        return getattr(importlib.import_module(module), attr)

    n_sym = n_frames_out * SYMBOLS_PER_FRAME
    n_packets = mode.packets_per_block * n_frames_out \
        // mode.frames_per_block
    n_bytes = n_packets * 204
    n_bits = n_bytes * 8
    sync = make("synchronizer")(mode, cap, n_frames_out)
    demod = make("ofdm_demodulator")(mode, n_sym)
    estimate = make("demod_reference_signals")(mode)
    demap = make("dvbt_demap")(mode)
    sym_dilv = make("symbol_inner_interleaver")(mode, n_sym, True)
    from dvbt_tpu.ops import bit_interleaver, energy, outer_interleaver
    bit_dilv = bit_interleaver.make_bit_deinterleaver(mode, scale=15)
    depunct = j_ic.make_depuncture(n_bits, mode.code_rate)
    vit = j_vit.make_viterbi_decoder(n_bits, body=j_vp.auto_body(n_bits),
                                     overlap=j_vp.DEFAULT_OVERLAP)
    out_dilv = make("convolutional_deinterleaver")(n_bytes)
    rs_dec = make("reed_solomon_dec")()
    descramble = make("energy_descramble")(n_packets)
    tps_dec = j_ref.make_tps_decoder(mode)
    extract = j_ref.make_payload_extractor(mode)

    def rx(capture):
        aligned, info = sync(capture)
        Y = demod(aligned)
        X = Y / estimate(Y)
        tps_bits, _ = tps_dec(X)
        cells = sym_dilv(demap(extract(X)))
        x, y, xm, ym = depunct(bit_dilv(cells).reshape(-1))
        xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
        ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
        _, bits = vit(j_vit.init_state(j_vp.DEFAULT_OVERLAP), x, y, xm, ym)
        _, deint = out_dilv(outer_interleaver.init_state(),
                            j_bits.bits_to_bytes(bits))
        msg, corr, bad = rs_dec(deint.reshape(n_packets, 204))
        _, ts = descramble(energy.detect_dispersal_phase(msg), msg)
        return ts, corr, bad, tps_bits, info

    return rx


def test_block_chain_matches_jax_registry_chain():
    """2K QPSK 1/2, two muxes with their own delay and CFO (+2.3 and -1.6
    subcarriers) at 25 dB: sync estimates, TS, RS counters and TPS bits
    equal the JAX registry's chain, and the TS is the packets sent from the
    detected frame on, after the 11-packet delay."""
    mode = MODE_2K_QPSK
    L = mode.symbol_len
    tx, n_pk, _ = j_tx.make_transmitter(mode)
    sent = make_ts_packets(n_pk * 6, seed=32)
    st = j_tx.init_tx_state(mode)
    stream = []
    for b in range(6):
        st, iq = tx(st, jnp.asarray(sent[b * n_pk:(b + 1) * n_pk]))
        stream.append(np.asarray(iq))
    stream = np.concatenate(stream)
    cap = j_sync.min_capture_samples(mode, 1)
    imp = [(41 * L + 1234, 2.3, 3), (9 * L + 517, -1.6, 4)]
    caps = np.stack([np.asarray(channel.awgn(
        jax.random.PRNGKey(seed), channel.apply_cfo(
            jnp.asarray(stream[off:off + cap]), cfo, mode.fft_len), 25.0))
        for off, cfo, seed in imp])

    rx_t, n_packets = t_flow.make_block_receiver(port_mode(mode), "cpu",
                                                 cap, 1)
    state = t_flow.init_block_rx_state(port_mode(mode), 2, "cpu")
    _, ts, info = rx_t(state, torch.from_numpy(caps))
    rx_j = _jax_block_chain(mode, cap, 1)
    assert n_packets == n_pk
    for m, (off, cfo, _) in enumerate(imp):
        ts_j, corr_j, bad_j, tps_j, info_j = rx_j(jnp.asarray(caps[m]))
        for k in ("theta", "cfo_int", "frame_sym", "frame_num", "start"):
            assert int(info[k][m]) == int(info_j[k]), (k, m)
        np.testing.assert_array_equal(ts[m].numpy(), np.asarray(ts_j))
        np.testing.assert_array_equal(info["rs_corrected"][m].numpy(),
                                      np.asarray(corr_j))
        np.testing.assert_array_equal(info["rs_uncorrectable"][m].numpy(),
                                      np.asarray(bad_j))
        np.testing.assert_array_equal(info["tps_bits"][m, 0].numpy(),
                                      np.asarray(tps_j))
        # against what was sent
        abs_start = off + int(info["start"][m]) + 8
        assert abs_start % (SYMBOLS_PER_FRAME * L) == 0
        k0 = abs_start // (SYMBOLS_PER_FRAME * L)
        np.testing.assert_array_equal(
            ts[m, DELAY_PACKETS:].numpy(),
            sent[k0 * n_pk:(k0 + 1) * n_pk - DELAY_PACKETS])
        assert not info["rs_uncorrectable"][m, DELAY_PACKETS:].any()
        np.testing.assert_array_equal(
            info["tps_bits"][m, 0].numpy(),
            t_ref.expected_tps_bits(port_mode(mode), k0 % 4))
