"""The PyTorch port's RX modules and kernel K1 (plain version) against the
JAX package, on the CPU.  Inputs come from seeded numpy; bit and byte
stages must match exactly, float stages within the golden tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu import tables
from dvbt_tpu.kernels import viterbi_pallas as j_vp
from dvbt_tpu.mode import MODE_2K_QPSK, DvbtMode
from dvbt_tpu.ops import bit_interleaver as j_bil
from dvbt_tpu.ops import inner_coder as j_ic
from dvbt_tpu.ops import mapper as j_map
from dvbt_tpu.ops import ofdm as j_ofdm
from dvbt_tpu.ops import reed_solomon as j_rs
from dvbt_tpu.ops import reference_signals as j_ref
from dvbt_tpu.ops import viterbi as j_vit
from dvbt_tpu.utils import bits as j_bits
from dvbt_tpu_torch.kernels import viterbi as t_kvit
from dvbt_tpu_torch.models import rx as t_rx
from dvbt_tpu_torch.ops import bit_interleaver as t_bil
from dvbt_tpu_torch.ops import mapper as t_map
from dvbt_tpu_torch.ops import ofdm as t_ofdm
from dvbt_tpu_torch.ops import reed_solomon as t_rs
from dvbt_tpu_torch.ops import reference_signals as t_ref
from dvbt_tpu_torch.ops import viterbi as t_vit
from dvbt_tpu_torch.parallel import time_sharding as t_ts
from dvbt_tpu_torch.utils import puncture as t_punct
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
RATES = ["1/2", "2/3", "3/4", "5/6", "7/8"]
MODES = {
    "2k_qpsk_12": MODE_2K_QPSK,
    "2k_16qam_34": DvbtMode("2k", "16qam", "3/4"),
    "2k_64qam_23": DvbtMode("2k", "64qam", "2/3"),
}


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def test_ofdm_demodulator_matches_jax():
    mode = MODE_2K_QPSK
    rng = np.random.default_rng(0)
    iq = _cplx(rng, (2, 68 * mode.symbol_len))
    got = t_ofdm.make_ofdm_demodulator(port_mode(mode), "cpu")(
        torch.from_numpy(iq))
    dem_j = j_ofdm.make_ofdm_demodulator(mode, 68, fft_impl="jnp")
    for m in range(2):
        np.testing.assert_allclose(got[m].numpy(),
                                   np.asarray(dem_j(jnp.asarray(iq[m]))),
                                   rtol=0, atol=ATOL)


def test_time_channel_estimator_matches_jax():
    mode = MODE_2K_QPSK
    rng = np.random.default_rng(1)
    Y = _cplx(rng, (2, 136, mode.n_carriers))
    tail0, _ = t_ref.init_time_channel_state(port_mode(mode), 2, "cpu")
    tail = _cplx(rng, tuple(tail0.shape))
    valid = np.array([False, True])
    est = t_ref.make_time_channel_estimator(port_mode(mode), "cpu")
    new_tail, H = est(torch.from_numpy(tail), torch.from_numpy(valid),
                      torch.from_numpy(Y))
    est_j = j_ref.make_time_channel_estimator(mode)
    for m in range(2):
        tj, Hj = est_j(jnp.asarray(tail[m]), jnp.asarray(valid[m]),
                       jnp.asarray(Y[m]))
        np.testing.assert_allclose(H[m].numpy(), np.asarray(Hj), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(new_tail[m].numpy(), np.asarray(tj),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MODES))
def test_cell_and_bit_deinterleavers_match_jax(name):
    mode = MODES[name]
    rng = np.random.default_rng(2)
    cells = rng.integers(0, 2 ** mode.v, (2, 68, mode.n_carriers),
                         dtype=np.int32)
    payload = t_ref.make_cell_deinterleaver(port_mode(mode), "cpu")(
        torch.from_numpy(cells))
    want = np.asarray(j_ref.make_cell_deinterleaver(mode)(jnp.asarray(cells)))
    np.testing.assert_array_equal(payload.numpy(), want)
    bits = t_bil.make_bit_deinterleaver(port_mode(mode), "cpu",
                                        scale=15)(payload)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(j_bil.make_bit_deinterleaver(
            mode, scale=15)(jnp.asarray(want))))


def _exact_midpoints(scale: float, mids) -> np.ndarray:
    """float32 z with float32(z * scale) == mid exactly, per midpoint."""
    out = []
    for mid in mids:
        z = np.float32(mid / scale)
        for _ in range(8):
            if np.float32(z * np.float32(scale)) == np.float32(mid):
                break
            z = np.nextafter(z, np.float32(np.inf) if z * scale < mid
                             else np.float32(-np.inf))
        assert np.float32(z * np.float32(scale)) == np.float32(mid), mid
        out.append(z)
    return np.array(out, np.float32)


@pytest.mark.parametrize("name", sorted(MODES))
def test_hard_demapper_matches_jax_including_ties(name):
    """Decision-boundary midpoints resolve by round-half-to-even in both
    frameworks (torch.round and jnp.round), so ties agree bit for bit."""
    mode = MODES[name]
    rng = np.random.default_rng(3)
    y = _cplx(rng, (4000,)) * 0.8
    m = 1 << (mode.v // 2 - 1)
    if m > 1:
        c = mode.constellation_table()
        scale = (mode.alpha_eff + 2 * (m - 1)) / np.max(c.real)
        # |z| * scale on the midpoints between levels 1+2k and 3+2k
        mids = [2.0 + 2 * k for k in range(m - 1)]
        z = _exact_midpoints(float(np.float32(scale)), mids)
        ties = np.concatenate([z, -z])
        grid = (ties[:, None] + 1j * ties[None, :]).reshape(-1)
        y = np.concatenate([y, grid.astype(np.complex64)])
    got = t_map.make_demapper(port_mode(mode), "cpu")(torch.from_numpy(y))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_map.make_demapper(mode)(jnp.asarray(y))))


def _rs_errors(cw, rng, n_err, positions=None):
    """XOR n_err nonzero bytes into each codeword of cw (..., 204), at
    random positions or at random ones of ``positions``."""
    flat = cw.reshape(-1, 204)
    pool = np.arange(204) if positions is None else np.asarray(positions)
    for p, ne in enumerate(np.broadcast_to(n_err, flat.shape[:1])):
        pos = rng.choice(pool, ne, replace=False)
        flat[p, pos] ^= rng.integers(1, 256, ne, dtype=np.uint8)


# id -> (leading shape, byte errors a packet (scalar or one a packet),
# positions the errors may take (None: all 204), all-zero messages)
RS_CASES = {
    "mixed_0_1_8_9_12": ((2, 15), np.tile([0, 1, 8, 9, 12], 6), None, False),
    "errors_0": ((2, 6), 0, None, False),
    "errors_1": ((2, 6), 1, None, False),
    "errors_7": ((2, 6), 7, None, False),
    "errors_8": ((2, 6), 8, None, False),
    "errors_9": ((2, 6), 9, None, False),
    "errors_12": ((2, 6), 12, None, False),
    "errors_16": ((2, 6), 16, None, False),
    "parity_only_1_to_16": ((2, 8), np.arange(1, 17), range(188, 204), False),
    "positions_0_and_203": ((2, 6), 2, (0, 203), False),
    "all_zero_codeword": ((2, 6), 0, None, True),
    "one_packet": ((), 5, None, False),
    "mux_axis": ((3, 4, 5), np.tile([0, 3, 8, 10, 15], 12), None, False),
}


@pytest.fixture(scope="module")
def jax_rs_decoder():
    """One JAX decoder for every case: it compiles once a shape."""
    return j_rs.make_rs_decoder()


@pytest.mark.parametrize("case", list(RS_CASES))
def test_rs_decoder_matches_jax_with_errors(case, jax_rs_decoder):
    """Messages, corrected counts and uncorrectable flags all match the JAX
    decoder's, uncorrectable packets' bytes included; up to 8 errors the
    messages sent come back with the errors counted."""
    lead, n_err, positions, zero = RS_CASES[case]
    rng = np.random.default_rng(4)
    msg = (np.zeros(lead + (188,), np.uint8) if zero else
           rng.integers(0, 256, lead + (188,), dtype=np.uint8))
    cw = tables.rs_encode_ref(msg.reshape(-1, 188)).reshape(lead + (204,))
    _rs_errors(cw, rng, n_err, positions)
    got = t_rs.make_rs_decoder("cpu")(torch.from_numpy(cw))
    want = jax_rs_decoder(jnp.asarray(cw))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ne = np.broadcast_to(n_err, msg.reshape(-1, 188).shape[:1])
    ok = ne <= 8
    np.testing.assert_array_equal(got[0].numpy().reshape(-1, 188)[ok],
                                  msg.reshape(-1, 188)[ok])
    np.testing.assert_array_equal(got[1].numpy().reshape(-1)[ok], ne[ok])
    assert not got[2].numpy().reshape(-1)[ok].any()
    assert got[2].numpy().reshape(-1)[ne == 16].all()


def _encoded_blocks(rate, n_bits, n_blocks, flips, seed):
    """Coded soft streams (0/15) of consecutive blocks from one encoder,
    with `flips` hard errors per block."""
    rng = np.random.default_rng(seed)
    coder = j_ic.make_inner_coder(n_bits, rate)
    st = j_ic.init_state()
    out = []
    for _ in range(n_blocks):
        bits = rng.integers(0, 2, n_bits, dtype=np.uint8)
        st, coded = coder(st, jnp.asarray(bits))
        coded = np.asarray(coded, np.uint8) * 15
        pos = rng.choice(len(coded), flips, replace=False)
        coded[pos] = 15 - coded[pos]
        out.append(coded)
    return out


def _jnp_decode(dec, depunct, state, coded):
    x, y, xm, ym = depunct(jnp.asarray(coded))
    xm = jnp.broadcast_to(xm, x.shape).astype(jnp.uint8)
    ym = jnp.broadcast_to(ym, y.shape).astype(jnp.uint8)
    state, bits = dec(state, x, y, xm, ym)
    return state, np.asarray(j_bits.bits_to_bytes(bits))


@pytest.mark.parametrize("rate,flips", [("1/2", 60), ("2/3", 40),
                                        ("3/4", 24), ("5/6", 12), ("7/8", 8)])
def test_viterbi_plain_matches_pallas_and_jnp(rate, flips):
    """K1's plain version == the Pallas punctured decoder (interpret mode,
    style mxupack) == the jnp decoder on the depunctured stream, at equal
    geometry, on noisy input over two blocks: bytes and tail exact.  The
    carried tail comes from a preceding block, as mid-stream."""
    period = len(tables.PUNCTURE[rate][0])
    n_bits = 8 * period * 480
    body, ov = t_kvit.punct_geometry(rate, 512, 96)
    assert (body, ov) == j_vp.punct_geometry(n_bits, rate, 512, 96)
    blocks = _encoded_blocks(rate, n_bits, 3, flips, RATES.index(rate))
    depunct = j_ic.make_depuncture(n_bits, rate)
    dec_j = j_vit.make_viterbi_decoder(n_bits, body=body, overlap=ov)
    dec_p = j_vp.make_viterbi_decoder_punctured(
        n_bits, rate, body=512, overlap=96, interpret=True, style="mxupack")
    dec_t = t_vit.make_viterbi_decoder(n_bits, rate, body, ov)
    x, y, xm, ym = depunct(jnp.asarray(blocks[0]))
    sj = {"x": x[-ov:], "y": y[-ov:],
          "xm": jnp.broadcast_to(xm, x.shape)[-ov:].astype(jnp.uint8),
          "ym": jnp.broadcast_to(ym, y.shape)[-ov:].astype(jnp.uint8)}
    sp = dict(sj)
    st = {k: torch.from_numpy(np.array(v))[None] for k, v in sj.items()}
    for blk in blocks[1:]:
        st, got = dec_t(st, torch.from_numpy(blk)[None])
        sj, want_j = _jnp_decode(dec_j, depunct, sj, blk)
        sp, want_p = dec_p(sp, jnp.asarray(blk))
        np.testing.assert_array_equal(got[0].numpy(), want_j)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_p))
        for k in st:
            np.testing.assert_array_equal(st[k][0].numpy(), np.asarray(sj[k]))
            np.testing.assert_array_equal(st[k][0].numpy(), np.asarray(sp[k]))


def _soft_blocks(rate, n_bits, n_blocks, seed):
    """Coded graded soft streams of consecutive blocks from one encoder:
    the sent value 0/15 plus integer noise, clipped to 0..15."""
    rng = np.random.default_rng(seed)
    coder = j_ic.make_inner_coder(n_bits, rate)
    st = j_ic.init_state()
    out = []
    for _ in range(n_blocks):
        st, coded = coder(st, jnp.asarray(rng.integers(0, 2, n_bits,
                                                       dtype=np.uint8)))
        soft = np.asarray(coded, np.int32) * 15 + rng.integers(
            -9, 10, len(coded))
        out.append(np.clip(soft, 0, 15).astype(np.uint8))
    return out


@pytest.mark.parametrize("rate", ["1/2", "2/3", "7/8"])
def test_viterbi_plain_matches_pallas_and_jnp_soft_input(rate):
    """Graded soft values over the whole 0..15 range, so the branch metrics
    take every value from 0 to 30: K1's plain version == the Pallas
    punctured decoder (interpret mode) == the jnp decoder, bytes and tail
    exact over two blocks, the tail carried from a preceding block."""
    period = len(tables.PUNCTURE[rate][0])
    n_bits = 8 * period * 480
    body, ov = t_kvit.punct_geometry(rate, 512, 96)
    blocks = _soft_blocks(rate, n_bits, 3, 20 + RATES.index(rate))
    depunct = j_ic.make_depuncture(n_bits, rate)
    dec_j = j_vit.make_viterbi_decoder(n_bits, body=body, overlap=ov)
    dec_p = j_vp.make_viterbi_decoder_punctured(
        n_bits, rate, body=512, overlap=96, interpret=True, style="mxupack")
    dec_t = t_vit.make_viterbi_decoder(n_bits, rate, body, ov)
    x, y, xm, ym = depunct(jnp.asarray(blocks[0]))
    sj = {"x": x[-ov:], "y": y[-ov:],
          "xm": jnp.broadcast_to(xm, x.shape)[-ov:].astype(jnp.uint8),
          "ym": jnp.broadcast_to(ym, y.shape)[-ov:].astype(jnp.uint8)}
    sp = dict(sj)
    st = {k: torch.from_numpy(np.array(v))[None] for k, v in sj.items()}
    for blk in blocks[1:]:
        st, got = dec_t(st, torch.from_numpy(blk)[None])
        sj, want_j = _jnp_decode(dec_j, depunct, sj, blk)
        sp, want_p = dec_p(sp, jnp.asarray(blk))
        np.testing.assert_array_equal(got[0].numpy(), want_j)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_p))
        for k in st:
            np.testing.assert_array_equal(st[k][0].numpy(), np.asarray(sj[k]))
            np.testing.assert_array_equal(st[k][0].numpy(), np.asarray(sp[k]))


def _port_viterbi_shapes(transmission):
    """(n_bits, body, overlap) of every K1 and K3 decode the port runs in
    one transmission mode: the receiver (K1, body 1024, the effective
    overlap) and the viterbi_decoder block (K3, auto_body, overlap 128) at
    one block and at 4 frames, and the time-sharded halo recompute (K3,
    body 1024), each stream of the hierarchical modes too."""
    shapes = set()
    for const in ("qpsk", "16qam", "64qam"):
        for rate in RATES:
            mode = port_mode(DvbtMode(transmission, const, rate))
            for n_bits in {mode.packets_per_block * k * 204 * 8
                           for k in (1, 4 // mode.frames_per_block or 1)}:
                shapes.add((n_bits, t_vit.DEFAULT_BODY,
                            t_vit.effective_overlap(rate)))
                shapes.add((n_bits, t_kvit.auto_body(n_bits),
                            t_kvit.DEFAULT_OVERLAP))
            n_info = ((t_ts.rx_halo_symbols(mode) - t_ts.CHAN_WARMUP)
                      * int(mode.stream_info_bits_per_symbol("hp")))
            shapes.add((n_info, min(1024, n_info),
                        t_vit.effective_overlap(rate)))
    # hierarchical modes: K1 on each stream's block at its rate, K3 on each
    # stream's halo (an LP halo need not hold whole bytes)
    for const in ("16qam", "64qam"):
        for alpha in (1, 2, 4):
            for rate in RATES:
                for rate_lp in RATES:
                    mode = port_mode(DvbtMode(transmission, const, rate,
                                              alpha=alpha,
                                              code_rate_lp=rate_lp))
                    hd = t_ts.rx_halo_symbols(mode) - t_ts.CHAN_WARMUP
                    for s_, r in (("hp", rate), ("lp", rate_lp)):
                        n_bits = mode.stream_packets_per_block(s_) * 204 * 8
                        shapes.add((n_bits, t_vit.DEFAULT_BODY,
                                    t_vit.effective_overlap(r)))
                        n_info = hd * int(mode.stream_info_bits_per_symbol(
                            s_))
                        shapes.add((n_info, min(1024, n_info),
                                    t_vit.effective_overlap(r)))
    return sorted(shapes)


@pytest.mark.parametrize("transmission", ["2k", "8k"])
def test_viterbi_window_geometry_fits_and_covers(transmission):
    """Every launch of K1 and K3 the port makes fits the H100's shared
    memory (227 KB a block, 228 KB an SM), holds each window's decisions
    (or its 32-step ring when they spill to device memory) and body bits,
    counts on no more resident warps than the kernels' registers allow,
    and its grid covers every window exactly once."""
    for n_bits, body, ov in _port_viterbi_shapes(transmission):
        for n_mux in (1, 8):
            g = t_kvit.window_geometry(n_mux, n_bits, body, ov)
            n_win = -(-n_bits // body)
            assert g.n_win == n_win
            # the traceback reads steps ov + 6 .. L-1
            assert g.skip % 32 == 0 and 0 <= g.skip <= ov + 6
            steps = body + 2 * ov - g.skip
            assert g.resident >= t_kvit.SPILL_BELOW
            assert g.resident == g.blocks_per_sm * g.warps
            assert g.resident <= t_kvit.REG_WARPS_PER_SM[g.spill]
            assert g.scratch_bytes(n_mux, body, ov) == (
                8 * n_mux * n_win * steps if g.spill else 0)
            assert g.window_bytes % 128 == 8   # lanes of the traceback
            assert g.window_bytes >= (8 * (32 if g.spill else steps)
                                      + 4 * -(-body // 32))
            per_block = g.warps * g.window_bytes + t_kvit.SMEM_STATIC
            assert per_block <= t_kvit.SMEM_PER_BLOCK
            assert (g.blocks_per_sm
                    * (per_block + t_kvit.SMEM_BLOCK_RESERVED)
                    <= t_kvit.SMEM_PER_SM)
            assert 1 <= g.warps <= t_kvit.MAX_WARPS_PER_BLOCK
            # warp k of block b decodes window b * warps + k, if it exists
            ids = np.arange(g.grid * g.warps)
            np.testing.assert_array_equal(ids[ids < n_mux * n_win],
                                          np.arange(n_mux * n_win))
            assert (g.grid - 1) * g.warps < n_mux * n_win


def test_viterbi_window_geometry_spills_oversized_windows():
    """A window whose decisions leave fewer than SPILL_BELOW windows an SM
    spills them to device memory and runs as many windows as the spilled
    kernel's registers allow; one whose body bits alone do not fit is
    refused."""
    g = t_kvit.window_geometry(1, 10 ** 6, 30_000, 128)
    assert g.spill
    assert g.warps * g.window_bytes <= t_kvit.SMEM_PER_BLOCK
    assert g.resident == t_kvit.REG_WARPS_PER_SM[True]
    # K3 at the 8K block shape: 6 windows an SM resident, 40 spilled
    g = t_kvit.window_geometry(8, 6_580_224, 4096, 128)
    assert g.spill and g.resident == 40 and g.blocks_per_sm == 5
    with pytest.raises(ValueError, match="shared bytes"):
        t_kvit.window_geometry(1, 10 ** 7, 2_000_000, 128)
    with pytest.raises(ValueError, match="overlap >= 5"):
        t_kvit.window_geometry(1, 1000, 100, 4)


@pytest.mark.parametrize("rate", ["2/3", "7/8"])
def test_viterbi_default_geometry_matches_jnp_from_stream_start(rate):
    """The receiver's default (body 1024, effective overlap, zero tail at
    stream start) reproduces the JAX receiver's CPU decoder under noise."""
    period = len(tables.PUNCTURE[rate][0])
    n_bits = 8 * period * 600
    ov = t_vit.effective_overlap(rate)
    blocks = _encoded_blocks(rate, n_bits, 2, 30, 11)
    depunct = j_ic.make_depuncture(n_bits, rate)
    dec_j = j_vit.make_viterbi_decoder(n_bits, overlap=ov)
    dec_t = t_vit.make_viterbi_decoder(n_bits, rate)
    sj = j_vit.init_state(ov)
    st = t_vit.init_state(2, ov, "cpu")
    for blk in blocks:
        both = np.stack([blk, 15 - blk])     # a second, inverted mux
        st, got = dec_t(st, torch.from_numpy(both))
        sj, want = _jnp_decode(dec_j, depunct, sj, blk)
        np.testing.assert_array_equal(got[0].numpy(), want)
        for k in st:
            np.testing.assert_array_equal(st[k][0].numpy(), np.asarray(sj[k]))


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("body,overlap", [(512, 96), (1000, 128), (4096, 7)])
def test_punct_geometry_matches_jax(rate, body, overlap):
    assert t_kvit.punct_geometry(rate, body, overlap) == \
        j_vp.punct_geometry(10 ** 6, rate, body, overlap)
    assert t_vit.effective_overlap(rate, overlap) == \
        j_vit.effective_overlap(rate, overlap)


@pytest.mark.parametrize("rate", RATES)
def test_puncture_pattern_matches_jax(rate):
    p = t_punct.pattern(rate)
    assert (p.period, p.keep, p.rank) == j_vp._pattern(rate)
    assert p.order == tuple(int(o) for o in
                            tables.puncture_serial_order(rate))
    assert all(p.rank[o] == r for r, o in enumerate(p.order))
    assert p.align % 8 == 0 and p.align % p.period == 0


def test_viterbi_wrapper_rejects_other_devices():
    coded = torch.zeros(1, 48, dtype=torch.uint8, device="meta")
    tail = torch.zeros(1, 4, 8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_kvit.viterbi_punct(coded, tail, 24, "1/2", 8)


@pytest.mark.parametrize("option,item", [({"demap": "bogus"}, "demap")])
def test_receiver_rejects_unported_options(option, item):
    """An option value the receiver does not have raises ValueError."""
    with pytest.raises(ValueError, match=item):
        t_rx.make_receiver(port_mode(MODE_2K_QPSK), "cpu", **option)
