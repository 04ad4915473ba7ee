"""The PyTorch port's TX modules and kernel K2 (plain version) against the
JAX package, on the CPU.  Inputs come from seeded numpy; bit and byte
stages must match exactly, float stages within the golden tolerance."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu import tables
from dvbt_tpu.io.ts import make_ts_packets
from dvbt_tpu.kernels import coder_pallas
from dvbt_tpu.mode import MODE_2K_QPSK, MODE_8K_UK, DvbtMode
from dvbt_tpu.ops import bit_interleaver as j_bil
from dvbt_tpu.ops import energy as j_en
from dvbt_tpu.ops import inner_coder as j_ic
from dvbt_tpu.ops import mapper as j_map
from dvbt_tpu.ops import ofdm as j_ofdm
from dvbt_tpu.ops import outer_interleaver as j_oil
from dvbt_tpu.ops import reed_solomon as j_rs
from dvbt_tpu.ops import reference_signals as j_ref
from dvbt_tpu.utils import bits as j_bits
from dvbt_tpu_torch.coder_bench import numpy_mother_code
from dvbt_tpu_torch.kernels import coder as t_kcoder
from dvbt_tpu_torch.models import tx as t_tx
from dvbt_tpu_torch.ops import bit_interleaver as t_bil
from dvbt_tpu_torch.ops import energy as t_en
from dvbt_tpu_torch.ops import inner_coder as t_ic
from dvbt_tpu_torch.ops import mapper as t_map
from dvbt_tpu_torch.ops import ofdm as t_ofdm
from dvbt_tpu_torch.ops import outer_interleaver as t_oil
from dvbt_tpu_torch.ops import reed_solomon as t_rs
from dvbt_tpu_torch.ops import reference_signals as t_ref
from dvbt_tpu_torch.ops import viterbi as t_vit
from dvbt_tpu_torch.utils import bits as t_bits
from dvbt_tpu_torch.utils.state import mode_from_jax as port_mode

torch.set_num_threads(1)

ATOL = 2e-5  # golden tolerance (tests/test_golden.py)
RATES = ["1/2", "2/3", "3/4", "5/6", "7/8"]
MODES = {
    "2k_qpsk_12": MODE_2K_QPSK,
    "2k_16qam_34": DvbtMode("2k", "16qam", "3/4"),
    "2k_64qam_23": DvbtMode("2k", "64qam", "2/3"),
}
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def test_bits_round_trip_matches_jax():
    x = np.random.default_rng(0).integers(0, 256, (3, 37), dtype=np.uint8)
    bits = t_bits.bytes_to_bits(torch.from_numpy(x))
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(j_bits.bytes_to_bits(jnp.asarray(x))))
    np.testing.assert_array_equal(t_bits.bits_to_bytes(bits).numpy(), x)


def test_energy_dispersal_matches_jax():
    rng = np.random.default_rng(1)
    n = 13
    pk = rng.integers(0, 256, (3, n, 188), dtype=np.uint8)
    pk[:, :, 0] = 0x47
    phases = np.array([0, 3, 7], np.int32)
    disperse = t_en.make_energy_dispersal(n, "cpu")
    nphase, out = disperse(torch.from_numpy(phases), torch.from_numpy(pk))
    j_disperse = j_en.make_energy_dispersal(n)
    for m in range(3):
        jp, jo = j_disperse(jnp.int32(phases[m]), jnp.asarray(pk[m]))
        assert int(jp) == int(nphase[m])
        np.testing.assert_array_equal(out[m].numpy(), np.asarray(jo))
        assert int(j_en.detect_dispersal_phase(jo)) == \
            int(t_en.detect_dispersal_phase(out)[m])
    assert t_en.detect_dispersal_phase(out).tolist() == phases.tolist()


def test_rs_encoder_matches_jax():
    msg = np.random.default_rng(2).integers(0, 256, (2, 9, 188),
                                            dtype=np.uint8)
    got = t_rs.make_rs_encoder("cpu")(torch.from_numpy(msg)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_rs.make_rs_encoder()(jnp.asarray(msg))))
    np.testing.assert_array_equal(got, tables.rs_encode_ref(msg))


@pytest.mark.parametrize("deinterleave", [False, True])
def test_outer_interleaver_matches_jax(deinterleave):
    rng = np.random.default_rng(3)
    n = 204 * 7
    make_t = (t_oil.make_outer_deinterleaver if deinterleave
              else t_oil.make_outer_interleaver)
    make_j = (j_oil.make_outer_deinterleaver if deinterleave
              else j_oil.make_outer_interleaver)
    f_t, f_j = make_t(n, "cpu"), make_j(n)
    tail_t = t_oil.init_state(2, "cpu")
    tail_j = [j_oil.init_state(), j_oil.init_state()]
    for _ in range(3):
        x = rng.integers(0, 256, (2, n), dtype=np.uint8)
        tail_t, y = f_t(tail_t, torch.from_numpy(x))
        for m in range(2):
            tail_j[m], yj = f_j(tail_j[m], jnp.asarray(x[m]))
            np.testing.assert_array_equal(y[m].numpy(), np.asarray(yj))
            np.testing.assert_array_equal(tail_t[m].numpy(),
                                          np.asarray(tail_j[m]))


@pytest.mark.parametrize("rate", RATES)
def test_byte_coder_plain_matches_jax(rate):
    """K2's plain version == the Pallas byte coder (interpret mode) == the
    jnp bit coder, over two blocks with carried state."""
    rng = np.random.default_rng(RATES.index(rate))
    n_bytes = 3 * 5 * 7 * 8 * 19   # whole periods at every rate
    coder = t_ic.make_inner_coder(n_bytes, rate)
    pallas = coder_pallas.make_byte_coder(n_bytes, rate, interpret=True)
    jnp_coder = j_ic.make_inner_coder(n_bytes * 8, rate)
    st_t = t_ic.init_state(2, "cpu")
    st_p = [j_ic.init_state(), j_ic.init_state()]
    st_j = [j_ic.init_state(), j_ic.init_state()]
    for _ in range(2):
        stream = rng.integers(0, 256, (2, n_bytes), dtype=np.uint8)
        st_t, got = coder(st_t, torch.from_numpy(stream))
        for m in range(2):
            st_p[m], want_p = pallas(st_p[m], jnp.asarray(stream[m]))
            st_j[m], want_j = jnp_coder(
                st_j[m], j_bits.bytes_to_bits(jnp.asarray(stream[m])))
            np.testing.assert_array_equal(got[m].numpy(), np.asarray(want_p))
            np.testing.assert_array_equal(got[m].numpy(), np.asarray(want_j))
            np.testing.assert_array_equal(st_t[m].numpy(), np.asarray(st_p[m]))
            np.testing.assert_array_equal(st_t[m].numpy(), np.asarray(st_j[m]))


@pytest.mark.parametrize("rate", RATES)
def test_plain_coder_and_decoder_hold_the_numpy_mother_code(rate):
    """The inner coder equals the numpy mother code + puncture reference
    (chip_smoke.py holds K2 to the same) on random bits, and the
    receiver's decoder from its initial state decodes that coded stream,
    noiseless at x15, to the info bytes.  13,440 bits are whole puncture
    periods of every rate."""
    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, size=13440, dtype=np.uint8)
    stream = np.packbits(bits)
    coded_ref = numpy_mother_code(bits, rate)
    _, coded = t_ic.make_inner_coder(len(stream), rate)(
        t_ic.init_state(1, "cpu"), torch.from_numpy(stream)[None])
    np.testing.assert_array_equal(coded[0].numpy(), coded_ref)
    state = t_vit.init_state(1, t_vit.effective_overlap(rate), "cpu")
    _, out = t_vit.make_viterbi_decoder(len(bits), rate)(
        state, torch.from_numpy(coded_ref * np.uint8(15))[None])
    np.testing.assert_array_equal(out[0].numpy(), stream)


@pytest.mark.parametrize("rate", RATES)
def test_depuncture_matches_jax(rate):
    period = len(tables.PUNCTURE[rate][0])
    keep = len(tables.puncture_serial_order(rate))
    n_bits = period * 40
    coded = np.random.default_rng(5).integers(0, 16, (2, n_bits // period
                                                      * keep), dtype=np.uint8)
    got = t_ic.make_depuncture(n_bits, rate)(torch.from_numpy(coded))
    want = j_ic.make_depuncture(n_bits, rate)(jnp.asarray(coded))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.numpy(), np.broadcast_to(np.asarray(w), g.shape))


def test_byte_coder_wrapper_rejects_other_devices():
    stream = torch.zeros(1, 24, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        t_kcoder.byte_coder(torch.zeros(1, 6, dtype=torch.uint8,
                                        device="meta"), stream, "1/2")


@pytest.mark.parametrize("name", sorted(MODES))
def test_bit_interleaver_and_mapper_match_jax(name):
    mode = MODES[name]
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (2, 3, mode.n_payload * mode.v), dtype=np.uint8)
    cells = t_bil.make_bit_interleaver(port_mode(mode), "cpu")(
        torch.from_numpy(bits))
    want = np.asarray(j_bil.make_bit_interleaver(mode)(jnp.asarray(bits)))
    np.testing.assert_array_equal(cells.numpy(), want)
    pts = t_map.make_mapper(port_mode(mode), "cpu")(cells)
    np.testing.assert_array_equal(
        pts.numpy(), np.asarray(j_map.make_mapper(mode)(jnp.asarray(want))))


@pytest.mark.parametrize("name", ["2k_qpsk_12", "2k_64qam_23"])
def test_frame_builder_and_modulator_match_jax(name):
    mode = MODES[name]
    rng = np.random.default_rng(7)
    shape = (2, 68, mode.n_payload)
    pts = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
           ).astype(np.complex64)
    fidx = np.array([1, 2], np.int32)
    carriers = t_ref.make_frame_builder(port_mode(mode), "cpu")(
        torch.from_numpy(fidx), torch.from_numpy(pts))
    iq = t_ofdm.make_ofdm_modulator(port_mode(mode), "cpu")(carriers)
    build_j = j_ref.make_frame_builder(mode)
    mod_j = j_ofdm.make_ofdm_modulator(mode, fft_impl="jnp")
    for m in range(2):
        cj = build_j(jnp.int32(fidx[m]), jnp.asarray(pts[m]))
        np.testing.assert_array_equal(carriers[m].numpy(), np.asarray(cj))
        np.testing.assert_allclose(iq[m].numpy(), np.asarray(mod_j(cj)),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,mode", [("2k_qpsk_12", MODE_2K_QPSK),
                                       ("8k_64qam_23", MODE_8K_UK)])
def test_transmitter_matches_golden(name, mode):
    """The port's TX against the frozen snapshots of the JAX TX (the 8K
    case is the one 8K test of the port's CPU suite)."""
    want = np.load(os.path.join(GOLDEN_DIR, f"tx_{name}.npz"))
    tx, n_pk, n_samp = t_tx.make_transmitter(port_mode(mode), "cpu")
    pk = torch.from_numpy(make_ts_packets(n_pk, seed=7))[None]
    state = t_tx.init_tx_state(port_mode(mode), 1, "cpu")
    state, iq = tx(state, pk)
    _, iq2 = tx(state, pk)
    assert iq.shape == (1, n_samp) and iq.dtype == torch.complex64
    L = mode.symbol_len
    iq, iq2 = iq[0].numpy(), iq2[0].numpy()
    np.testing.assert_allclose(iq[:4 * L], want["iq_head"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(iq2[:2 * L], want["iq2_head"], rtol=0,
                               atol=ATOL)
    assert float(np.mean(np.abs(iq) ** 2)) == pytest.approx(
        float(want["power"]), rel=1e-3)


def test_transmitter_rejects_hierarchical():
    """A hierarchical transmitter takes a (packets_hp, packets_lp) pair and
    refuses a single tensor, as a single-stream one refuses a pair."""
    mode = port_mode(DvbtMode("2k", "16qam", "3/4", alpha=2))
    tx, (n_hp, n_lp), _ = t_tx.make_transmitter(mode, "cpu")
    pk = torch.zeros(1, n_hp, 188, dtype=torch.uint8)
    with pytest.raises(ValueError, match="pair"):
        tx(t_tx.init_tx_state(mode, 1, "cpu"), pk)
    flat = port_mode(MODE_2K_QPSK)
    tx1, n_pk, _ = t_tx.make_transmitter(flat, "cpu")
    pk1 = torch.zeros(1, n_pk, 188, dtype=torch.uint8)
    with pytest.raises(ValueError, match="pair"):
        tx1(t_tx.init_tx_state(flat, 1, "cpu"), (pk1, pk1))
