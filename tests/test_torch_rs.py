"""The RS decoder's and encoder's wrappers (kernels/rs.py) and the kernels'
tables, on the CPU.  The kernels themselves run only on the card, where
chip_smoke.py holds them byte for byte against the plain versions; here the
wrappers' dispatch and checks, and the algebra the kernels rest on: their
tables, that the remainder modulo g(x) gives the plain version's
syndromes, and that the encoder's LFSR over the same table rows gives the
plain encoder's and the JAX package's codewords."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt_tpu.ops import reed_solomon as j_rs
from dvbt_tpu_torch import tables
from dvbt_tpu_torch.io.ts import make_ts_packets
from dvbt_tpu_torch.kernels import _build
from dvbt_tpu_torch.kernels import rs as krs
from dvbt_tpu_torch.ops import reed_solomon as rs


def _codewords(n, n_err, seed):
    """n codewords of random messages, n_err[p % len(n_err)] random byte
    errors in packet p."""
    rng = np.random.default_rng(seed)
    msg = torch.as_tensor(rng.integers(0, 256, (n, 188), dtype=np.uint8))
    cw = rs.make_rs_encoder("cpu")(msg).numpy().copy()
    for p in range(n):
        ne = n_err[p % len(n_err)]
        pos = rng.choice(204, ne, replace=False)
        cw[p, pos] ^= rng.integers(1, 256, ne, dtype=np.uint8)
    return torch.from_numpy(cw)


def _table_parts():
    blob = krs.decoder_tables("cpu").numpy()
    feedback = blob[:4096].reshape(256, 16).astype(np.int64)
    exp = blob[4096:5120].astype(np.int64)
    log = blob[5120:].view("<u2").astype(np.int64)
    return feedback, exp, log


def test_cpu_tensors_take_the_plain_version():
    cw = _codewords(12, [0, 3, 8, 11], seed=1)
    before = _build.launches["rs_decode"]
    got = rs.make_rs_decoder("cpu")(cw)
    want = krs.make_rs_decoder_plain("cpu")(cw)
    assert _build.launches["rs_decode"] == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool


@pytest.mark.parametrize("what,make,error", [
    ("int32", lambda cw: cw.to(torch.int32), TypeError),
    ("non_contiguous", lambda cw: cw.t().contiguous().t(), ValueError),
    ("meta_device", lambda cw: cw.to("meta"), ValueError),
    ("last_dim_188", lambda cw: cw[:, :188].contiguous(), ValueError),
    ("scalar", lambda cw: cw[0, 0], ValueError),
])
def test_the_wrapper_rejects(what, make, error):
    cw = make(_codewords(4, [0], seed=2))
    with pytest.raises(error, match="^rs_decode: "):
        rs.make_rs_decoder("cpu")(cw)


def test_kernel_tables():
    """Row f is f * g(x)'s low coefficients (x^15's first); exp[log a +
    log b] is a * b for every pair, zeros included (log 0 = 510, exp 0
    from 510); exp[255 - log d] is d^-1."""
    feedback, exp, log = _table_parts()
    assert krs.decoder_tables("cpu").numel() == krs.TABLE_BYTES
    g = tables.rs_generator_poly()
    f = np.arange(256)
    np.testing.assert_array_equal(feedback, tables.gf_mul(f[:, None],
                                                          g[None, 1:]))
    a, b = np.meshgrid(f, f, indexing="ij")
    np.testing.assert_array_equal(exp[log[a] + log[b]], tables.gf_mul(a, b))
    assert log[0] == krs.LOG_ZERO and not exp[krs.LOG_ZERO:].any()
    d = f[1:]
    np.testing.assert_array_equal(tables.gf_mul(d, exp[255 - log[d]]), 1)


def test_remainder_gives_the_plain_syndromes():
    """The kernel's first pass, the LFSR division by g(x) through the
    table's rows, in numpy over many packets: r(x) is zero exactly where
    every syndrome is, and r(alpha^j) is S_j."""
    feedback, exp, log = _table_parts()
    cw = _codewords(64, [0, 0, 1, 2, 8, 9, 16, 40], seed=3)
    R = np.zeros((cw.shape[0], 16), np.int64)       # R[:, 0]: x^15
    for i in range(204):
        fb = R[:, 0]
        R = np.concatenate([R[:, 1:], cw[:, i, None].numpy()], axis=1)
        R ^= feedback[fb]
    r = R[:, ::-1]                                  # r[:, k]: x^k
    k = np.arange(16)
    S = np.zeros_like(r)
    for j in range(16):
        S[:, j] = np.bitwise_xor.reduce(exp[log[r] + j * k], axis=1)
    deg = 203 - np.arange(204)
    rows = tables.gf_tables()[0][(k[None, :] * deg[:, None]) % 255]
    want = torch.as_tensor(krs._linear_table(rows))
    S_plain = krs._linear_map(cw, want).numpy()
    np.testing.assert_array_equal(S, S_plain)
    np.testing.assert_array_equal((r == 0).all(1), (S_plain == 0).all(1))
    assert (r == 0).all(1).sum() == 16          # the noiseless packets


# 2K one-frame packet counts: 64-QAM 2/3 (252, so the kernel's last block of
# 64 packets is ragged) and QPSK 1/2 (63, under one block)
ENCODE_LEADS = [(252,), (2, 252), (63,)]
ENCODE_KINDS = {
    "random": lambda rng, lead: rng.integers(0, 256, lead + (188,),
                                             dtype=np.uint8),
    "zeros": lambda rng, lead: np.zeros(lead + (188,), np.uint8),
    "all_ff": lambda rng, lead: np.full(lead + (188,), 0xFF, np.uint8),
    "sync_packets": lambda rng, lead: make_ts_packets(
        int(np.prod(lead)), seed=int(rng.integers(1 << 16))).reshape(
            lead + (188,)),
}


@pytest.fixture(scope="module")
def jax_encoder():
    """The JAX package's encoder, made once for the module."""
    return j_rs.make_rs_encoder()


def _encode_model(msg: np.ndarray) -> np.ndarray:
    """The encode kernel's loop in numpy, a row a thread: 188 steps of
    f = m_i + r_15 through decoder_tables' f * g(x) rows, r = r * x + row f;
    the codeword is the message then r's bytes, x^15's first."""
    feedback, _, _ = _table_parts()
    flat = msg.reshape(-1, 188).astype(np.int64)
    R = np.zeros((flat.shape[0], 16), np.int64)     # R[:, 0]: x^15
    for i in range(188):
        f = feedback[R[:, 0] ^ flat[:, i]]
        R = np.concatenate([R[:, 1:], np.zeros_like(R[:, :1])], axis=1) ^ f
    cw = np.concatenate([flat, R], axis=1).astype(np.uint8)
    return cw.reshape(msg.shape[:-1] + (204,))


@pytest.mark.parametrize("lead", ENCODE_LEADS, ids=str)
@pytest.mark.parametrize("kind", list(ENCODE_KINDS))
def test_encode_model_gives_the_plain_and_jax_codewords(kind, lead,
                                                         jax_encoder):
    rng = np.random.default_rng([len(kind), *lead])
    msg = ENCODE_KINDS[kind](rng, lead)
    got = _encode_model(msg)
    assert got.shape == lead + (204,)
    plain = krs.make_rs_encoder_plain("cpu")(torch.from_numpy(msg)).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, np.asarray(jax_encoder(
        jnp.asarray(msg))))
    # a whole codeword divides by g(x): the decoder's remainder is zero
    assert not krs.make_rs_decoder_plain("cpu")(
        torch.from_numpy(got))[2].any()


def test_cpu_encode_takes_the_plain_version():
    msg = torch.as_tensor(np.random.default_rng(4).integers(
        0, 256, (2, 9, 188), dtype=np.uint8))
    before = _build.launches["rs_encode"]
    got = rs.make_rs_encoder("cpu")(msg)
    assert _build.launches["rs_encode"] == before == 0
    assert got.dtype == torch.uint8 and got.shape == (2, 9, 204)
    assert torch.equal(got, krs.make_rs_encoder_plain("cpu")(msg))
    assert torch.equal(got[..., :188], msg)


@pytest.mark.parametrize("what,make,error", [
    ("int32", lambda m: m.to(torch.int32), TypeError),
    ("non_contiguous", lambda m: m.t().contiguous().t(), ValueError),
    ("meta_device", lambda m: m.to("meta"), ValueError),
    ("last_dim_204", lambda m: torch.cat([m, m[:, :16]], -1), ValueError),
    ("scalar", lambda m: m[0, 0], ValueError),
])
def test_the_encode_wrapper_rejects(what, make, error):
    msg = make(torch.zeros(4, 188, dtype=torch.uint8))
    with pytest.raises(error, match="^rs_encode: "):
        rs.make_rs_encoder("cpu")(msg)
