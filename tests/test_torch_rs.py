"""The RS decoder's wrapper (kernels/rs.py) and the kernel's tables, on
the CPU.  The kernel itself runs only on the card, where chip_smoke.py
holds it byte for byte against the plain version; here the wrapper's
dispatch and checks, and the algebra the kernel rests on: its tables, and
that the remainder modulo g(x) gives the plain version's syndromes."""

import numpy as np
import pytest
import torch

from dvbt_tpu_torch import tables
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
    before = krs.launches
    got = rs.make_rs_decoder("cpu")(cw)
    want = krs.make_rs_decoder_plain("cpu")(cw)
    assert krs.launches == before
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
