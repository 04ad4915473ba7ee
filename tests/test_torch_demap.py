"""The demap_deinterleave stage (``kernels/demap.py``) on the CPU.

The stage's plain version, which CPU tensors take, is held byte for byte
against the port's composition written out here: the cell deinterleaver,
the hard demapper with the bit deinterleaver at scale 15 or the soft
demapper (CSI-weighted or not) with the soft bit deinterleaver, then the
HP/LP split.  The CUDA kernel runs only on the card (``chip_smoke.py``
compares it with the plain version there); here its tables are held by an
emulation of the kernel's table-driven algorithm in PyTorch: hard metrics
exactly, soft ones within one level, since the kernel multiplies by the
float32 reciprocal of dmin2 where the plain version on the CPU divides.
Every constellation and alpha, 2K and 8K, S = 4 and 68 symbols.
"""

import numpy as np
import pytest
import torch

from dvbt_tpu_torch.kernels import demap as kdemap
from dvbt_tpu_torch.mode import DvbtMode
from dvbt_tpu_torch.ops import bit_interleaver as t_bil
from dvbt_tpu_torch.ops import mapper as t_map
from dvbt_tpu_torch.ops import reference_signals as t_ref

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_MUX = 2
CONSTELLATIONS = [("qpsk", 0), ("16qam", 0), ("64qam", 0), ("16qam", 1),
                  ("16qam", 2), ("16qam", 4), ("64qam", 1), ("64qam", 2),
                  ("64qam", 4)]
# (demap, whether the channel estimate is given)
DEMAPS = [("hard", True), ("soft", True), ("soft", False)]
# soft metrics the emulated kernel may move by one level, where
# 7.5 + 7.5 * llr / dmin2 sits on a rounding boundary (measured: 1 of
# 86,365,440 over every mode here at S = 68, with and without CSI)
MAX_SOFT_SHARE = 1e-4


def _mode(transmission, constellation, alpha) -> DvbtMode:
    return DvbtMode(transmission, constellation, "2/3", alpha=alpha,
                    code_rate_lp="3/4")


def _inputs(mode, n_sym, seed):
    """Equalized carriers near the constellation's points at ~20 dB, and
    a channel estimate whose magnitude spans 0.1 to 2."""
    rng = np.random.default_rng(seed)
    shape = (N_MUX, n_sym, mode.n_carriers)
    pts = mode.constellation_table()[rng.integers(0, 2 ** mode.v, shape)]
    noise = rng.standard_normal(shape + (2,)) @ [1, 1j]
    X = (pts + 0.07 * noise).astype(np.complex64)
    H = (rng.uniform(0.1, 2.0, shape)
         * np.exp(2j * np.pi * rng.uniform(size=shape))).astype(np.complex64)
    return torch.from_numpy(X), torch.from_numpy(H)


def _composition(mode, demap, X, H):
    """The receiver's stage as the port composed it before the kernel."""
    cell_dilv = t_ref.make_cell_deinterleaver(mode, CPU)
    Xc = cell_dilv(X)
    if demap == "hard":
        cells = t_map.make_demapper(mode, CPU)(Xc)
        bits = t_bil.make_bit_deinterleaver(mode, CPU, scale=15)(cells)
    else:
        csi = None
        if H is not None:
            csi = H.abs() ** 2
            csi = cell_dilv(csi / csi.mean(-1, keepdim=True))
        soft = t_map.make_soft_demapper(mode, CPU)(Xc, csi)
        bits = t_bil.make_soft_bit_deinterleaver(mode, CPU)(soft)
    if not mode.hierarchical:
        return (bits.reshape(N_MUX, -1),)
    grouped = bits.reshape(N_MUX, -1, mode.n_payload, mode.v)
    return (grouped[..., :2].reshape(N_MUX, -1),
            grouped[..., 2:].reshape(N_MUX, -1))


def _emulate_kernel(mode, demap, X, H):
    """The kernel's algorithm over its own tables (``kernel_tables``): the
    4-phase cell gather, the demap from the constants, the cell-order tile
    and each stream's in-block table."""
    t = kdemap.kernel_tables(mode, demap)
    words = t["consts"]
    f = words.view(np.float32)
    n, S, K = X.shape
    P, v, h = mode.n_payload, mode.v, mode.v // 2
    idx = torch.from_numpy(t["cell_idx"].astype(np.int64))
    Y = torch.gather(X, -1, idx[torch.arange(S) % 4].expand(n, S, P))
    if demap == "hard":
        m = 1 << (h - 1)

        def axis(z, contrib):
            neg = (z < 0).long()
            if m == 1:
                return contrib[neg]
            ka = torch.clamp(torch.round((z.abs() * float(f[0])
                                          - float(f[1])) * 0.5), 0, m - 1)
            return contrib[ka.long() + m * neg]

        cells = (axis(Y.real, torch.from_numpy(words[4:12].astype(np.int64)))
                 | axis(Y.imag, torch.from_numpy(words[12:20].astype(
                     np.int64))))
        shifts = torch.arange(v - 1, -1, -1)
        tile = ((cells[..., None] >> shifts) & 1) * 15      # (n, S, P, v)
    else:
        w = 1.0
        if H is not None:
            hs = H.abs() ** 2
            w = torch.gather(hs / hs.mean(-1, keepdim=True), -1,
                             idx[torch.arange(S) % 4].expand(n, S, P))
        per_bit = []
        for a, z in enumerate((Y.real, Y.imag)):
            lev = torch.from_numpy(f[20 + 16 * a:20 + 16 * a + 2 ** h].copy())
            hsq = torch.from_numpy(f[28 + 16 * a:28 + 16 * a + 2 ** h].copy())
            s = z[..., None] * lev - hsq
            k = torch.arange(2 ** h)
            axis_bits = []
            for j in range(h):
                one = ((k >> (h - 1 - j)) & 1).bool()
                llr = (s[..., one].amax(-1) - s[..., ~one].amax(-1)) * w
                q = torch.round(7.5 + 7.5 * llr * float(f[2]))
                axis_bits.append(torch.clamp(q, 0, 15))
            per_bit.append(axis_bits)
        # metric e of a cell: I bit e // 2 for even e, Q bit e // 2 for odd
        tile = torch.stack([per_bit[e % 2][e // 2] for e in range(v)], -1)
    flat = tile.to(torch.uint8).reshape(n, S, P * v)
    outs, start = [], 0
    for _, width in kdemap.stream_widths(mode):
        run = kdemap.BLOCK_CELLS * width
        tab = torch.from_numpy(t["perm"][start:start + run].astype(np.int64))
        start += run
        q = torch.arange(P * width)
        r = tab[q % run]
        src = ((q // run) * kdemap.BLOCK_CELLS + (r >> 3)) * v + (r & 7)
        outs.append(flat[..., src].reshape(n, -1))
    return tuple(outs)


SHAPES = [("2k", 4), ("2k", 68), ("8k", 4), ("8k", 68)]


@pytest.mark.parametrize("transmission,n_sym", SHAPES)
@pytest.mark.parametrize("demap,with_h", DEMAPS)
@pytest.mark.parametrize("constellation,alpha", CONSTELLATIONS)
def test_plain_version_is_the_composition(constellation, alpha, demap,
                                          with_h, transmission, n_sym):
    mode = _mode(transmission, constellation, alpha)
    X, H = _inputs(mode, n_sym, seed=n_sym + 7 * alpha)
    H = H if with_h else None
    got = kdemap.make_demap_deinterleave(mode, CPU, demap)(X, H)
    want = _composition(mode, demap, X, H)
    assert len(got) == len(want) == 1 + mode.hierarchical
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.uint8 and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("transmission,n_sym", SHAPES)
@pytest.mark.parametrize("demap,with_h", DEMAPS)
@pytest.mark.parametrize("constellation,alpha", CONSTELLATIONS)
def test_kernel_tables_reproduce_the_plain_version(constellation, alpha,
                                                   demap, with_h,
                                                   transmission, n_sym):
    mode = _mode(transmission, constellation, alpha)
    X, H = _inputs(mode, n_sym, seed=3 * n_sym + alpha)
    H = H if with_h else None
    got = _emulate_kernel(mode, demap, X, H)
    want = kdemap.make_demap_deinterleave_plain(mode, CPU, demap)(X, H)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        diff = (g.int() - w.int()).abs()
        if demap == "hard":
            assert torch.equal(g, w)
        else:
            assert int(diff.max()) <= 1
            assert float((diff > 0).float().mean()) <= MAX_SOFT_SHARE


@pytest.mark.parametrize("transmission", ["2k", "8k"])
@pytest.mark.parametrize("constellation,alpha", CONSTELLATIONS)
def test_kernel_tables_are_permutations(constellation, alpha, transmission):
    """Every row phase reads each payload carrier once; the streams'
    in-block tables read each (cell, bit) of a 126-cell block once."""
    mode = _mode(transmission, constellation, alpha)
    t = kdemap.kernel_tables(mode)
    data = t_ref._frame_tables(mode)["data_idx"]
    for p in range(4):
        assert sorted(t["cell_idx"][p].tolist()) == sorted(data[p].tolist())
    perm = t["perm"].astype(np.int64)
    assert perm.size == kdemap.BLOCK_CELLS * mode.v
    assert (perm & 7).max() < mode.v and (perm >> 3).max() < 126
    assert np.unique((perm >> 3) * mode.v + (perm & 7)).size == perm.size


def _bad_inputs(mode):
    X, H = _inputs(mode, 4, seed=1)
    return {
        "complex128": (X.to(torch.complex128), None, TypeError),
        "float32": (X.real.contiguous(), None, TypeError),
        "two axes": (X[0], None, ValueError),
        "carriers": (X[..., :-1].contiguous(), None, ValueError),
        "S = 6": (torch.cat([X, X[:, :2]], 1), None, ValueError),
        "S = 0": (X[:, :0], None, ValueError),
        "not contiguous": (X.transpose(1, 2).contiguous().transpose(1, 2),
                           None, ValueError),
        "H shape": (torch.cat([X, X], 1), H, ValueError),
        "H dtype": (X, H.to(torch.complex128), TypeError),
    }


@pytest.mark.parametrize("case", list(_bad_inputs(_mode("2k", "16qam", 0))))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    mode = _mode("2k", "16qam", 0)
    X, H, err = _bad_inputs(mode)[case]
    with pytest.raises(err):
        kdemap.make_demap_deinterleave(mode, CPU, "soft")(X, H)


def test_unknown_demap_raises():
    with pytest.raises(ValueError, match="demap"):
        kdemap.make_demap_deinterleave(_mode("2k", "qpsk", 0), CPU, "llr")
