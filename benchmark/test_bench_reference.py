"""The plain reference transmitter held against the program's at 2K on
the CPU, over two steps of carried state, and its bfloat16 control."""

import numpy as np
import pytest
import torch

from benchmark.reference import tx as ref

MODES = [("qpsk", "1/2", "1/32", 4), ("64qam", "2/3", "1/32", 4),
         ("16qam", "3/4", "1/4", 4), ("64qam", "7/8", "1/8", 4)]


def port_tx(mode, packets, n_frames):
    from dvbt_tpu_torch.models import tx as txm
    tx, n_pk, _ = txm.make_transmitter(mode, "cpu", n_frames)
    st = txm.init_tx_state(mode, packets.shape[0], "cpu")
    out = []
    for s in range(packets.shape[1] // n_pk):
        st, iq = tx(st, packets[:, s * n_pk:(s + 1) * n_pk])
        out.append(iq)
    return torch.cat(out, -1).to(torch.complex128)


@pytest.mark.parametrize("constellation,rate,guard,n_frames", MODES)
def test_reference_equals_the_program(constellation, rate, guard, n_frames):
    from dvbt_tpu_torch import DvbtMode
    mode = DvbtMode("2k", constellation, rate, guard)
    rmode = ref.Mode("2k", constellation, rate, guard, rate)
    n_pk = round(rmode.packets_per_frame() * n_frames)
    gen = torch.Generator().manual_seed(5)
    pk = torch.randint(0, 256, (2, 2 * n_pk, 188), generator=gen,
                       dtype=torch.uint8)
    pk[..., 0] = 0x47
    want = ref.transmit(rmode, pk)
    got = port_tx(mode, pk, n_frames)
    rms = want.abs().pow(2).mean().sqrt()
    err = float((got - want).abs().max() / rms)
    assert err < 1e-5
    control = ref.transmit(rmode, pk, precision="bfloat16")
    assert float((control - want).abs().max() / rms) > 100 * err


def test_tables_of_the_standard():
    # EN 300 744: the dispersal PRBS starts 0000 0011 1111 0111 ...
    assert ref.dispersal_mask()[0, :3].tolist() == [0xFF, 0x03, 0xF6]
    for t, n in (("2k", 1512), ("8k", 6048)):
        h = ref.symbol_permutation(t)
        assert sorted(h.tolist()) == list(range(n))
    # w_k: 11 ones first
    assert ref.w_k(12).tolist() == [1] * 11 + [0]
    rmode = ref.Mode("8k", "64qam", "2/3", "1/32", "2/3")
    s = ref.tps_bits(rmode, 1)
    assert "".join(map(str, s[1:17])) == "1100101000010001"
    assert s[23:25].tolist() == [0, 1]


def test_rs_parity_is_a_codeword():
    exp, log, g = ref._gf()
    data = torch.randint(0, 256, (3, 188), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    cw = ref.rs_encode(data).numpy().astype(np.int64)
    # every codeword vanishes at alpha^0 .. alpha^15
    for i in range(16):
        acc = np.zeros(3, np.int64)
        for j in range(204):
            a = np.where(acc == 0, 0, exp[(log[acc] + i) % 255])
            acc = a ^ cw[:, j]
        assert (acc == 0).all()
