"""The plain reference transmitter held against the program's at 2K on
the CPU, over two steps of carried state, and its bfloat16 control; in
hierarchical modes too, and with a planted mapping fault."""

import numpy as np
import pytest
import torch

from benchmark.reference import tx as ref

MODES = [("qpsk", "1/2", "1/32", 4), ("64qam", "2/3", "1/32", 4),
         ("16qam", "3/4", "1/4", 4), ("64qam", "7/8", "1/8", 4)]
# (constellation, alpha, HP rate, LP rate, guard); the second is the
# hierarchical 8K deployment's constellation and rates
HIER_MODES = [("16qam", 2, "1/2", "3/4", "1/32"),
              ("64qam", 2, "2/3", "3/4", "1/32"),
              ("64qam", 4, "1/2", "5/6", "1/4")]
# tx_err's limit in every configuration
TX_ERR = 1e-3


def port_tx(mode, packets, n_frames):
    """The program's samples over two steps of carried state; ``packets``
    one tensor, or a hierarchical mode's (HP, LP) pair, of two steps."""
    from dvbt_tpu_torch.models import tx as txm
    tx, n_pk, _ = txm.make_transmitter(mode, "cpu", n_frames)
    pks = tuple(packets) if mode.alpha else (packets,)
    n_pk = tuple(n_pk) if mode.alpha else (n_pk,)
    st = txm.init_tx_state(mode, pks[0].shape[0], "cpu")
    out = []
    for s in range(2):
        step = tuple(p[:, s * n:(s + 1) * n] for p, n in zip(pks, n_pk))
        st, iq = tx(st, step if mode.alpha else step[0])
        out.append(iq)
    return torch.cat(out, -1).to(torch.complex128)


def two_steps(rmode, n_frames):
    """Packets of two steps, one tensor a stream, the pair if
    hierarchical."""
    gen = torch.Generator().manual_seed(5)
    pks = []
    for i in range(len(rmode.streams)):
        n_pk = round(rmode.packets_per_frame(i) * n_frames)
        pk = torch.randint(0, 256, (2, 2 * n_pk, 188), generator=gen,
                           dtype=torch.uint8)
        pk[..., 0] = 0x47
        pks.append(pk)
    return tuple(pks) if rmode.alpha else pks[0]


def error(got, want) -> float:
    return float((got - want).abs().max() / want.abs().pow(2).mean().sqrt())


def check_mode(mode, rmode, n_frames=4):
    pk = two_steps(rmode, n_frames)
    want = ref.transmit(rmode, pk)
    err = error(port_tx(mode, pk, n_frames), want)
    assert err < 1e-5
    control = ref.transmit(rmode, pk, precision="bfloat16")
    assert error(control, want) > 100 * err


@pytest.mark.parametrize("constellation,rate,guard,n_frames", MODES)
def test_reference_equals_the_program(constellation, rate, guard, n_frames):
    from dvbt_tpu_torch import DvbtMode
    check_mode(DvbtMode("2k", constellation, rate, guard),
               ref.Mode("2k", constellation, rate, guard, rate), n_frames)


@pytest.mark.parametrize("constellation,alpha,rate,rate_lp,guard",
                         HIER_MODES)
def test_hierarchical_reference_equals_the_program(
        constellation, alpha, rate, rate_lp, guard):
    from dvbt_tpu_torch import DvbtMode
    check_mode(DvbtMode("2k", constellation, rate, guard, alpha, rate_lp),
               ref.Mode("2k", constellation, rate, guard, rate_lp, alpha))


def test_wrong_constellation_fails_tx_err(monkeypatch):
    """The alpha = 1 constellation mapped under alpha = 2 TPS: the
    mapping is the only fault, and tx_err sees it."""
    from dvbt_tpu_torch import DvbtMode
    mode = DvbtMode("2k", "64qam", "2/3", "1/32", 2, "3/4")
    rmode = ref.Mode("2k", "64qam", "2/3", "1/32", "3/4", 2)
    pk = two_steps(rmode, 4)
    sound = port_tx(mode, pk, 4)
    qam = ref.qam
    monkeypatch.setattr(ref, "qam", lambda words, v, alpha: qam(words, v, 1))
    assert error(sound, ref.transmit(rmode, pk)) > TX_ERR


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
    # s27..s29, the hierarchy; s30..s35 the HP and LP rates
    for alpha, bits in ((0, "000"), (1, "001"), (2, "010"), (4, "011")):
        s = ref.tps_bits(ref.Mode("8k", "64qam", "2/3", "1/32", "3/4",
                                  alpha), 0)
        assert "".join(map(str, s[27:36])) == bits + "001" + "010"
    # §4.3.5: unit mean power over every point; the alpha = 2 64-QAM
    # points nearest an axis at 2 / sqrt(60)
    for v, alpha in ((2, 0), (4, 0), (6, 0), (4, 1), (4, 2), (4, 4),
                     (6, 1), (6, 2), (6, 4)):
        z = ref.qam(torch.arange(1 << v), v, alpha)
        assert float(z.abs().pow(2).mean()) == pytest.approx(1.0)
    z = ref.qam(torch.arange(64), 6, 2)
    assert float(z.real.abs().min()) == pytest.approx(2 / 60 ** 0.5)


def test_mode_from_takes_the_hierarchy():
    m = {"transmission": "8k", "constellation": "64qam", "code_rate": "2/3",
         "guard": "1/32", "code_rate_lp": "3/4"}
    assert ref.mode_from({"mode": m}) == ref.Mode("8k", "64qam", "2/3",
                                                  "1/32", "3/4")
    assert ref.mode_from({"mode": dict(m, alpha=2)}).alpha == 2
    for bad in ({"alpha": 3}, {"alpha": 2, "constellation": "qpsk"}):
        with pytest.raises(ValueError):
            ref.mode_from({"mode": dict(m, **bad)})


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
