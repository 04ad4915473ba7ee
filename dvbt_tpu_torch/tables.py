"""ETSI EN 300 744 constant tables, computed host-side with numpy.

The port's own copy of the tables of dvbt_tpu/tables.py that it reads,
whole functions copied unchanged: energy-dispersal PRBS, GF(2^8) and the RS
generator, Table-3 puncturing, bit and symbol interleavers,
constellations, pilots, w_k and TPS.  The JAX package's GF(2) bit-matrix
tables (a TPU matmul formulation of RS) and its trellis tables are not
copied: the port computes RS with GF table gathers and the trellis
parities in kernels/viterbi.py.  tests/test_torch_isolation.py holds every
table here equal to its original.

Pure, deterministic host precomputation, cached with functools.lru_cache.
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# §4.3.1 — Energy dispersal PRBS (poly 1 + x^14 + x^15, seed 100101010000000)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def dispersal_prbs_bits(n_bits: int = 1503 * 8) -> np.ndarray:
    """PRBS bit sequence of the energy-dispersal scrambler.

    EN300744 §4.3.1 / Fig 2: 15-stage LFSR, generator 1+x^14+x^15, loaded with
    ``100101010000000`` at the start of every 8-packet group.  Output (and
    feedback) bit is D14 xor D15.  First output byte is 0x03 (spec note),
    which `tests/test_tables.py` asserts.
    """
    reg = 0b100101010000000  # D1 at bit14 ... D15 at bit0
    out = np.empty(n_bits, dtype=np.uint8)
    for i in range(n_bits):
        b = ((reg >> 1) ^ reg) & 1  # D14 xor D15
        out[i] = b
        reg = (reg >> 1) | (b << 14)
    return out


@functools.lru_cache(maxsize=None)
def dispersal_pattern() -> np.ndarray:
    """(8, 188) uint8 XOR pattern applied to each packet of an 8-packet group.

    Packet 0 of the group: sync byte 0x47 is inverted to 0xB8 (xor 0xFF) and
    the PRBS starts on the following byte.  Packets 1..7: the PRBS keeps
    running over the sync byte but is *not applied* to it (xor 0x00).
    [EN300744 §4.3.1]
    """
    bits = dispersal_prbs_bits(1503 * 8)
    prbs_bytes = np.packbits(bits)  # MSB-first, 1503 bytes
    pat = np.zeros((8, 188), dtype=np.uint8)
    group = np.zeros(8 * 188, dtype=np.uint8)
    group[0] = 0xFF
    for g in range(1, 8 * 188):
        if g % 188 == 0:
            group[g] = 0x00  # sync byte: PRBS advances but is disabled
        else:
            group[g] = prbs_bytes[g - 1]
    return group.reshape(8, 188)


# ---------------------------------------------------------------------------
# §4.3.2 — RS(204,188,T=8) over GF(2^8), p(x)=x^8+x^4+x^3+x^2+1 (0x11D)
# ---------------------------------------------------------------------------

GF_POLY = 0x11D
RS_N, RS_K, RS_T = 204, 188, 8
RS_2T = 2 * RS_T


@functools.lru_cache(maxsize=None)
def gf_tables() -> tuple[np.ndarray, np.ndarray]:
    """(gf_exp[512], gf_log[256]) for GF(2^8) with primitive element alpha=2.

    gf_exp is doubled in length so products of logs never need an explicit
    mod-255 on the host path; device code uses mod 255 instead.
    """
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]
    log[0] = 0  # by convention; zero must be special-cased by callers
    return exp, log


def gf_mul(a, b) -> np.ndarray:
    """Element-wise GF(2^8) multiply (numpy, host-side)."""
    exp, log = gf_tables()
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = exp[(log[a] + log[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.int32)


@functools.lru_cache(maxsize=None)
def rs_generator_poly() -> np.ndarray:
    """g(x) = prod_{i=0..15} (x + alpha^i), coeffs highest-degree first, len 17."""
    exp, _ = gf_tables()
    g = np.array([1], dtype=np.int32)
    for i in range(RS_2T):
        root = exp[i]
        # multiply g by (x + root)
        g_shift = np.concatenate([g, [0]])
        g_scale = np.concatenate([[0], gf_mul(g, root)])
        g = g_shift ^ g_scale
    return g


# ---------------------------------------------------------------------------
# §4.3.3 — Inner convolutional code K=7, G1=171o (X), G2=133o (Y) + puncturing
# ---------------------------------------------------------------------------

G1_OCT, G2_OCT = 0o171, 0o133  # taps over (b_n .. b_{n-6}), bit6 = b_n

#: puncturing patterns, X/Y kept-bit masks per period.  Serial transmitted
#: order is x1 y1 [y2] [x3] ... per EN300744 Table 3.
PUNCTURE = {
    "1/2": (np.array([1], np.uint8), np.array([1], np.uint8)),
    "2/3": (np.array([1, 0], np.uint8), np.array([1, 1], np.uint8)),
    "3/4": (np.array([1, 0, 1], np.uint8), np.array([1, 1, 0], np.uint8)),
    "5/6": (np.array([1, 0, 1, 0, 1], np.uint8), np.array([1, 1, 0, 1, 0], np.uint8)),
    "7/8": (
        np.array([1, 0, 0, 0, 1, 0, 1], np.uint8),
        np.array([1, 1, 1, 1, 0, 1, 0], np.uint8),
    ),
}


@functools.lru_cache(maxsize=None)
def puncture_serial_order(rate: str) -> np.ndarray:
    """Indices into the interleaved (x1,y1,x2,y2,...) stream of one puncture
    period that survive puncturing, in transmitted serial order.

    EN300744 Table 3: after deleting punctured bits the kept bits are read in
    time order x_i before y_i — which is exactly ascending index order in the
    interleaved stream.
    """
    px, py = PUNCTURE[rate]
    period = len(px)
    keep = np.empty(2 * period, dtype=np.uint8)
    keep[0::2] = px
    keep[1::2] = py
    return np.nonzero(keep)[0].astype(np.int32)


# ---------------------------------------------------------------------------
# §4.3.4.1 — Bit-wise inner interleaver (demux + 126-bit block interleavers)
# ---------------------------------------------------------------------------

HE_OFFSETS = (0, 63, 105, 42, 21, 84)  # H_e(w) = (w + off_e) mod 126
BIT_ILV_BLOCK = 126

#: x_k -> b_{e} demultiplexer mapping (input position within a v-bit group ->
#: substream index), EN300744 §4.3.4.1.  Hierarchical maps HP to (b0,b1).
DEMUX = {
    (2, False): (0, 1),
    (4, False): (0, 2, 1, 3),         # x0->b0, x1->b2, x2->b1, x3->b3
    (6, False): (0, 2, 4, 1, 3, 5),   # x0->b0, x1->b2, x2->b4, x3->b1, x4->b3, x5->b5
    (4, True): (0, 1, 2, 3),          # HP: x0,x1 -> b0,b1 ; LP: x0',x1' -> b2,b3
    (6, True): (0, 1, 2, 4, 3, 5),    # HP -> b0,b1 ; LP x''0..x''3 -> b2,b4,b3,b5
}


@functools.lru_cache(maxsize=None)
def bit_interleaver_indices(v: int, hierarchical: bool = False) -> np.ndarray:
    """(126, v) int32: source bit index within one 126*v-bit interleaving
    block for output cell w, output bit e (e=0 is the MSB y0 of the cell).

    Composition of the demux (x_k -> b_{demux[k]}) and the per-substream
    cyclic block interleavers a_e(w) = b_e(H_e(w)).  The coded input stream is
    consumed v bits per cell-slot: input bit index = slot*v + k.
    """
    demux = DEMUX[(v, hierarchical)]
    # b_e(w') came from input bit at slot w', position k where demux[k] == e
    inv = np.zeros(v, dtype=np.int64)
    for k, e in enumerate(demux):
        inv[e] = k
    idx = np.zeros((BIT_ILV_BLOCK, v), dtype=np.int32)
    for w in range(BIT_ILV_BLOCK):
        for e in range(v):
            src_slot = (w + HE_OFFSETS[e]) % BIT_ILV_BLOCK
            idx[w, e] = src_slot * v + inv[e]
    return idx


# ---------------------------------------------------------------------------
# §4.3.4.2 — Symbol inner interleaver H(q)
# ---------------------------------------------------------------------------

#: R'_i bit k -> R_i bit perm[k]; EN300744 Table 6 bit permutations
#: (cross-checkable against gnuradio gr-dtv dvbt_symbol_inner_interleaver).
SYM_BIT_PERM = {
    "2k": (4, 3, 9, 6, 2, 8, 1, 5, 7, 0),
    "8k": (7, 1, 4, 2, 9, 6, 8, 10, 0, 3, 11, 5),
}
#: feedback taps of the (Nr-1)-bit LFSR: toggle bit = xor of R'[t] for t in taps
SYM_LFSR_TAPS = {"2k": (0, 3), "8k": (0, 1, 4, 6)}


@functools.lru_cache(maxsize=None)
def symbol_interleaver_perm(mode: str) -> np.ndarray:
    """H(q) permutation over payload cells: (n_payload,) int32.

    EN300744 §4.3.4.2: H(q) = (i mod 2)*2^{Nr-1} + sum_j R_i(j) 2^j, keeping
    only values < Nmax (1512 for 2K, 6048 for 8K), i = 0..Mmax-1.
    """
    if mode == "2k":
        nr, mmax, nmax = 11, 2048, 1512
    elif mode == "8k":
        nr, mmax, nmax = 13, 8192, 6048
    else:
        raise ValueError(mode)
    nbits = nr - 1
    perm = SYM_BIT_PERM[mode]
    taps = SYM_LFSR_TAPS[mode]
    h = np.zeros(nmax, dtype=np.int32)
    reg = 0
    q = 0
    for i in range(mmax):
        if i == 0 or i == 1:
            reg = 0
        elif i == 2:
            reg = 1
        else:
            bit = 0
            for t in taps:
                bit ^= (reg >> t) & 1
            reg = (reg >> 1) | (bit << (nbits - 1))
        r = 0
        for k in range(nbits):
            r |= ((reg >> k) & 1) << perm[k]
        hq = (i % 2) * (1 << (nr - 1)) + r
        if hq < nmax:
            h[q] = hq
            q += 1
    assert q == nmax, f"H(q) generation produced {q} != {nmax} entries"
    return h


# ---------------------------------------------------------------------------
# §4.3.5 — Constellations (QPSK / 16-QAM / 64-QAM, uniform + hierarchical α)
# ---------------------------------------------------------------------------

#: normalization factors c = 1/sqrt(E) per (v, alpha) [EN300744 Table 7 note]
NORMALIZATION = {
    (2, 1): 1 / np.sqrt(2),
    (4, 1): 1 / np.sqrt(10),
    (4, 2): 1 / np.sqrt(20),
    (4, 4): 1 / np.sqrt(52),
    (6, 1): 1 / np.sqrt(42),
    (6, 2): 1 / np.sqrt(60),
    (6, 4): 1 / np.sqrt(108),
}


def _gray_decode(bits: np.ndarray) -> np.ndarray:
    out = np.zeros(bits.shape[:-1], dtype=np.int64)
    acc = np.zeros_like(out)
    for j in range(bits.shape[-1]):
        acc = acc ^ bits[..., j]
        out = (out << 1) | acc
    return out


@functools.lru_cache(maxsize=None)
def constellation(v: int, alpha: int = 1, normalized: bool = True) -> np.ndarray:
    """(2^v,) complex128 lookup table, index = cell value (y0 = MSB).

    Axis mapping per EN300744 Fig 9: I from (y0, y2, y4), Q from (y1, y3, y5);
    sign bit y0/y1 (1 -> negative); remaining axis bits Gray-map to magnitude
    {1,3,..} + (alpha-1) offset for hierarchical constellations.
    """
    vals = np.arange(1 << v)
    bits = (vals[:, None] >> (v - 1 - np.arange(v))[None, :]) & 1  # y0..y{v-1}
    ibits = bits[:, 0::2]
    qbits = bits[:, 1::2]

    def axis(axbits):
        sign = 1 - 2 * axbits[:, 0]
        m = axbits.shape[1] - 1
        if m == 0:
            mag = np.ones(len(axbits), dtype=np.int64)
        else:
            idx = _gray_decode(axbits[:, 1:])
            mag = (2 ** (m + 1) - 1) - 2 * idx  # 64QAM: 7,5,3,1 ; 16QAM: 3,1
        return sign * (mag + (alpha - 1))

    pts = axis(ibits) + 1j * axis(qbits)
    if normalized:
        pts = pts * NORMALIZATION[(v, alpha)]
    return pts.astype(np.complex128)


# ---------------------------------------------------------------------------
# §4.5 — Pilot carriers & PRBS w_k ; §4.6 — TPS
# ---------------------------------------------------------------------------

CONTINUAL_PILOTS_2K = (
    0, 48, 54, 87, 141, 156, 192, 201, 255, 279, 282, 333, 432, 450, 483, 525,
    531, 618, 636, 714, 759, 765, 780, 804, 873, 888, 918, 939, 942, 969, 984,
    1050, 1101, 1107, 1110, 1137, 1140, 1146, 1206, 1269, 1323, 1377, 1491,
    1683, 1704,
)  # 45 carriers [EN300744 §4.5.3 table]

TPS_PILOTS_2K = (
    34, 50, 209, 346, 413, 569, 595, 688, 790, 901, 1073, 1219, 1262, 1286,
    1469, 1594, 1687,
)  # 17 carriers [EN300744 §4.6 table]


@functools.lru_cache(maxsize=None)
def continual_pilots(mode: str) -> np.ndarray:
    """Continual-pilot carrier indices (45 for 2K, 177 for 8K).

    The 8K set is the 2K set tiled with period 1704 over the 6817 active
    carriers (0 and 1704 overlap at the seams -> 45*4-3 = 177 entries).
    """
    base = np.array(CONTINUAL_PILOTS_2K, dtype=np.int32)
    if mode == "2k":
        return base
    out = np.unique(np.concatenate([base + 1704 * m for m in range(4)]))
    out = out[out <= 6816]
    assert len(out) == 177, len(out)
    return out.astype(np.int32)


@functools.lru_cache(maxsize=None)
def tps_carriers(mode: str) -> np.ndarray:
    """TPS carrier indices (17 for 2K, 68 for 8K; 8K = 2K tiled by 1704)."""
    base = np.array(TPS_PILOTS_2K, dtype=np.int32)
    if mode == "2k":
        return base
    out = np.concatenate([base + 1704 * m for m in range(4)])
    out.sort()
    assert len(out) == 68 and len(np.unique(out)) == 68
    return out.astype(np.int32)


@functools.lru_cache(maxsize=None)
def wk_sequence(n: int) -> np.ndarray:
    """Pilot-modulation PRBS w_k (x^11 + x^2 + 1, all-ones init), (n,) uint8.

    Re-initialised at carrier k=0 of every symbol, so it is a pure function of
    the carrier index. [EN300744 §4.5.2, Fig 11]
    """
    reg = (1 << 11) - 1
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        out[i] = reg & 1
        fb = (reg ^ (reg >> 2)) & 1
        reg = (reg >> 1) | (fb << 10)
    return out


def scattered_pilot_carriers(l_mod4: int, kmax: int) -> np.ndarray:
    """Scattered-pilot carriers for symbol l: k ≡ 3*(l mod 4) (mod 12).

    [EN300744 §4.5.3]
    """
    start = 3 * (l_mod4 % 4)
    return np.arange(start, kmax + 1, 12, dtype=np.int32)


# --- TPS frame ------------------------------------------------------------

TPS_SYNC = (0, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0)  # frames 0,2
TPS_BCH_POLY = 0b100001101110111  # x^14+x^9+x^8+x^6+x^5+x^4+x^2+x+1, 15 bits

TPS_CONSTELLATION_BITS = {2: (0, 0), 4: (0, 1), 6: (1, 0)}
TPS_HIERARCHY_BITS = {0: (0, 0, 0), 1: (0, 0, 1), 2: (0, 1, 0), 4: (0, 1, 1)}
TPS_CODE_RATE_BITS = {
    "1/2": (0, 0, 0), "2/3": (0, 0, 1), "3/4": (0, 1, 0),
    "5/6": (0, 1, 1), "7/8": (1, 0, 0),
}
TPS_GUARD_BITS = {"1/32": (0, 0), "1/16": (0, 1), "1/8": (1, 0), "1/4": (1, 1)}
TPS_MODE_BITS = {"2k": (0, 0), "8k": (0, 1)}


def _bch_67_53_parity(bits53: np.ndarray) -> np.ndarray:
    """14 parity bits of the shortened BCH(67,53) code over s1..s53.

    Systematic encoding: parity = (m(x) * x^14) mod g(x) — the 14 appended
    zero bits realize the x^14 shift (round-1 omitted them, which produced
    m(x) mod g: a codeword that fails the BCH check on a real receiver;
    caught by tests/test_golden.py's independent construction).
    """
    reg = 0
    for b in list(bits53) + [0] * 14:
        reg = (reg << 1) | int(b)
        if reg & (1 << 14):
            reg ^= TPS_BCH_POLY
    return np.array([(reg >> (13 - i)) & 1 for i in range(14)], dtype=np.uint8)


def tps_frame_bits(
    frame_idx: int,
    constellation_v: int,
    alpha: int,
    code_rate_hp: str,
    code_rate_lp: str,
    guard: str,
    mode: str,
    cell_id: int = 0,
    cell_id_on: bool = False,
) -> np.ndarray:
    """The 68 TPS bits s0..s67 of one frame. [EN300744 §4.6]

    s0: initialisation (value irrelevant to the bitstream; the modulation
    initial state comes from w_k) — set 0 here.  s1..s16 sync word (inverted
    on frames 1 and 3); s17..s22 length indicator: 010111 (23 used bits)
    normally, 011111 (31) when the cell identifier is transmitted
    [EN300744 §4.6.2.1] — ``cell_id_on`` mirrors the reference block's
    `include_cell_id` parameter; s23..24 frame number; s25..26 constellation;
    s27..29 hierarchy; s30..35 HP/LP code rates; s36..37 guard; s38..39 mode;
    s40..s53 cell id / reserved (0); s54..67 BCH(67,53) parity.
    """
    s = np.zeros(68, dtype=np.uint8)
    sync = np.array(TPS_SYNC, dtype=np.uint8)
    if frame_idx % 2 == 1:
        sync = 1 - sync
    s[1:17] = sync
    s[17:23] = (0, 1, 1, 1, 1, 1) if cell_id_on else (0, 1, 0, 1, 1, 1)
    s[23] = (frame_idx >> 1) & 1
    s[24] = frame_idx & 1
    s[25:27] = TPS_CONSTELLATION_BITS[constellation_v]
    s[27:30] = TPS_HIERARCHY_BITS[alpha]
    s[30:33] = TPS_CODE_RATE_BITS[code_rate_hp]
    s[33:36] = TPS_CODE_RATE_BITS[code_rate_lp]
    s[36:38] = TPS_GUARD_BITS[guard]
    s[38:40] = TPS_MODE_BITS[mode]
    if cell_id_on:
        for i in range(14):
            s[40 + i] = (cell_id >> (13 - i)) & 1
    s[54:68] = _bch_67_53_parity(s[1:54])
    return s
