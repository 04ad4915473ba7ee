"""A plain DVB-T transmitter, written from ETSI EN 300 744 (§4.3-4.5).

The benchmark's yardstick: it makes the receiver cells' streams and
captures, and it works out again the samples of the head-end step.  Plain
PyTorch on any device, integer stages exact and the OFDM in complex128.
It imports nothing of the program under test and takes none of its
tables; of the standard it copies only the carrier tables it cannot
compute (continual pilots, TPS carriers).

``transmit(mode, packets)`` runs one stream per row from the
transmitter's start: energy dispersal from the first packet of an
8-packet group, zero outer-interleaver and coder memory, frame 0 of a
superframe.  A hierarchical mode (``alpha`` 1, 2 or 4) carries two
streams, each coded on its own: the high-priority (HP) stream at
``code_rate`` in the quadrant bits, the low-priority (LP) stream at
``code_rate_lp`` in the rest.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

SYMBOLS_PER_FRAME = 68
TS_BYTES, RS_BYTES = 188, 204

# EN 300 744 §4.5.3, continual pilots of the 2K mode; the 8K set is this
# set repeated at carrier offsets 0, 1704, 3408 and 5112.
CONTINUAL_PILOTS_2K = (
    0, 48, 54, 87, 141, 156, 192, 201, 255, 279, 282, 333, 432, 450, 483,
    525, 531, 618, 636, 714, 759, 765, 780, 804, 873, 888, 918, 939, 942,
    969, 984, 1050, 1101, 1107, 1110, 1137, 1140, 1146, 1206, 1269, 1323,
    1377, 1491, 1683, 1704)
# EN 300 744 §4.6, TPS carriers of the 2K mode; 8K repeats them likewise.
TPS_CARRIERS_2K = (
    34, 50, 209, 346, 413, 569, 595, 688, 790, 901, 1073, 1219, 1262, 1286,
    1469, 1594, 1687)

# EN 300 744 Table 3: the transmitted serial order of one puncture period
PUNCTURED = {
    "1/2": "X1 Y1", "2/3": "X1 Y1 Y2", "3/4": "X1 Y1 Y2 X3",
    "5/6": "X1 Y1 Y2 X3 Y4 X5", "7/8": "X1 Y1 Y2 Y3 Y4 X5 Y6 X7",
}
# §4.3.4.1: input bit x_k of a v-bit group goes to sub-stream b_e, e =
# DEMUX[v][k]; each sub-stream's 126-bit block interleaver H_e(w) = (w +
# OFFSETS[e]) mod 126
DEMUX = {2: (0, 1), 4: (0, 2, 1, 3), 6: (0, 2, 4, 1, 3, 5)}
# §4.3.4.1, hierarchical modes: of each cell, the HP stream's bits x'_0,
# x'_1 go to b0, b1 and the LP stream's x''_k to DEMUX_LP[v][k]
DEMUX_HP = (0, 1)
DEMUX_LP = {4: (2, 3), 6: (2, 4, 3, 5)}
OFFSETS = (0, 63, 105, 42, 21, 84)
# §4.3.4.2 bit permutations: (bit of R'_i, bit of R_i) pairs, R'_i from its
# highest bit down, as the standard prints them
_R_PRIME_TO_R = {
    "2k": ((9, 0), (8, 7), (7, 5), (6, 1), (5, 8), (4, 2), (3, 6), (2, 9),
           (1, 3), (0, 4)),
    "8k": ((11, 5), (10, 11), (9, 3), (8, 0), (7, 10), (6, 8), (5, 6),
           (4, 9), (3, 2), (2, 4), (1, 1), (0, 7)),
}
_LFSR_TAPS = {"2k": (0, 3), "8k": (0, 1, 4, 6)}
# §4.6.2 TPS fields
_SYNC_WORD = "0011010111101110"
_TPS_V = {2: "00", 4: "01", 6: "10"}
_TPS_RATE = {"1/2": "000", "2/3": "001", "3/4": "010", "5/6": "011",
             "7/8": "100"}
_TPS_GUARD = {"1/32": "00", "1/16": "01", "1/8": "10", "1/4": "11"}
_TPS_MODE = {"2k": "00", "8k": "01"}
_TPS_HIERARCHY = {0: "000", 1: "001", 2: "010", 4: "011"}
_BITS = {"qpsk": 2, "16qam": 4, "64qam": 6}
_GUARD = {"1/32": 32, "1/16": 16, "1/8": 8, "1/4": 4}
_RATE = {"1/2": (1, 2), "2/3": (2, 3), "3/4": (3, 4), "5/6": (5, 6),
         "7/8": (7, 8)}


@dataclasses.dataclass(frozen=True)
class Mode:
    """One DVB-T mode, as a configuration file states it.  ``alpha`` 0 is
    non-hierarchical, where ``code_rate_lp`` is only what TPS bits
    s33..s35 signal; 1, 2 or 4 is hierarchical, the LP stream coded at
    ``code_rate_lp``."""
    transmission: str
    constellation: str
    code_rate: str
    guard: str
    code_rate_lp: str
    alpha: int = 0

    @property
    def fft_len(self) -> int:
        return 2048 if self.transmission == "2k" else 8192

    @property
    def n_carriers(self) -> int:
        return 1705 if self.transmission == "2k" else 6817

    @property
    def n_data(self) -> int:
        return 1512 if self.transmission == "2k" else 6048

    @property
    def v(self) -> int:
        return _BITS[self.constellation]

    @property
    def guard_len(self) -> int:
        return self.fft_len // _GUARD[self.guard]

    @property
    def symbol_len(self) -> int:
        return self.fft_len + self.guard_len

    @property
    def frame_len(self) -> int:
        return SYMBOLS_PER_FRAME * self.symbol_len

    @property
    def streams(self) -> tuple:
        """(bits a cell, code rate) of each stream, HP first."""
        if not self.alpha:
            return ((self.v, self.code_rate),)
        return ((2, self.code_rate), (self.v - 2, self.code_rate_lp))

    def packets_per_frame(self, stream: int = 0) -> float:
        bits, rate = self.streams[stream]
        num, den = _RATE[rate]
        return self.n_data * bits * SYMBOLS_PER_FRAME * num / den \
            / (8 * RS_BYTES)


def mode_from(config: dict) -> Mode:
    """The reference's mode from a configuration file's ``mode`` group."""
    m = config["mode"]
    alpha = m.get("alpha", 0)
    if alpha not in (0, 1, 2, 4) or (alpha and m["constellation"] == "qpsk"):
        raise ValueError(f"no DVB-T mode has alpha {alpha} with "
                         f"{m['constellation']}")
    return Mode(m["transmission"], m["constellation"], m["code_rate"],
                m["guard"], m["code_rate_lp"], alpha)


# --- §4.3.1 energy dispersal -------------------------------------------------

@functools.lru_cache(maxsize=None)
def dispersal_mask() -> np.ndarray:
    """(8, 188) XOR mask of one 8-packet group: the first sync byte
    inverted, the PRBS 1 + x^14 + x^15 (loaded with 100101010000000) on
    every other byte, clocked but not applied during the other sync
    bytes."""
    reg = [1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0]   # D1 .. D15
    bits = []
    for _ in range(1503 * 8):
        out = reg[13] ^ reg[14]
        bits.append(out)
        reg = [out] + reg[:14]
    prbs = np.packbits(np.array(bits, np.uint8))
    mask = np.zeros(8 * TS_BYTES, np.uint8)
    mask[0] = 0xFF
    for g in range(1, 8 * TS_BYTES):
        mask[g] = 0 if g % TS_BYTES == 0 else prbs[g - 1]
    return mask.reshape(8, TS_BYTES)


# --- §4.3.2 Reed-Solomon (204, 188) ------------------------------------------

@functools.lru_cache(maxsize=None)
def _gf() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GF(256) exp and log tables (p(x) = x^8+x^4+x^3+x^2+1) and the code
    generator g(x) = prod_{i<16} (x + alpha^i), highest power first."""
    exp = np.zeros(255, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D

    def mul(a, b):
        return 0 if a == 0 or b == 0 else int(exp[(log[a] + log[b]) % 255])

    g = [1]
    for i in range(16):
        root = int(exp[i])
        nxt = g + [0]
        for j, c in enumerate(g):
            nxt[j + 1] ^= mul(c, root)
        g = nxt
    return exp, log, np.array(g, np.int64)


def rs_encode(data: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 188) -> (..., 204): the systematic shortened code, the
    16 parity bytes the remainder of m(x) x^16 by g(x)."""
    exp_np, log_np, g_np = _gf()
    dev = data.device
    exp = torch.as_tensor(exp_np, device=dev)
    log = torch.as_tensor(log_np, device=dev)
    log_g = torch.as_tensor(log_np[g_np[1:]], device=dev)      # (16,)
    flat = data.reshape(-1, TS_BYTES).to(torch.int64)
    reg = torch.zeros(flat.shape[0], 16, dtype=torch.int64, device=dev)
    for i in range(TS_BYTES):
        fb = flat[:, i] ^ reg[:, 0]
        prod = exp[(log[fb][:, None] + log_g) % 255]
        prod = torch.where(fb[:, None] == 0, 0, prod)
        reg = torch.cat([reg[:, 1:], torch.zeros_like(reg[:, :1])], 1) ^ prod
    out = torch.cat([flat, reg], 1).to(torch.uint8)
    return out.reshape(*data.shape[:-1], RS_BYTES)


# --- §4.3.1 outer interleaver, §4.3.3 inner code -----------------------------

def outer_interleave(stream: torch.Tensor) -> torch.Tensor:
    """Forney interleaver I = 12, M = 17 from empty branches: byte n leaves
    branch n mod 12, which delays it by 17 * 12 bytes per branch index."""
    n = stream.shape[-1]
    i = torch.arange(n, device=stream.device)
    src = i - (i % 12) * RS_BYTES
    out = stream[..., src.clamp_min(0)]
    return torch.where(src >= 0, out, torch.zeros_like(out))


def unpack_bits(b: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(7, -1, -1, device=b.device, dtype=torch.uint8)
    return ((b[..., None] >> shifts) & 1).reshape(*b.shape[:-1], -1)


def inner_code(bits: torch.Tensor, rate: str) -> torch.Tensor:
    """Mother code G1 = 171o (X), G2 = 133o (Y) from a zero state, then the
    Table 3 puncturing, serialised."""
    n = bits.shape[-1]
    pad = torch.cat([torch.zeros_like(bits[..., :6]), bits], -1)

    def b(j):                      # b_{n-j} for every n
        return pad[..., 6 - j:6 - j + n]

    x = b(0) ^ b(1) ^ b(2) ^ b(3) ^ b(6)
    y = b(0) ^ b(2) ^ b(3) ^ b(5) ^ b(6)
    order = PUNCTURED[rate].split()
    period = max(int(t[1:]) for t in order)
    xs = x.reshape(*x.shape[:-1], n // period, period)
    ys = y.reshape(*y.shape[:-1], n // period, period)
    cols = [(xs if t[0] == "X" else ys)[..., int(t[1:]) - 1] for t in order]
    return torch.stack(cols, -1).reshape(*x.shape[:-1], -1)


# --- §4.3.4 inner interleaving, §4.3.5 mapping -------------------------------

def bit_interleave(coded: tuple, mode: Mode) -> torch.Tensor:
    """Each stream's coded bits (R, S, n_data * bits a cell) of S symbols,
    HP first -> symbol words y'_w (R, S, n_data), y_0 the most
    significant bit."""
    v = mode.v
    demux = (DEMUX_HP, DEMUX_LP[v]) if mode.alpha else (DEMUX[v],)
    w = torch.arange(126, device=coded[0].device)
    words = torch.zeros(coded[0].shape[:-1] + (mode.n_data // 126, 126),
                        dtype=torch.int64, device=coded[0].device)
    for bits, targets in zip(coded, demux, strict=True):
        x = bits.reshape(*bits.shape[:-1], -1, 126, len(targets))
        for k, e in enumerate(targets):
            a = x[..., (w + OFFSETS[e]) % 126, k]      # a_e(w) = b_e(H_e(w))
            words |= a.to(torch.int64) << (v - 1 - e)
    return words.reshape(*coded[0].shape[:-1], mode.n_data)


@functools.lru_cache(maxsize=None)
def symbol_permutation(transmission: str) -> np.ndarray:
    """H(q) of §4.3.4.2."""
    nr = 11 if transmission == "2k" else 13
    m_max, n_max = 1 << nr, (1512 if transmission == "2k" else 6048)
    taps = _LFSR_TAPS[transmission]
    prime = [0] * (nr - 1)                    # R'_i[j], j = 0 .. Nr-2
    h = []
    for i in range(m_max):
        if i < 2:
            prime = [0] * (nr - 1)
        elif i == 2:
            prime = [1] + [0] * (nr - 2)
        else:
            fb = 0
            for t in taps:
                fb ^= prime[t]
            prime = prime[1:] + [fb]
        r = [0] * (nr - 1)
        for src, dst in _R_PRIME_TO_R[transmission]:
            r[dst] = prime[src]
        hq = (i % 2) * (1 << (nr - 1)) + sum(bit << j for j, bit in
                                              enumerate(r))
        if hq < n_max:
            h.append(hq)
    assert len(h) == n_max
    return np.array(h, np.int64)


def symbol_interleave(words: torch.Tensor, mode: Mode) -> torch.Tensor:
    """(R, S, n_data) from symbol 0 of a frame: even symbols y_H(q) =
    y'_q, odd symbols y_q = y'_H(q)."""
    h = torch.as_tensor(symbol_permutation(mode.transmission),
                        device=words.device)
    inv = torch.empty_like(h)
    inv[h] = torch.arange(len(h), device=h.device)
    out = torch.empty_like(words)
    out[:, 0::2] = words[:, 0::2][..., inv]
    out[:, 1::2] = words[:, 1::2][..., h]
    return out


def qam(words: torch.Tensor, v: int, alpha: int = 0) -> torch.Tensor:
    """Gray mapping of Fig. 9: I from y0, y2, y4 and Q from y1, y3, y5;
    y0 / y1 the sign (1: negative), the rest the Gray-coded amplitude;
    normalised to unit mean power.  The non-uniform constellations of
    §4.3.5 (``alpha`` 2, 4) move every amplitude out by alpha - 1, so
    that the quadrants lie 2 alpha apart."""
    def axis(first: int):
        sign = 1.0 - 2.0 * ((words >> (v - 1 - first)) & 1).to(torch.float64)
        m = v // 2 - 1                    # amplitude bits per axis
        g = torch.zeros_like(words)
        acc = torch.zeros_like(words)
        for j in range(m):
            acc = acc ^ ((words >> (v - 1 - (first + 2 * (j + 1)))) & 1)
            g = (g << 1) | acc            # Gray -> binary
        amp = (2 ** (m + 1) - 1) - 2 * g.to(torch.float64)
        return sign * (amp + max(alpha - 1, 0))

    # mean power of the unnormalised points, §4.3.5
    power = {(2, 0): 2.0, (4, 0): 10.0, (6, 0): 42.0, (4, 1): 10.0,
             (4, 2): 20.0, (4, 4): 52.0, (6, 1): 42.0, (6, 2): 60.0,
             (6, 4): 108.0}[v, alpha]
    return torch.complex(axis(0), axis(1)) * power ** -0.5


# --- §4.4-4.6 frame, pilots, TPS, OFDM ---------------------------------------

def _tile(base, transmission: str) -> np.ndarray:
    if transmission == "2k":
        return np.array(base, np.int64)
    return np.unique(np.concatenate(
        [np.array(base) + 1704 * m for m in range(4)]))


@functools.lru_cache(maxsize=None)
def w_k(n: int) -> np.ndarray:
    """The pilot PRBS x^11 + x^2 + 1 from all ones, one bit per carrier."""
    reg = [1] * 11
    out = []
    for _ in range(n):
        out.append(reg[10])
        reg = [reg[10] ^ reg[8]] + reg[:10]
    return np.array(out, np.int64)


def tps_bits(mode: Mode, frame: int) -> np.ndarray:
    """s0 .. s67 of frame ``frame`` (0..3) of a superframe; s0 is 0."""
    sync = _SYNC_WORD if frame % 2 == 0 else "".join(
        "1" if c == "0" else "0" for c in _SYNC_WORD)
    body = (sync + "010111" + f"{frame:02b}" + _TPS_V[mode.v]
            + _TPS_HIERARCHY[mode.alpha] + _TPS_RATE[mode.code_rate]
            + _TPS_RATE[mode.code_rate_lp]
            + _TPS_GUARD[mode.guard] + _TPS_MODE[mode.transmission]
            + "0" * 14)                               # s1 .. s53
    # BCH(67, 53): the remainder of s(x) x^14 by x^14+x^9+x^8+x^6+x^5+
    # x^4+x^2+x+1, s1 the highest power
    gen = [int(c) for c in "100001101110111"]
    rem = [int(c) for c in body] + [0] * 14
    for i in range(len(body)):
        if rem[i]:
            for j, c in enumerate(gen):
                rem[i + j] ^= c
    return np.array([0] + [int(c) for c in body] + rem[-14:], np.int64)


@functools.lru_cache(maxsize=None)
def _frame_layout(mode: Mode):
    """Per symbol of a superframe: the reference value of every carrier
    (0 on data carriers) and the data carriers in ascending order."""
    K = mode.n_carriers
    sign = 1.0 - 2.0 * w_k(K).astype(np.float64)
    cont = _tile(CONTINUAL_PILOTS_2K, mode.transmission)
    cont = cont[cont < K]
    tps = _tile(TPS_CARRIERS_2K, mode.transmission)
    ref = np.zeros((4, SYMBOLS_PER_FRAME, K), np.float64)
    data = np.zeros((4, mode.n_data), np.int64)
    for p in range(4):
        scat = np.arange(3 * p, K, 12)
        pilots = np.union1d(scat, cont)
        free = np.ones(K, bool)
        free[pilots] = False
        free[tps] = False
        data[p] = np.nonzero(free)[0]
        assert len(data[p]) == mode.n_data
        ref[:, p::4, pilots] = 4.0 / 3.0 * sign[pilots]
    for f in range(4):
        s = tps_bits(mode, f)
        dbpsk = np.cumprod(1.0 - 2.0 * s[:SYMBOLS_PER_FRAME])  # s0 = 0
        ref[f][:, tps] = dbpsk[:, None] * sign[tps][None, :]
    return ref, data


def ofdm(carriers: torch.Tensor, mode: Mode,
         precision: str = "float64") -> torch.Tensor:
    """(R, S, K) carriers -> (R, S * symbol_len) samples: carrier k at bin
    (k - Kmax/2) mod N, unitary IFFT, then the last guard_len samples as
    the cyclic prefix.  ``precision="bfloat16"`` is the control: carriers
    and samples rounded to bfloat16, the IFFT in single precision."""
    N, G = mode.fft_len, mode.guard_len
    k = torch.arange(mode.n_carriers, device=carriers.device)
    bins = (k - (mode.n_carriers - 1) // 2) % N
    if precision == "bfloat16":
        carriers = _round_bf16(carriers).to(torch.complex64)
    spec = carriers.new_zeros(*carriers.shape[:-1], N)
    spec[..., bins] = carriers
    x = torch.fft.ifft(spec, dim=-1, norm="ortho")
    x = torch.cat([x[..., N - G:], x], -1).reshape(carriers.shape[0], -1)
    if precision == "bfloat16":
        x = _round_bf16(x)
    return x.to(torch.complex128)


def _round_bf16(z: torch.Tensor) -> torch.Tensor:
    return torch.complex(z.real.to(torch.bfloat16).to(torch.float64),
                         z.imag.to(torch.bfloat16).to(torch.float64))


def _code(packets: torch.Tensor, rate: str) -> torch.Tensor:
    """One stream's TS packets (R, P, 188) -> its coded bits (R, n):
    energy dispersal, RS(204, 188), outer interleaver, inner code."""
    R, P, _ = packets.shape
    dev = packets.device
    mask = torch.as_tensor(dispersal_mask(), device=dev)
    scrambled = packets ^ mask[torch.arange(P, device=dev) % 8]
    stream = outer_interleave(rs_encode(scrambled).reshape(R, -1))
    return inner_code(unpack_bits(stream), rate)


def transmit(mode: Mode, packets, precision: str = "float64") -> torch.Tensor:
    """uint8 TS packets (R, P, 188), P a whole number of frames, or in a
    hierarchical mode the (HP, LP) pair of them over the same frames, ->
    the complex128 baseband (R, frames * frame_len) of each row's
    streams from the transmitter's start."""
    streams = tuple(packets) if mode.alpha else (packets,)
    R = streams[0].shape[0]
    dev = streams[0].device
    per_frame = [mode.packets_per_frame(i) for i in range(len(streams))]
    n_frames = streams[0].shape[1] / per_frame[0]
    if not n_frames.is_integer() or any(
            pk.shape[1] != n_frames * f for pk, f in zip(streams, per_frame)):
        raise ValueError(f"{[pk.shape[1] for pk in streams]} packets are "
                         f"not the same whole frames of {per_frame}")
    n_frames = int(n_frames)
    S = n_frames * SYMBOLS_PER_FRAME
    coded = tuple(_code(pk, rate).reshape(R, S, -1)
                  for pk, (_, rate) in zip(streams, mode.streams))
    words = bit_interleave(coded, mode)
    cells = qam(symbol_interleave(words, mode), mode.v, mode.alpha)
    ref_np, data_np = _frame_layout(mode)
    ref = torch.as_tensor(ref_np, device=dev)        # (4, 68, K)
    data = torch.as_tensor(data_np, device=dev)      # (4, n_data)
    frames = torch.arange(n_frames, device=dev) % 4
    carriers = ref[frames].reshape(S, -1).to(torch.complex128)
    carriers = carriers.expand(R, S, -1).clone()
    sym_phase = torch.arange(S, device=dev) % 4
    idx = data[sym_phase]                             # (S, n_data)
    carriers.scatter_(-1, idx.expand(R, S, -1), cells)
    return ofdm(carriers, mode, precision)
