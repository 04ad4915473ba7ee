"""RS(204,188,T=8) decode (R9) and systematic encode (T2): the CUDA
kernels and their plain versions.

Replaces no TPU kernel: the JAX package decodes and encodes with bit-sliced
GF(2) algebra that XLA fuses.  The plain decoder below, the port's decoder
until the kernel, is GF(2^8) log/exp table gathers on int64 tensors:

* syndromes are GF(2)-linear in the input bytes: one gather from a
  (position, byte value) -> 16-byte product table followed by an XOR
  reduction over the positions;
* Berlekamp-Massey runs its fixed 16 iterations batched over codewords,
  exactly as the reference formulation (same carried x^m*B, same growth
  rule), so the locator and its degree L match bit for bit;
* Chien search and Forney's formula evaluate over all 204 positions.

``n_corrected`` counts the Chien roots over the 204 positions and
``uncorrectable = ~no_err & ((n_roots != L) | (L > 8))``, as the reference.
On the card that formulation is ~1,200 small launches a call, and its
gathers took half the head-end step.  The kernel (``csrc/rs.cu``) decodes
each codeword end to end in one thread of one launch: the remainder
modulo g(x) decides the no-error case, any other packet runs the same
algebra in registers and shared memory, to the same bytes, counts and
flags, uncorrectable packets included.  It is bound by its 392 bytes of
HBM traffic a packet.

The plain encoder uses the syndromes' linearity the same way: parity is
one gather from a (position, byte value) table of rem(x^(203-p) mod g)
rows and an XOR reduction, then the message and parity are joined.  Its
kernel divides m(x) * x^16 by g(x) in one thread a packet with the
decoder's LFSR and table rows, in one launch, to the same bytes.

Dispatch is by tensor device only: CPU tensors take the plain versions,
CUDA tensors the kernels (or an error).  ``_build.launches`` counts
their launches as ``rs_decode`` and ``rs_encode``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from . import _build

RS_N, RS_K, RS_T = tables.RS_N, tables.RS_K, tables.RS_T
RS_2T = 2 * RS_T
# the kernel's tables (csrc/rs.cu): row f of f * g(x)'s 16 low coefficients
# (x^15's first), exp (alpha^i below 510, 0 from there), log (uint16, log 0
# = 510, so that a product with a zero factor reads 0)
LOG_ZERO = 510
TABLE_BYTES = 256 * RS_2T + 1024 + 256 * 2


def _gf_mul_np(a, b) -> np.ndarray:
    return tables.gf_mul(a, b).astype(np.uint8)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR over one dimension by pairwise folding (zero-padded to 2^k)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], p - n)], dim=-1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def _linear_table(rows: np.ndarray) -> np.ndarray:
    """rows (n_pos, 16) GF coefficients -> (n_pos * 256, 16) uint8 table of
    byte value v times each row, indexed by pos * 256 + v."""
    v = np.arange(256)
    t = _gf_mul_np(v[None, :, None], rows[:, None, :])
    return t.reshape(-1, rows.shape[1])


def _linear_map(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x uint8 (..., n_pos) -> XOR_p table[p*256 + x_p] : (..., 16)."""
    n_pos = x.shape[-1]
    base = torch.arange(n_pos, device=x.device) * 256
    idx = x.to(torch.int64) + base
    return _xor_reduce(table[idx], dim=-2)


class _GF:
    """GF(2^8) arithmetic on int64 tensors through log/exp tables."""

    def __init__(self, device):
        exp, log = tables.gf_tables()
        self.exp = torch.as_tensor(exp[:510].astype(np.int64), device=device)
        self.log = torch.as_tensor(log.astype(np.int64), device=device)

    def mul(self, a, b):
        out = self.exp[self.log[a] + self.log[b]]
        return torch.where((a == 0) | (b == 0), 0, out)

    def mul_pow(self, a, e):
        """a * alpha^e for an exponent tensor e in [0, 255)."""
        return torch.where(a == 0, 0, self.exp[self.log[a] + e])

    def inv(self, a):
        """a^-1, with 0 -> 0 (callers mask it out)."""
        return torch.where(a == 0, 0, self.exp[(255 - self.log[a]) % 255])


def make_rs_encoder_plain(device):
    """Returns encode(msg): uint8 (..., 188) -> (..., 204) systematic."""
    g = tables.rs_generator_poly()
    # parity = XOR_p msg_p * rem(x^(203-p) mod g), coefficients high-first
    rem = np.zeros((RS_N, RS_2T), np.int64)
    cur = np.zeros(RS_2T, np.int64)
    cur[-1] = 1                                      # x^0
    for d in range(RS_N):
        rem[d] = cur
        lead = cur[0]                                # multiply by x
        cur = np.concatenate([cur[1:], [0]])
        if lead:
            cur = cur ^ tables.gf_mul(g[1:], lead)
    table = torch.as_tensor(_linear_table(rem[RS_N - 1 - np.arange(RS_K)]),
                            device=device)

    def encode(msg: torch.Tensor) -> torch.Tensor:
        return torch.cat([msg, _linear_map(msg, table)], dim=-1)

    return encode


def make_rs_decoder_plain(device):
    """Returns decode(cw): uint8 (..., 204) ->
    (msg uint8 (..., 188), n_corrected int32 (...,), uncorrectable bool)."""
    exp, _ = tables.gf_tables()
    deg = RS_N - 1 - np.arange(RS_N)                 # X_i = alpha^deg_i
    syn_rows = exp[(np.arange(RS_2T)[None, :] * deg[:, None]) % 255]
    syn_table = torch.as_tensor(_linear_table(syn_rows), device=device)
    gf = _GF(device)
    # exponents of X_i^-k over the 204 positions
    neg = torch.as_tensor((-deg[:, None] * np.arange(RS_T + 1)[None, :])
                          % 255, device=device)      # (204, 9)
    neg2 = torch.as_tensor((-deg[:, None] * 2 * np.arange(4)[None, :])
                           % 255, device=device)     # (204, 4)
    xk = torch.as_tensor(deg % 255, device=device)   # log X_i

    def berlekamp_massey(S):
        """S int64 (B, 16) -> (Lambda (B, 9), L (B,))."""
        B = S.shape[0]
        C = torch.zeros(B, RS_T + 1, dtype=torch.int64, device=S.device)
        C[:, 0] = 1
        Bm = torch.zeros_like(C)
        Bm[:, 1] = 1                                  # x * B, B = 1
        binv = torch.ones(B, dtype=torch.int64, device=S.device)
        L = torch.zeros(B, dtype=torch.int64, device=S.device)
        Spad = torch.cat([torch.zeros_like(S[:, :RS_T]), S], dim=-1)
        for n in range(RS_2T):
            win = Spad[:, n:n + RS_T + 1]            # S_{n-8} .. S_n
            d = _xor_reduce(gf.mul(C.flip(-1), win), dim=-1)
            coef = gf.mul(d, binv)
            Cn = C ^ gf.mul(coef[:, None], Bm)
            d_zero = d == 0
            grow = (~d_zero) & (2 * L <= n)
            C_out = torch.where(d_zero[:, None], C, Cn)
            nb = torch.where(grow[:, None], C, Bm)
            Bm = torch.cat([torch.zeros_like(nb[:, :1]), nb[:, :-1]], dim=-1)
            binv = torch.where(grow, gf.inv(d), binv)
            L = torch.where(grow, n + 1 - L, L)
            C = C_out
        return C, L

    def decode(cw: torch.Tensor):
        lead = cw.shape[:-1]
        flat = cw.reshape(-1, RS_N)
        S = _linear_map(flat, syn_table).to(torch.int64)       # (B, 16)
        no_err = (S == 0).all(dim=-1)
        Lam, L = berlekamp_massey(S)
        # Omega = S(x) Lambda(x) mod x^8
        om = torch.zeros_like(S[:, :RS_T])
        for i in range(RS_T + 1):
            shifted = torch.cat([torch.zeros_like(S[:, :i]),
                                 S[:, :RS_T - i]], dim=-1)
            om = om ^ gf.mul(Lam[:, i:i + 1], shifted)
        lam_at = torch.zeros(flat.shape[0], RS_N, dtype=torch.int64,
                             device=cw.device)
        for k in range(RS_T + 1):                    # Lambda(X_i^-1)
            lam_at = lam_at ^ gf.mul_pow(Lam[:, k:k + 1], neg[:, k])
        xom_at = torch.zeros_like(lam_at)
        for k in range(RS_T):                        # X_i * Omega(X_i^-1)
            xom_at = xom_at ^ gf.mul_pow(om[:, k:k + 1],
                                         (neg[:, k] + xk) % 255)
        dl_at = torch.zeros_like(lam_at)
        for k in range(4):                           # Lambda'(X_i^-1)
            dl_at = dl_at ^ gf.mul_pow(Lam[:, 2 * k + 1:2 * k + 2],
                                       neg2[:, k])
        err_mask = lam_at == 0                       # Chien roots
        ev = gf.mul(xom_at, gf.inv(dl_at))           # Forney
        ev = torch.where(err_mask & (dl_at != 0), ev, 0)
        corrected = torch.where(no_err[:, None], flat.to(torch.int64),
                                flat.to(torch.int64) ^ ev)
        n_roots = err_mask.sum(dim=-1)
        n_corr = torch.where(no_err, 0, n_roots).to(torch.int32)
        bad = (~no_err) & ((n_roots != L) | (L > RS_T))
        return (corrected[:, :RS_K].to(torch.uint8).reshape(*lead, RS_K),
                n_corr.reshape(lead), bad.reshape(lead))

    return decode


_plain_decoder = functools.lru_cache(maxsize=None)(make_rs_decoder_plain)
_plain_encoder = functools.lru_cache(maxsize=None)(make_rs_encoder_plain)


def decoder_tables(device) -> torch.Tensor:
    """The kernels' tables, uint8 (TABLE_BYTES,) on ``device`` (the encoder
    reads the f * g(x) rows, the first 4,096 bytes).  Make them before a
    CUDA graph captures the decode or encode: this copies host data."""
    exp, log = tables.gf_tables()
    g = tables.rs_generator_poly()                  # x^16's first
    feedback = _gf_mul_np(np.arange(256)[:, None], g[None, 1:])
    exp_z = np.zeros(1024, np.uint8)
    exp_z[:LOG_ZERO] = exp[:LOG_ZERO]
    log_z = log.astype("<u2")
    log_z[0] = LOG_ZERO
    blob = np.concatenate([feedback.reshape(-1), exp_z, log_z.view(np.uint8)])
    return torch.as_tensor(blob, device=device)


def _check_input(name: str, what: str, x: torch.Tensor, n: int,
                 lut: torch.Tensor | None) -> None:
    """Raise unless x is a contiguous uint8 (..., n) CPU or CUDA tensor and,
    on CUDA, lut is decoder_tables on its device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: {what} on {x.device}; the kernel's wrapper "
                         "takes CPU or CUDA tensors")
    if x.dtype != torch.uint8:
        raise TypeError(f"{name}: {what} must be uint8, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if x.dim() == 0 or x.shape[-1] != n:
        raise ValueError(f"{name}: {what} {tuple(x.shape)} are not "
                         f"(..., {n})")
    if x.device.type == "cuda" and (
            lut is None or lut.device != x.device
            or lut.numel() != TABLE_BYTES or lut.data_ptr() % 16):
        raise ValueError(f"{name}: the kernel needs decoder_tables on "
                         f"{x.device}")


def rs_decode(cw: torch.Tensor, lut: torch.Tensor | None = None):
    """RS decode of uint8 (..., 204) codewords -> (msg uint8 (..., 188),
    n_corrected int32 (...), uncorrectable bool (...)): the kernel on CUDA
    tensors (``lut``: ``decoder_tables`` on the same device), the
    plain version on CPU tensors."""
    _check_input("rs_decode", "codewords", cw, RS_N, lut)
    if cw.device.type == "cpu":
        return _plain_decoder(cw.device)(cw)
    lead = cw.shape[:-1]
    msg = torch.empty(lead + (RS_K,), dtype=torch.uint8, device=cw.device)
    n_corr = torch.empty(lead, dtype=torch.int32, device=cw.device)
    bad = torch.empty(lead, dtype=torch.bool, device=cw.device)
    n_packets = cw.numel() // RS_N
    if n_packets == 0:
        return msg, n_corr, bad
    code = _build.library().dvbt_rs_decode(
        cw.data_ptr(), lut.data_ptr(), msg.data_ptr(), n_corr.data_ptr(),
        bad.data_ptr(), n_packets,
        torch.cuda.current_stream(cw.device).cuda_stream)
    _build.check(code, "dvbt_rs_decode", kernel="rs_decode")
    return msg, n_corr, bad


def rs_encode(msg: torch.Tensor, lut: torch.Tensor | None = None):
    """RS systematic encode of uint8 (..., 188) messages -> codewords uint8
    (..., 204), message then parity: the kernel on CUDA tensors (``lut``:
    ``decoder_tables`` on the same device), the plain version on CPU
    tensors."""
    _check_input("rs_encode", "messages", msg, RS_K, lut)
    if msg.device.type == "cpu":
        return _plain_encoder(msg.device)(msg)
    cw = torch.empty(msg.shape[:-1] + (RS_N,), dtype=torch.uint8,
                     device=msg.device)
    n_packets = msg.numel() // RS_K
    if n_packets == 0:
        return cw
    code = _build.library().dvbt_rs_encode(
        msg.data_ptr(), lut.data_ptr(), cw.data_ptr(), n_packets,
        torch.cuda.current_stream(msg.device).cuda_stream)
    _build.check(code, "dvbt_rs_encode", kernel="rs_encode")
    return cw
