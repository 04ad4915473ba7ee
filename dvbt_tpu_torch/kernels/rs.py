"""RS(204,188,T=8) decode (R9): the CUDA kernel and its plain version.

Replaces no TPU kernel: the JAX package decodes with bit-sliced GF(2)
algebra that XLA fuses.  The plain version below, the port's decoder
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

Dispatch is by tensor device only: CPU tensors take the plain version, CUDA
tensors the kernel (or an error).  ``launches`` counts kernel launches.
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

launches = 0


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


def decoder_tables(device) -> torch.Tensor:
    """The kernel's tables, uint8 (TABLE_BYTES,) on ``device``.  Make them
    before a CUDA graph captures the decode: this copies host data."""
    exp, log = tables.gf_tables()
    g = tables.rs_generator_poly()                  # x^16's first
    feedback = _gf_mul_np(np.arange(256)[:, None], g[None, 1:])
    exp_z = np.zeros(1024, np.uint8)
    exp_z[:LOG_ZERO] = exp[:LOG_ZERO]
    log_z = log.astype("<u2")
    log_z[0] = LOG_ZERO
    blob = np.concatenate([feedback.reshape(-1), exp_z, log_z.view(np.uint8)])
    return torch.as_tensor(blob, device=device)


def rs_decode(cw: torch.Tensor, lut: torch.Tensor | None = None):
    """RS decode of uint8 (..., 204) codewords -> (msg uint8 (..., 188),
    n_corrected int32 (...), uncorrectable bool (...)): the kernel on CUDA
    tensors (``lut``: ``decoder_tables`` on the same device), the
    plain version on CPU tensors."""
    if cw.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rs_decode: codewords on {cw.device}; the decoder "
                         "takes CPU or CUDA tensors")
    if cw.dtype != torch.uint8:
        raise TypeError(f"rs_decode: codewords must be uint8, not {cw.dtype}")
    if not cw.is_contiguous():
        raise ValueError("rs_decode: codewords must be contiguous")
    if cw.dim() == 0 or cw.shape[-1] != RS_N:
        raise ValueError(f"rs_decode: codewords {tuple(cw.shape)} are not "
                         f"(..., {RS_N})")
    if cw.device.type == "cpu":
        return _plain_decoder(cw.device)(cw)
    if lut is None or lut.device != cw.device \
            or lut.numel() != TABLE_BYTES or lut.data_ptr() % 16:
        raise ValueError(f"rs_decode: the kernel needs decoder_tables on "
                         f"{cw.device}")
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
    _build.check(code, "dvbt_rs_decode")
    global launches
    launches += 1
    return msg, n_corr, bad
