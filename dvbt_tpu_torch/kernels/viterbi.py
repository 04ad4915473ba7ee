"""K1 and K3 — overlapped-window Viterbi decoders (RX, R7).

K1 (``viterbi_punct``) replaces ``dvbt_tpu/kernels/viterbi_pallas.py::
_vit_punct_kernel`` (built by ``make_viterbi_decoder_punctured``), the
decoder of the receiver's main path.  K3 (``viterbi_depunct``, behind the
``viterbi_decoder`` block's ``make_viterbi_decoder``) replaces
``_viterbi_kernel`` (built by ``make_viterbi_decoder``): the depunctured
streams x, y with per-step masks xm, ym go in, one byte per info bit comes
out, and the carried state is the {x, y, xm, ym} tail of the stream.

K1's contract: the PUNCTURED soft stream
(uint8 0..15; hard decisions as 0/15) and the carried tail go in, decoded
info bytes (MSB-first) come out.  The stream is cut into windows of
``body + 2*overlap`` steps over the extended stream [tail | block | erasure
pad]; window w starts at extended position w*body and keeps the decisions
of its steps [overlap, overlap + body).  Punctured and pad steps add zero
branch metric; the decision is c1 < c0 (ties to the even predecessor); the
traceback starts at the lowest-index minimum state.

The CUDA kernels are in ``csrc/viterbi.cu`` and share their add-compare-
select, decision packing and traceback.  One warp decodes one window, with
no block barrier: lane l owns states l and l + 32 (one butterfly), their
path metrics packed into one 32-bit word of 16-bit halves, fetched from the
predecessors' lanes by two shuffles and compared by one Hopper DPX
``__vibmin_s16x2`` (the decision is c1 < c0), renormalised every 256 steps.
Each lane reads one step of the next 32 with coalesced loads and hands the
step's packed branch metrics to the warp by shuffle, so only the decisions
live in shared memory: two ``__ballot_sync`` words a step (the layout of
``_pack_states``), 8 bytes, ~9 KB a window for K1 at body 1024 and ~34 KB
for K3 at body 4096.  The traceback keeps the path in a shift register
(the state in its low 6 bits, the decoded bits above them) and loads each
step's decision pair at an address that depends only on the step, so its
dependent chain is a shift and a logic operation a step.  What bounds them
on the H100 is the sequential ACS, 13 warp instructions a step, 9 of them
on the integer pipe (~4.5 SM clocks a window-step where the bound allows
1.5): K1 (24 windows resident per SM) is bound so.  K3's decisions
at body 4096 would leave 6 windows per SM, too few to hide the latency of
a step's chain, so they spill to device memory through a 32-step ring,
and K3 runs 40 windows per SM (its registers capped for 5 blocks of 8).
Resident decisions stay where they fit: on the H100 they beat a spill at
24 windows an SM (K1 at the flagship shape by ~2%, the time-sharded
halo's 24 windows by a quarter or more) and lose at 6 (K3 at body 4096,
1.6x).  ``window_geometry`` computes the launch (windows per block, shared
bytes a window, resident or spilled decisions, the blocks per SM it counts
on, the grid) and checks the shared-memory budget; the launcher refuses a
kernel whose registers allow fewer blocks than counted on.

The tail is a (..., 4, overlap) uint8 tensor with rows (x, y, x_known,
y_known) — the ``{x, y, xm, ym}`` state of the JAX package, stacked.  Its
masks are honoured as given (an all-zero tail at stream start is an
erasure), as in the jnp decoder ``dvbt_tpu/ops/viterbi.py``.

Dispatch is by tensor device only: CPU tensors take the plain version, CUDA
tensors the kernel (or an error).  ``_build.launches`` counts K1's
launches as ``viterbi_punct``, K3's as ``viterbi_depunct``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..ops.inner_coder import make_depuncture
from ..utils import puncture
from ..utils.bits import bits_to_bytes
from . import _build

N_STATES = 64
SOFT_MAX = 15

# H100 limits (CUDA programming guide, compute capability 9.0)
SMEM_PER_SM = 228 * 1024       # an SM's shared memory for its blocks
SMEM_PER_BLOCK = 227 * 1024    # the most one block can take
SMEM_BLOCK_RESERVED = 1024     # the runtime's share of each resident block
MAX_BLOCKS_PER_SM = 32
MAX_WARPS_PER_SM = 64
MAX_WARPS_PER_BLOCK = 8        # the kernels' __launch_bounds__(256, ...)
SMEM_STATIC = 4 * MAX_WARPS_PER_BLOCK  # the kernels' __shared__ best[]
# the warps per SM the kernels' registers are capped for, by spill: their
# __launch_bounds__ minimum blocks (kResidentMinBlocks, kSpillMinBlocks)
# times 8 warps
REG_WARPS_PER_SM = {False: 3 * MAX_WARPS_PER_BLOCK,
                    True: 5 * MAX_WARPS_PER_BLOCK}
# Fewer windows than this resident per SM with the decisions in shared
# memory: spill them to device memory instead.  A step's dependent chain
# (~40 clocks) over its issue (~4.5 clocks a window-step) needs ~9 windows
# an SM; measured on the H100, resident wins at 24 and loses at 6 (the
# port's shapes give one or the other), and 12 leaves a margin over 9.
SPILL_BELOW = 12


@dataclasses.dataclass(frozen=True)
class WindowGeometry:
    """The launch of K1 or K3: one warp per window, ``warps`` windows a
    block.  The traceback reads the decisions of steps overlap + 6 .. L-1;
    a window keeps the pair (8 bytes) of each step from ``skip`` (overlap
    + 6 rounded down to 32) on, in its shared memory or, when ``spill``,
    in device memory through a 32-step ring in shared memory; then its
    body's bits, packed 32 to a word."""
    n_win: int          # windows per mux
    skip: int
    spill: bool
    window_bytes: int   # shared bytes of one window, 8 mod 128
    warps: int          # windows (warps) per block
    grid: int           # blocks
    resident: int       # windows per SM that shared memory allows

    blocks_per_sm: int  # = resident // warps, checked by the launcher

    def scratch_bytes(self, n_mux: int, body: int, overlap: int) -> int:
        """Device memory for the spilled decisions (0 if resident)."""
        steps = body + 2 * overlap - self.skip
        return 8 * n_mux * self.n_win * steps if self.spill else 0


def window_geometry(n_mux: int, n_bits: int, body: int,
                    overlap: int) -> WindowGeometry:
    """Geometry of the decode of n_mux streams of n_bits steps in windows
    of body + 2*overlap steps.  Windows per block are chosen for the most
    windows resident on an SM, by shared memory, warps and the kernels'
    register cap, then the most a block (one warp traces back all of a
    block's windows).  The decisions stay in shared memory unless that
    leaves fewer than SPILL_BELOW windows resident per SM."""
    if n_bits <= 0 or body <= 0 or overlap < 5:
        raise ValueError(f"n_bits={n_bits}, body={body}, overlap={overlap}: "
                         "the kernels take overlap >= 5 (their traceback "
                         "reads a body word 5 steps after its first step)")
    n_win = -(-n_bits // body)
    skip = (overlap + 6) // 32 * 32
    words = 4 * -(-body // 32)

    def window_bytes(spilled):
        # 8 mod 128: the traceback's lanes read one step of each window
        # of the block, and this stride puts them in different banks
        steps = 32 if spilled else body + 2 * overlap - skip
        need = 8 * steps + words
        return need + (8 - need) % 128

    def resident(w, wb, spilled):
        per_block = w * wb + SMEM_STATIC
        if per_block > SMEM_PER_BLOCK:
            return 0
        return w * min(SMEM_PER_SM // (per_block + SMEM_BLOCK_RESERVED),
                       MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM // w,
                       REG_WARPS_PER_SM[spilled] // w)

    def best(spilled):
        wb = window_bytes(spilled)
        w = max(range(1, MAX_WARPS_PER_BLOCK + 1),
                key=lambda w: (resident(w, wb, spilled), w))
        return wb, w, resident(w, wb, spilled)

    wb, warps, res = best(False)
    spill = res < SPILL_BELOW
    if spill:
        wb, warps, res = best(True)
    if res == 0:
        raise ValueError(f"window {body}+2*{overlap} needs {wb} shared "
                         f"bytes, over the {SMEM_PER_BLOCK} a block can take")
    return WindowGeometry(n_win, skip, spill, wb, warps,
                          -(-n_mux * n_win // warps), res, res // warps)


def punct_geometry(rate: str, body: int, overlap: int) -> tuple[int, int]:
    """The (body, overlap) that the JAX package's Pallas decoder derives
    from a requested pair (``viterbi_pallas.punct_geometry``): both rounded
    up to lcm(8, period), then body grown until body + 2*overlap is a
    multiple of its forward-iteration width and of 64.  Decoding at this
    geometry reproduces the Pallas decoder's output bytes."""
    period, _, _, _, align = puncture.pattern(rate)
    ov = -(-overlap // align) * align
    width = 32 * period if period % 2 else 32
    width = width * 64 // math.gcd(width, 64)
    b = -(-body // align) * align
    while (b + 2 * ov) % width:
        b += align
    return b, ov


@functools.lru_cache(maxsize=None)
def _trellis_parity() -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Per new state s: outputs (x, y) of the edge from its d=0 predecessor,
    the parities of (s << 1) & G1 and (s << 1) & G2."""
    def par(v):
        return bin(v).count("1") & 1
    px = tuple(par((s << 1) & 0o171) for s in range(N_STATES))
    py = tuple(par((s << 1) & 0o133) for s in range(N_STATES))
    return px, py


def _windows(steps, tail, n_bits, body):
    """Stage every window's steps: (x, y, xm, ym) int32 (B, L) each, B =
    windows of all leading indices, from the four (..., n_bits) step
    streams over [tail | block | erasure pad]: the steps that the kernels'
    lanes read, 32 at a time, for each window."""
    ov = tail.shape[-1]
    dev = tail.device
    lead = tail.shape[:-2]
    n_win = -(-n_bits // body)
    L = body + 2 * ov
    pad = torch.zeros(*lead, n_win * body + ov - n_bits, dtype=torch.uint8,
                      device=dev)              # erasures after the block
    widx = (torch.arange(n_win, device=dev)[:, None] * body
            + torch.arange(L, device=dev)[None, :]).reshape(-1)
    return [torch.cat([tail[..., k, :], s, pad], dim=-1).index_select(
        -1, widx).reshape(-1, L).to(torch.int32) for k, s in enumerate(steps)]


def _decode_windows(wx, wy, wxm, wym, ov, body):
    """Add-compare-select and traceback of every window, as the kernels do
    it: (B, L) int32 staged steps -> (B, body) uint8 bits of the body
    steps [ov, ov + body)."""
    B, L = wx.shape
    dev = wx.device
    px_t, py_t = _trellis_parity()
    px = torch.tensor(px_t, dtype=torch.int32, device=dev)
    py = torch.tensor(py_t, dtype=torch.int32, device=dev)
    byte_w = (1 << torch.arange(8, dtype=torch.int32, device=dev))

    pm = torch.zeros(B, N_STATES, dtype=torch.int32, device=dev)
    # decisions, bit s%8 of byte s//8 = decision of state s
    dec = torch.empty(L, B, 8, dtype=torch.uint8, device=dev)
    for t in range(L):
        sx, sy = wx[:, t:t + 1], wy[:, t:t + 1]
        mx, my = wxm[:, t:t + 1], wym[:, t:t + 1]
        bm0 = (mx * (sx + px * (SOFT_MAX - 2 * sx))
               + my * (sy + py * (SOFT_MAX - 2 * sy)))
        bm1 = SOFT_MAX * (mx + my) - bm0
        A = pm.view(B, 32, 2)
        c0 = A[:, :, 0].repeat(1, 2) + bm0     # pred 2*(s & 31)
        c1 = A[:, :, 1].repeat(1, 2) + bm1     # pred 2*(s & 31) + 1
        d = c1 < c0
        pm = torch.where(d, c1, c0)
        dec[t] = (d.view(B, 8, 8).to(torch.int32) * byte_w).sum(-1).to(
            torch.uint8)

    st = torch.argmin(pm, dim=-1)              # first (lowest) minimum
    rows = torch.arange(B, device=dev)
    bits = torch.empty(B, body, dtype=torch.uint8, device=dev)
    for t in range(L - 1, ov - 1, -1):
        if t < ov + body:
            bits[:, t - ov] = (st >> 5).to(torch.uint8)
        byte = dec[t, rows, st >> 3].to(torch.int64)
        st = ((st & 31) << 1) | ((byte >> (st & 7)) & 1)
    return bits


def _scratch(geo: WindowGeometry, n_mux: int, body: int, ov: int, device):
    """Device memory for spilled decisions, or None."""
    n = geo.scratch_bytes(n_mux, body, ov)
    return torch.empty(n, dtype=torch.uint8, device=device) if n else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def viterbi_punct_plain(coded: torch.Tensor, tail: torch.Tensor, n_bits: int,
                        rate: str, body: int) -> torch.Tensor:
    """coded (..., n_c) uint8, tail (..., 4, overlap) uint8 ->
    info bytes (..., n_bits // 8) uint8."""
    ov = tail.shape[-1]
    n_win = -(-n_bits // body)
    steps = make_depuncture(n_bits, rate)(coded)
    bits = _decode_windows(*_windows(steps, tail, n_bits, body), ov, body)
    return bits_to_bytes(
        bits.reshape(*coded.shape[:-1], n_win * body)[..., :n_bits])


def viterbi_punct(coded: torch.Tensor, tail: torch.Tensor, n_bits: int,
                  rate: str, body: int) -> torch.Tensor:
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    if coded.device.type == "cpu":
        return viterbi_punct_plain(coded, tail, n_bits, rate, body)
    period, keep, _, rank, _ = puncture.pattern(rate)
    ov = tail.shape[-1]
    n_c = n_bits // period * keep
    if coded.device.type != "cuda" or tail.device != coded.device:
        raise ValueError(f"viterbi_punct: coded on {coded.device}, tail on "
                         f"{tail.device}; the kernel takes CUDA tensors")
    if coded.dtype != torch.uint8 or tail.dtype != torch.uint8:
        raise TypeError("viterbi_punct: coded and tail must be uint8")
    if not (coded.is_contiguous() and tail.is_contiguous()):
        raise ValueError("viterbi_punct: coded and tail must be contiguous")
    if (n_bits % period or n_bits % 8 or body % 8 or body <= 0
            or coded.shape[-1] != n_c
            or tail.shape != coded.shape[:-1] + (4, ov)):
        raise ValueError(
            f"viterbi_punct: coded {tuple(coded.shape)} / tail "
            f"{tuple(tail.shape)} do not fit n_bits={n_bits} rate={rate} "
            f"body={body}")
    if n_bits + body + 2 * ov >= 2 ** 31:
        raise ValueError(f"viterbi_punct: n_bits={n_bits} is past the "
                         "kernel's int32 positions")
    n_mux = coded.numel() // n_c
    geo = window_geometry(n_mux, n_bits, body, ov)
    out = torch.empty(coded.shape[:-1] + (n_bits // 8,), dtype=torch.uint8,
                      device=coded.device)
    rank_packed = sum((r + 1) << (4 * i) for i, r in enumerate(rank))
    lib = _build.library()
    scratch = _scratch(geo, n_mux, body, ov, coded.device)
    code = lib.dvbt_viterbi_punct(
        coded.data_ptr(), tail.data_ptr(), out.data_ptr(), n_mux, n_c,
        n_bits, body, ov, period, keep, rank_packed, geo.grid, geo.warps,
        geo.window_bytes, geo.skip, geo.blocks_per_sm, _ptr(scratch),
        torch.cuda.current_stream(coded.device).cuda_stream)
    _build.check(code, "dvbt_viterbi_punct", kernel="viterbi_punct")
    return out


# --- K3: the depunctured decoder of the viterbi_decoder block -------------

DEFAULT_BODY = 4096
DEFAULT_OVERLAP = 128
_LANES = 128
_STEPS = ("x", "y", "xm", "ym")


def auto_body(n_bits: int) -> int:
    """The JAX package's window body for n_bits (``viterbi_pallas.
    auto_body``): ~127 windows to a 128-lane block, capped at 4096 and at
    least 256, a multiple of 32.  K3 keeps it, so the block returns the JAX
    block's bytes under noise; a body chosen for the H100 is open work."""
    cand = -(-(-(-n_bits // (_LANES - 1))) // 32) * 32
    return int(min(DEFAULT_BODY, max(256, cand)))


def init_state(n_mux: int, device, overlap: int = DEFAULT_OVERLAP) -> dict:
    """All-zero {x, y, xm, ym} (n_mux, overlap) tails: an erasure warm-up."""
    return {k: torch.zeros(n_mux, overlap, dtype=torch.uint8, device=device)
            for k in _STEPS}


def viterbi_depunct_plain(x: torch.Tensor, y: torch.Tensor, xm: torch.Tensor,
                          ym: torch.Tensor, tail: torch.Tensor,
                          body: int) -> torch.Tensor:
    """x, y, xm, ym (..., n_bits) uint8, tail (..., 4, overlap) uint8 ->
    bits (..., n_bits) uint8 {0, 1}."""
    n_bits = x.shape[-1]
    ov = tail.shape[-1]
    n_win = -(-n_bits // body)
    bits = _decode_windows(*_windows((x, y, xm, ym), tail, n_bits, body), ov,
                           body)
    return bits.reshape(*x.shape[:-1], n_win * body)[..., :n_bits]


def viterbi_depunct(x: torch.Tensor, y: torch.Tensor, xm: torch.Tensor,
                    ym: torch.Tensor, tail: torch.Tensor,
                    body: int) -> torch.Tensor:
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    steps = (x, y, xm, ym)
    if x.device.type == "cpu":
        return viterbi_depunct_plain(x, y, xm, ym, tail, body)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (*steps, tail)):
        raise ValueError("viterbi_depunct: x, y, xm, ym and tail must lie "
                         "on one CUDA device; the kernel takes CUDA tensors")
    if any(t.dtype != torch.uint8 for t in (*steps, tail)):
        raise TypeError("viterbi_depunct: x, y, xm, ym and tail must be uint8")
    if not all(t.is_contiguous() for t in (*steps, tail)):
        raise ValueError("viterbi_depunct: x, y, xm, ym and tail must be "
                         "contiguous")
    ov = tail.shape[-1]
    if (any(t.shape != x.shape for t in steps) or x.dim() < 1
            or tail.shape != x.shape[:-1] + (4, ov) or body <= 0):
        raise ValueError(
            f"viterbi_depunct: x/y/xm/ym {[tuple(t.shape) for t in steps]} "
            f"/ tail {tuple(tail.shape)} / body {body} do not fit")
    n_bits = x.shape[-1]
    if n_bits + body + 2 * ov >= 2 ** 31:
        raise ValueError(f"viterbi_depunct: n_bits={n_bits} is past the "
                         "kernel's int32 positions")
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    n_mux = x.numel() // n_bits
    geo = window_geometry(n_mux, n_bits, body, ov)
    lib = _build.library()
    scratch = _scratch(geo, n_mux, body, ov, x.device)
    code = lib.dvbt_viterbi_depunct(
        x.data_ptr(), y.data_ptr(), xm.data_ptr(), ym.data_ptr(),
        tail.data_ptr(), out.data_ptr(), n_mux, n_bits, body, ov, geo.grid,
        geo.warps, geo.window_bytes, geo.skip, geo.blocks_per_sm,
        _ptr(scratch), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "dvbt_viterbi_depunct", kernel="viterbi_depunct")
    return out


def make_viterbi_decoder(n_bits: int, body: int | None = None,
                         overlap: int = DEFAULT_OVERLAP):
    """The ``viterbi_decoder`` block.  Returns decode(state, x, y, xm, ym)
    -> (state', bits), the contract of ``viterbi_pallas.
    make_viterbi_decoder`` with a leading mux axis:

    x, y   : uint8 (n_mux, n_bits) soft mother-code values 0..15;
    xm, ym : uint8 (n_mux, n_bits) 1 where the bit was sent;
    state  : {'x','y','xm','ym'} uint8 (n_mux, overlap), the last
             ``overlap`` steps of the stream so far (all zero at stream
             start: erasures, as the masks say);
    bits   : uint8 (n_mux, n_bits) decoded info bits {0, 1}.

    Windows of ``body + 2*overlap`` steps start every ``body`` steps over
    [state | block | erasure pad]; window w keeps its steps [overlap,
    overlap + body).  The work is kernel K3 (``viterbi_depunct``)."""
    body = auto_body(n_bits) if body is None else body
    if body <= 0 or overlap <= 0:
        raise ValueError(f"body={body}, overlap={overlap} must be positive")

    def decode(state: dict, x, y, xm, ym):
        steps = (x, y, xm, ym)
        tail = torch.stack([state[k] for k in _STEPS], dim=-2)
        bits = viterbi_depunct(*steps, tail, body)
        new_state = {k: torch.cat([state[k], v], dim=-1)[
            ..., n_bits:n_bits + overlap] for k, v in zip(_STEPS, steps)}
        return new_state, bits

    return decode
