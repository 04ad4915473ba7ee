"""TPS-driven mode detection: a receiver told only 2K or 8K.

Counterpart of dvbt_tpu/models/auto.py.  The FFT size is physical and
must be assumed; everything else is found:

1. the guard interval, by the normalised, symbol-folded CP correlation at
   each of the four candidate guard lengths (a wrong period smears under
   folding, a wrong window dilutes the normalised peak);
2. constellation, hierarchy alpha and HP/LP code rates, decoded from the
   TPS bits of one synchronised frame and checked against their
   BCH(67,53) parity [EN300744 §4.6];
3. the rest through the ordinary StreamingReceiver of the detected mode.

The detection math runs on the given device; only the decisions run on
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..mode import GUARDS, SYMBOLS_PER_FRAME, DvbtMode
from ..ops import ofdm, reference_signals
from ..ops import sync as syncop
from .loopback import StreamingReceiver, StreamReport

#: TPS field decodings [EN300744 §4.6.2]
_TPS_CONSTELLATION = {(0, 0): "qpsk", (0, 1): "16qam", (1, 0): "64qam"}
_TPS_ALPHA = {(0, 0, 0): 0, (0, 0, 1): 1, (0, 1, 0): 2, (0, 1, 1): 4}
_TPS_RATE = {(0, 0, 0): "1/2", (0, 0, 1): "2/3", (0, 1, 0): "3/4",
             (0, 1, 1): "5/6", (1, 0, 0): "7/8"}
_TPS_GUARD = {(0, 0): "1/32", (0, 1): "1/16", (1, 0): "1/8", (1, 1): "1/4"}
_TPS_MODE = {(0, 0): "2k", (0, 1): "8k"}


class DetectionError(ValueError):
    """Raised when the capture does not contain a decodable DVB-T signal."""


def _make_guard_scorer(fft_len: int, guard_len: int, n_samples: int):
    """Normalised folded CP-correlation peak for one guard hypothesis.

    Returns score(iq complex64 (n_samples,)) -> float32 0-d tensor in
    [0, 1]: |sum_folds gamma| / sum_folds phi at the best timing offset.
    The right guard gives a plateau near 1, a wrong one markedly less.
    The running sums are complex64 and float32, as in the JAX package."""
    N, G = fft_len, guard_len
    L = N + G
    n_folds = (n_samples - N - G) // L
    if n_folds < 2:
        raise DetectionError("capture too short for guard detection")

    def score(iq: torch.Tensor) -> torch.Tensor:
        a, b = iq[: n_samples - N], iq[N:]
        prod = a * b.conj()
        eng = (a.abs() ** 2 + b.abs() ** 2) * 0.5
        cs = torch.nn.functional.pad(torch.cumsum(prod, 0), (1, 0))
        ce = torch.nn.functional.pad(torch.cumsum(eng, 0), (1, 0))
        gamma = cs[G:] - cs[:-G]
        phi = ce[G:] - ce[:-G]
        usable = n_folds * L
        g = gamma[:usable].reshape(n_folds, L).sum(0)
        p = phi[:usable].reshape(n_folds, L).sum(0)
        return (g.abs() / p.clamp_min(1e-12)).max().to(torch.float32)

    return score


def detect_guard(samples: np.ndarray, transmission: str, device,
                 n_symbols: int = 16) -> tuple[str, dict]:
    """Detect the guard interval from a raw capture.

    Uses the first ``n_symbols`` worth (at the largest candidate symbol)
    of ``samples``.  Returns (guard, scores) with a score per candidate.
    """
    N = 2048 if transmission == "2k" else 8192
    n = int(min(len(samples), (n_symbols + 1) * (N + N // 4) + N))
    if n < 3 * N:
        raise DetectionError(
            f"need >= {3 * N} samples for guard detection, got {len(samples)}")
    iq = torch.from_numpy(np.array(samples[:n], np.complex64)).to(device)
    scores = {}
    for g, frac in GUARDS.items():
        scorer = _make_guard_scorer(N, int(N * frac), n)
        scores[g] = float(scorer(iq))
    best = max(scores, key=scores.get)
    return best, scores


def _parse_tps(s: np.ndarray) -> dict:
    """Parse + BCH-verify one frame of decoded TPS bits (s0 is don't-care)."""
    s = np.asarray(s, np.uint8)
    bch_ok = bool(np.array_equal(
        tables._bch_67_53_parity(s[1:54]), s[54:68]))
    fields = {
        "length": tuple(int(b) for b in s[17:23]),
        "frame": (int(s[23]) << 1) | int(s[24]),
        "constellation": _TPS_CONSTELLATION.get((int(s[25]), int(s[26]))),
        "alpha": _TPS_ALPHA.get((int(s[27]), int(s[28]), int(s[29]))),
        "code_rate": _TPS_RATE.get((int(s[30]), int(s[31]), int(s[32]))),
        "code_rate_lp": _TPS_RATE.get((int(s[33]), int(s[34]), int(s[35]))),
        "guard": _TPS_GUARD.get((int(s[36]), int(s[37]))),
        "transmission": _TPS_MODE.get((int(s[38]), int(s[39]))),
        "bch_ok": bch_ok,
    }
    return fields


def detect_mode(samples: np.ndarray, transmission: str, device,
                guard: str | None = None) -> tuple[DvbtMode, dict]:
    """Detect the full DvbtMode of a capture, given only 2k/8k.

    Synchronises with a constellation-agnostic placeholder mode (sync uses
    only pilot and TPS carrier positions, which depend on transmission and
    guard), DBPSK-decodes one frame of TPS, checks its BCH parity, and
    assembles the mode.
    """
    info: dict = {}
    if guard is None:
        guard, info["guard_scores"] = detect_guard(samples, transmission,
                                                   device)
    info["guard"] = guard

    placeholder = DvbtMode(transmission, "qpsk", "1/2", guard)
    need = syncop.min_capture_samples(placeholder, 1)
    if len(samples) < need:
        raise DetectionError(
            f"need >= {need} samples for TPS detection, got {len(samples)}")
    synchronize = syncop.make_synchronizer(placeholder, need, 1, device)
    capture = torch.from_numpy(np.array(samples[:need], np.complex64))
    aligned, sinfo = synchronize(capture.to(device)[None])
    demod = ofdm.make_ofdm_demodulator(placeholder, device, SYMBOLS_PER_FRAME)
    tps_dec = reference_signals.make_tps_decoder(placeholder, device)
    bits, _ = tps_dec(demod(aligned))
    fields = _parse_tps(bits[0].cpu().numpy())
    info.update(fields)
    info["sync"] = {k: v[0].cpu().numpy() for k, v in sinfo.items()}

    if not fields["bch_ok"]:
        raise DetectionError(f"TPS BCH check failed: {fields}")
    if fields["transmission"] != transmission:
        raise DetectionError(
            f"TPS signals {fields['transmission']}, caller said {transmission}")
    if fields["guard"] != guard:
        raise DetectionError(
            f"TPS signals guard {fields['guard']}, detected {guard}")
    if fields["constellation"] is None or fields["code_rate"] is None:
        raise DetectionError(f"reserved TPS field values: {fields}")
    alpha = fields["alpha"]
    mode = DvbtMode(
        transmission, fields["constellation"], fields["code_rate"], guard,
        alpha=alpha,
        code_rate_lp=(fields["code_rate_lp"] if alpha else
                      fields["code_rate"]),
        cell_id_on=fields["length"] == (0, 1, 1, 1, 1, 1),
    )
    return mode, info


class AutoStreamingReceiver:
    """StreamingReceiver that is told only the transmission mode.

    Buffers samples until one detection capture is available, runs
    :func:`detect_mode`, then builds and delegates to the ordinary
    :class:`StreamingReceiver` (replaying the buffered samples, so nothing
    is lost).  ``detected_mode`` is None until detection succeeds.
    """

    def __init__(self, transmission: str, device, guard: str | None = None,
                 n_frames: int | None = None, **rx_kwargs):
        self._transmission = transmission
        self._device = torch.device(device)
        self._guard = guard
        self._n_frames = n_frames
        self._rx_kwargs = rx_kwargs
        self._pending: list[np.ndarray] = []
        self._srx: StreamingReceiver | None = None
        self.detected_mode: DvbtMode | None = None
        self.detect_info: dict | None = None

    def _need(self) -> int:
        placeholder = DvbtMode(self._transmission, "qpsk", "1/2",
                               self._guard or "1/4")
        return syncop.min_capture_samples(placeholder, 1)

    def feed(self, samples: np.ndarray) -> list[StreamReport]:
        if self._srx is not None:
            return self._srx.feed(samples)
        self._pending.append(np.asarray(samples, np.complex64))
        if sum(len(c) for c in self._pending) < self._need():
            return []
        stream = np.concatenate(self._pending)
        mode, info = detect_mode(stream, self._transmission, self._device,
                                 self._guard)
        self.detected_mode, self.detect_info = mode, info
        self._srx = StreamingReceiver(mode, self._device, self._n_frames,
                                      **self._rx_kwargs)
        self._pending = []
        return self._srx.feed(stream)

    def __getattr__(self, name):
        srx = object.__getattribute__(self, "_srx")
        if srx is not None:
            return getattr(srx, name)
        raise AttributeError(name)
