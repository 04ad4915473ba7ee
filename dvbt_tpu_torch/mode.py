"""DvbtMode — the mode/config object of the port, a copy of
dvbt_tpu/mode.py with the same fields, properties and table accessors.

A frozen dataclass, so it is hashable and can key the factories'
``functools.lru_cache``.  All derived constants of EN 300 744 (§4.4
Table 1, Table 5) are properties; index tables live in
:mod:`dvbt_tpu_torch.tables` and are reached through this object.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import numpy as np

from . import tables

CONSTELLATION_BITS = {"qpsk": 2, "16qam": 4, "64qam": 6}
CODE_RATES = {"1/2": Fraction(1, 2), "2/3": Fraction(2, 3), "3/4": Fraction(3, 4),
              "5/6": Fraction(5, 6), "7/8": Fraction(7, 8)}
GUARDS = {"1/32": Fraction(1, 32), "1/16": Fraction(1, 16),
          "1/8": Fraction(1, 8), "1/4": Fraction(1, 4)}

SYMBOLS_PER_FRAME = 68
FRAMES_PER_SUPERFRAME = 4
TS_PACKET = 188
RS_PACKET = 204
OUTER_I = 12  # Forney interleaver branches
OUTER_M = 17  # per-branch cell size (OUTER_I * OUTER_M == RS_PACKET)


@dataclasses.dataclass(frozen=True)
class DvbtMode:
    """Static description of one DVB-T operating mode.

    ``alpha == 0`` means non-hierarchical; 1, 2, 4 select the hierarchical
    constellation splits.  For non-hierarchical modes ``code_rate_lp`` is
    ignored (kept equal to HP).
    """

    transmission: str = "2k"          # "2k" | "8k"
    constellation: str = "qpsk"       # "qpsk" | "16qam" | "64qam"
    code_rate: str = "1/2"            # HP stream code rate
    guard: str = "1/32"
    alpha: int = 0                    # 0 = non-hierarchical; else 1 | 2 | 4
    code_rate_lp: str = "1/2"
    cell_id: int = 0
    cell_id_on: bool = False          # transmit cell id in TPS (s17..22 flips
                                      # to 011111) — reference `include_cell_id`

    def __post_init__(self):
        assert self.transmission in ("2k", "8k"), self.transmission
        assert self.constellation in CONSTELLATION_BITS, self.constellation
        assert self.code_rate in CODE_RATES, self.code_rate
        assert self.guard in GUARDS, self.guard
        assert self.alpha in (0, 1, 2, 4), self.alpha
        if self.alpha:
            assert self.constellation != "qpsk", "hierarchical requires QAM"

    # --- EN300744 Table 1 -------------------------------------------------
    @property
    def fft_len(self) -> int:
        return 2048 if self.transmission == "2k" else 8192

    @property
    def n_carriers(self) -> int:
        """Active carriers K (1705 / 6817)."""
        return 1705 if self.transmission == "2k" else 6817

    @property
    def kmax(self) -> int:
        return self.n_carriers - 1

    @property
    def n_payload(self) -> int:
        """Payload (data) cells per OFDM symbol (1512 / 6048)."""
        return 1512 if self.transmission == "2k" else 6048

    @property
    def v(self) -> int:
        """Bits per constellation cell."""
        return CONSTELLATION_BITS[self.constellation]

    @property
    def guard_len(self) -> int:
        return int(self.fft_len * GUARDS[self.guard])

    @property
    def symbol_len(self) -> int:
        """Time-domain samples per OFDM symbol incl. cyclic prefix."""
        return self.fft_len + self.guard_len

    @property
    def hierarchical(self) -> bool:
        return self.alpha != 0

    @property
    def alpha_eff(self) -> int:
        """alpha for constellation geometry (1 when non-hierarchical)."""
        return self.alpha if self.alpha else 1

    # --- rate chain -------------------------------------------------------
    @property
    def bits_per_symbol(self) -> int:
        """Coded (post-puncturing) bits carried by one OFDM symbol."""
        return self.n_payload * self.v

    def stream_coded_bits_per_symbol(self, stream: str = "hp") -> int:
        """Coded bits per symbol carried by one stream: hierarchical HP gets
        substreams b0,b1 (2 bits/cell), LP the remaining v-2
        [EN300744 §4.3.4.1]; non-hierarchical 'hp' is the whole symbol."""
        if not self.hierarchical:
            assert stream == "hp"
            return self.n_payload * self.v
        return self.n_payload * (2 if stream == "hp" else self.v - 2)

    def stream_rate(self, stream: str = "hp") -> Fraction:
        return CODE_RATES[self.code_rate if stream == "hp"
                          else self.code_rate_lp]

    def stream_info_bits_per_symbol(self, stream: str = "hp") -> Fraction:
        return self.stream_coded_bits_per_symbol(stream) * \
            self.stream_rate(stream)

    @property
    def streams(self) -> tuple[str, ...]:
        return ("hp", "lp") if self.hierarchical else ("hp",)

    @property
    def info_bits_per_symbol(self) -> Fraction:
        return self.bits_per_symbol * CODE_RATES[self.code_rate]

    @functools.cached_property
    def frames_per_block(self) -> int:
        """Smallest f | 4 such that a block of f frames carries an integer
        number of 204-byte packets in EVERY stream (always true at the
        superframe, EN300744 §4.4)."""
        for f in (1, 2, 4):
            if all((self.stream_info_bits_per_symbol(s) * SYMBOLS_PER_FRAME
                    * f) % (8 * RS_PACKET) == 0 for s in self.streams):
                return f
        raise AssertionError("superframe packet alignment violated")

    def stream_packets_per_block(self, stream: str = "hp") -> int:
        p = (self.stream_info_bits_per_symbol(stream) * SYMBOLS_PER_FRAME
             * self.frames_per_block) / (8 * RS_PACKET)
        assert p.denominator == 1
        return int(p)

    @functools.cached_property
    def packets_per_frame(self) -> Fraction:
        return self.info_bits_per_symbol * SYMBOLS_PER_FRAME / (8 * RS_PACKET)

    @property
    def packets_per_block(self) -> int:
        """Non-hierarchical single-stream packet count (HP for hierarchical)."""
        return self.stream_packets_per_block("hp")

    @property
    def symbols_per_block(self) -> int:
        return SYMBOLS_PER_FRAME * self.frames_per_block

    @property
    def samples_per_block(self) -> int:
        return self.symbols_per_block * self.symbol_len

    @property
    def sample_rate(self) -> float:
        """Baseband sample rate for an 8 MHz channel (64/7 Msps)."""
        return 64e6 / 7

    @property
    def useful_bitrate(self) -> float:
        """TS payload bitrate in bit/s [EN300744 Table 4 derivation]."""
        bits_per_frame = float(self.info_bits_per_symbol * SYMBOLS_PER_FRAME)
        ts_fraction = TS_PACKET / RS_PACKET
        frame_dur = self.symbol_len * SYMBOLS_PER_FRAME / self.sample_rate
        return bits_per_frame * ts_fraction / frame_dur

    # --- table accessors (numpy; ops convert to jnp once) -----------------
    def constellation_table(self) -> np.ndarray:
        return tables.constellation(self.v, self.alpha_eff)

    def bit_interleaver_table(self) -> np.ndarray:
        return tables.bit_interleaver_indices(self.v, self.hierarchical)

    def symbol_interleaver_perm(self) -> np.ndarray:
        return tables.symbol_interleaver_perm(self.transmission)

    def puncture_order(self) -> np.ndarray:
        return tables.puncture_serial_order(self.code_rate)

    def continual_pilots(self) -> np.ndarray:
        return tables.continual_pilots(self.transmission)

    def tps_carriers(self) -> np.ndarray:
        return tables.tps_carriers(self.transmission)

    def wk(self) -> np.ndarray:
        return tables.wk_sequence(self.n_carriers)

    def tps_bits(self, frame_idx: int) -> np.ndarray:
        return tables.tps_frame_bits(
            frame_idx % 4, self.v, self.alpha, self.code_rate,
            self.code_rate_lp if self.hierarchical else self.code_rate,
            self.guard, self.transmission, self.cell_id, self.cell_id_on,
        )


# The two headline configurations from BASELINE.json
MODE_2K_QPSK = DvbtMode("2k", "qpsk", "1/2", "1/32")
MODE_8K_UK = DvbtMode("8k", "64qam", "2/3", "1/32")
