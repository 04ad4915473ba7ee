"""The Table-3 puncturing of the K=7 mother code, EN300744 §4.3.3.

One description per code rate, read by the byte coder (K2), the
depuncturer, both Viterbi paths (K1 and its plain version) and the
window/tail alignment rules.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

from .. import tables


class Puncture(NamedTuple):
    period: int               # info bits per puncture period
    keep: int                 # coded bits kept per period
    order: tuple[int, ...]    # serial position r reads mother position
                              # order[r] of the period's (x0, y0, x1, ...)
    rank: tuple[int, ...]     # serial position of mother position m, or -1
                              # where m is punctured
    align: int                # lcm(8, period): a tail or window that is a
                              # multiple of it is byte- and phase-aligned


@functools.lru_cache(maxsize=None)
def pattern(rate: str) -> Puncture:
    order = tuple(int(o) for o in tables.puncture_serial_order(rate))
    period = len(tables.PUNCTURE[rate][0])
    rank = [-1] * (2 * period)
    for i, o in enumerate(order):
        rank[o] = i
    return Puncture(period, len(order), order, tuple(rank),
                    8 * period // math.gcd(8, period))
