"""A hierarchical mode carries two transport streams: its packets, TS,
packet counts and packet halos are (hp, lp) pairs, where any other mode
has one value.  split/join go between the two forms."""

from __future__ import annotations


def split(x, hier: bool) -> tuple:
    """x as a tuple of per-stream values: the (hp, lp) pair itself in a
    hierarchical mode, (x,) otherwise."""
    return tuple(x) if hier else (x,)


def join(xs, hier: bool):
    """The inverse of split."""
    return tuple(xs) if hier else xs[0]
