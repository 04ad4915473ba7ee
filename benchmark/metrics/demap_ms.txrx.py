"""Device milliseconds a step inside the ``demap_deinterleave`` range, from
an eager trace of the same step (ranges are not recorded in a graph
replay)."""


def read(trace, r: dict):
    us = r.get("ranges", {}).get("demap_deinterleave") if \
        r.get("kind") == "txrx" else None
    return us / 1e3 if us else None
