"""Device milliseconds a step inside the ``rs_encode`` ranges, from an
eager trace of the same step (ranges are not recorded in a graph replay);
a hierarchical step's two streams summed."""


def read(trace, r: dict):
    us = r.get("ranges", {}).get("rs_encode") if \
        r.get("kind") == "txrx" else None
    return us / 1e3 if us else None
