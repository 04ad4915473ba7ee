"""The RS(204, 188) decode's share of its bound: the bytes of the step's
packets, over all its streams, over the memory's bandwidth
(benchmark/roofline.py), over the device time inside the ``rs_decode``
ranges of an eager trace."""

from benchmark import roofline


def read(trace, r: dict):
    us = r.get("ranges", {}).get("rs_decode") if \
        r.get("kind") == "txrx" else None
    if not us:
        return None
    bound = sum(roofline.rs_decode_bound_s(r["n_mux"], n)
                for n, _ in roofline.streams(r))
    return 100.0 * bound / (us / 1e6)
