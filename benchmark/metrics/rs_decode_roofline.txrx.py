"""The RS(204, 188) decode's share of its bound: the bytes of the step's
packets over the memory's bandwidth (benchmark/roofline.py), over the
device time inside the ``rs_decode`` range of an eager trace."""

from benchmark import roofline


def read(trace, r: dict):
    us = r.get("ranges", {}).get("rs_decode") if \
        r.get("kind") == "txrx" else None
    if not us:
        return None
    return 100.0 * roofline.rs_decode_bound_s(r["n_mux"], r["n_packets"]) \
        / (us / 1e6)
