"""The punctured Viterbi decode's share of its bound: the bound from the
step's shapes (benchmark/roofline.py), summed over its streams, over the
device time inside the ``viterbi_decode`` ranges of an eager trace of the
same step."""

from benchmark import roofline


def read(trace, r: dict):
    us = r.get("ranges", {}).get("viterbi_decode") if \
        r.get("kind") == "txrx" else None
    if not us:
        return None
    bound = sum(roofline.viterbi_bound_s(r["n_mux"], n, rate)
                for n, rate in roofline.streams(r))
    return 100.0 * bound / (us / 1e6)
