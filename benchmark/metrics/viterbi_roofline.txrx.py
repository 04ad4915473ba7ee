"""The punctured Viterbi decode's share of its bound: the bound from the
step's shapes (benchmark/roofline.py) over the device time inside the
``viterbi_decode`` range of an eager trace of the same step."""

from benchmark import roofline


def read(trace, r: dict):
    us = r.get("ranges", {}).get("viterbi_decode") if \
        r.get("kind") == "txrx" else None
    if not us:
        return None
    bound = roofline.viterbi_bound_s(r["n_mux"], r["n_packets"],
                                     r["code_rate"])
    return 100.0 * bound / (us / 1e6)
