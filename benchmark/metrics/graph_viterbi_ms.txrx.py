"""Device milliseconds a replayed head-end step spends in the program's
``viterbi_decode`` stages (kernel K1): the CUDA events the stages record
inside the CUDA graph the cell replays (benchmark/stage_window.py)."""

from benchmark import stage_window


def read(trace, r: dict):
    return stage_window.stage_ms(r, "txrx", "viterbi_decode", "device_ms")
