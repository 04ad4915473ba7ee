"""Device milliseconds a replayed head-end step spends in the program's
``rs_decode`` stages: the CUDA events the stages record inside the CUDA
graph the cell replays (benchmark/stage_window.py), not an eager trace."""

from benchmark import stage_window


def read(trace, r: dict):
    return stage_window.stage_ms(r, "txrx", "rs_decode", "device_ms")
