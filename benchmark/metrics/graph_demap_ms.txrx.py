"""Device milliseconds a replayed head-end step spends in the program's
``demap_deinterleave`` stage: the CUDA events the stage records inside the
CUDA graph the cell replays (benchmark/stage_window.py), not an eager
trace."""

from benchmark import stage_window


def read(trace, r: dict):
    return stage_window.stage_ms(r, "txrx", "demap_deinterleave",
                                 "device_ms")
