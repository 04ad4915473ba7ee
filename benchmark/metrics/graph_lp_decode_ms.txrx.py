"""Device milliseconds a replayed hierarchical head-end step spends in the
program's ``lp_decode`` stage, the LP stream's decoder (Viterbi, outer
deinterleave, RS decode, descramble): the CUDA events the stage records
inside the CUDA graph the cell replays (benchmark/stage_window.py).  None
where the step has no such stage (one stream, or a program without it)."""

from benchmark import stage_window


def read(trace, r: dict):
    return stage_window.stage_ms(r, "txrx", "lp_decode", "device_ms")
