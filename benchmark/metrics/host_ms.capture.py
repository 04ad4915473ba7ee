"""Host milliseconds a pass of the block path spends in the program's
``block_rx`` stage, issuing its work with the profiler off and the
device's queue empty at its start (benchmark/stage_window.py).  Set
against the device's busy time a pass, it says how near the eager path's
host is to holding the card back."""

from benchmark import stage_window


def read(trace, r: dict):
    return stage_window.stage_ms(r, "capture", "block_rx", "host_ms")
