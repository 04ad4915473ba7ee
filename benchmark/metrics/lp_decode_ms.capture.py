"""Device milliseconds a pass of the block path spends in the program's
``lp_decode`` stage, the LP stream's decoder of a hierarchical capture
(depuncture, K3, outer deinterleave, RS decode, descramble): the CUDA
events the stage records in the passes the driver runs with the recorder
active (``capture_streams``, the reading's ``telemetry``).  None where the
pass has no such stage (one stream, or a program without it) or the
reading no telemetry."""

from benchmark import stage_window


def read(trace, r: dict):
    return stage_window.stage_ms(r, "capture", "lp_decode", "device_ms")
