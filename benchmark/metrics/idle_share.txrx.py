"""Share of the traced window of graph replays in which no operation ran
on the device: 1 - the union of kernel, copy and set intervals over the
window.  A replay is one host call, so the profiler adds little here."""


def read(trace, r: dict):
    if r.get("kind") != "txrx" or trace is None or trace.wall_us <= 0:
        return None
    return 1.0 - trace.busy_us() / trace.wall_us
