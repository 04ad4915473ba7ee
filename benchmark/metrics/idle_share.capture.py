"""Share of the traced window of capture passes in which no operation ran
on the device: 1 - the union of kernel, copy and set intervals over the
window.  The path launches eagerly, so the profiler's host cost a launch
lengthens the traced window: the share reads higher than untraced."""


def read(trace, r: dict):
    if r.get("kind") != "capture" or trace is None or trace.wall_us <= 0:
        return None
    return 1.0 - trace.busy_us() / trace.wall_us
