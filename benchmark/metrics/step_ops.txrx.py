"""Device operations a replayed step launches (kernels, copies, sets),
counted in the traced window of graph replays, the harness's checks left
out."""


def read(trace, r: dict):
    if r.get("kind") != "txrx" or trace is None or not r["units"]:
        return None
    return len(trace.program_ops()) / r["units"]
