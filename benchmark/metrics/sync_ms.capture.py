"""Device milliseconds a pass inside the block path's ``synchronizer``
range."""


def read(trace, r: dict):
    us = r.get("ranges", {}).get("synchronizer") if \
        r.get("kind") == "capture" else None
    return us / 1e3 if us else None
