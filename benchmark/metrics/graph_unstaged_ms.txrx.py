"""Device milliseconds a replayed head-end step spends in no named stage:
the ``graph_step`` interval (the whole captured body, the state copy-back
included) less the union of its child stages' intervals, from the CUDA
events recorded inside the graph (benchmark/stage_window.py)."""

from benchmark import stage_window


def read(trace, r: dict):
    return stage_window.stage_ms(r, "txrx", "graph_step", "self_device_ms")
