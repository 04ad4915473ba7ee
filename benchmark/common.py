"""What the drivers share: the run's context, inputs from the seed, the
bound on work in flight, and the record of each number compared."""

from __future__ import annotations

import collections
import dataclasses
import sys
import time

# the outer interleaver's delay through TX and RX, in packets: branch j
# of I = 12 delays by j * 17 * 12 bytes, so 11 * 204 bytes in all
DELAY_PACKETS = 11
SYNC_BYTE = 0x47


@dataclasses.dataclass
class Context:
    """One run of one cell: its configuration and traffic files (parsed),
    the command line's seed, window and trace flag, and the device."""
    workload: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    window_start: float | None = None

    def start_window(self) -> float:
        self.window_start = time.perf_counter()
        return self.window_start


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while it is at most
    the limit (a count that has to be 0 has the limit 0)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def generator(seed: int, device):
    """A torch.Generator on ``device`` seeded with ``seed`` (any whole
    number below 2**64)."""
    import torch
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def ts_packets(gen, shape: tuple, device):
    """uint8 TS packets of ``shape`` (..., 188): sync byte 0x47, the rest
    uniform from ``gen``."""
    import torch
    pk = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                       device=device)
    pk[..., 0] = SYNC_BYTE
    return pk


class InFlight:
    """Keeps the host at most ``depth`` units of work ahead of the device,
    so that the window's host clock follows the device's work."""

    def __init__(self, device, depth: int = 2):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self.depth = depth
        self.events: collections.deque = collections.deque()

    def mark(self) -> None:
        if not self.cuda:
            return
        import torch
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        while len(self.events) > self.depth:
            self.events.popleft().synchronize()


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check_scope():
    """A profiler range around the harness's own device work."""
    from torch.profiler import record_function
    return record_function("bench.check")
