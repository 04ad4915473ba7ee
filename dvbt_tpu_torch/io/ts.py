"""MPEG-TS test streams and TS files.

The port's own copy of the host-side helpers of dvbt_tpu/io/ts.py:
seeded test packets with valid sync bytes and a packet counter, and .ts
file reading (packet-aligned at the first run of sync bytes) and writing.
"""

from __future__ import annotations

import numpy as np

TS_PACKET = 188
SYNC = 0x47


def make_ts_packets(n_packets: int, seed: int = 0) -> np.ndarray:
    """(n_packets, 188) uint8 with valid sync bytes and seeded payload."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, size=(n_packets, TS_PACKET), dtype=np.uint8)
    pk[:, 0] = SYNC
    # put a recognizable header so byte slips are detectable in tests
    pk[:, 1] = (np.arange(n_packets) >> 8) & 0xFF
    pk[:, 2] = np.arange(n_packets) & 0xFF
    return pk


def find_sync(buf: np.ndarray, confirm: int = 2) -> int:
    """First offset with `confirm` sync bytes (0x47, or 0xB8 inverted) on
    the 188-byte grid, or -1."""
    a = np.ascontiguousarray(buf, np.uint8).reshape(-1)
    n = len(a) - TS_PACKET * (confirm - 1)
    if n <= 0:
        return -1
    ok = np.ones(n, dtype=bool)
    for k in range(confirm):
        s = a[k * TS_PACKET: k * TS_PACKET + n]
        ok &= (s == SYNC) | (s == 0xB8)
    hits = np.flatnonzero(ok)
    return int(hits[0]) if len(hits) else -1


def read_ts_file(path: str) -> np.ndarray:
    """Load and packet-align a .ts file -> (n, 188) uint8 (truncates tail)."""
    raw = np.fromfile(path, dtype=np.uint8)
    off = find_sync(raw, confirm=2)
    if off < 0:
        raise ValueError("no MPEG-TS sync found")
    raw = raw[off:]
    n = len(raw) // TS_PACKET
    return raw[: n * TS_PACKET].reshape(n, TS_PACKET)


def write_ts_file(path: str, packets: np.ndarray) -> None:
    np.asarray(packets, dtype=np.uint8).tofile(path)
