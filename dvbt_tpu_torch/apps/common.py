"""Shared CLI plumbing for the apps: mode flags <-> DvbtMode, IQ file IO.

The port's own copy of dvbt_tpu/apps/common.py (which imports no JAX),
function for function; tests/test_torch_isolation.py holds each function
equal to its original.  The flag surface mirrors the reference's GRC block
parameters (constellation / hierarchy alpha / code rate / transmission
mode / guard).  IQ files are raw interleaved complex64, the GNU Radio
file_source/file_sink convention.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..mode import DvbtMode


def add_mode_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--transmission", "-t", choices=["2k", "8k"], default="2k")
    p.add_argument("--constellation", "-c",
                   choices=["qpsk", "16qam", "64qam"], default="qpsk")
    p.add_argument("--rate", "-r", default="1/2",
                   choices=["1/2", "2/3", "3/4", "5/6", "7/8"],
                   help="HP code rate")
    p.add_argument("--guard", "-g", default="1/32",
                   choices=["1/32", "1/16", "1/8", "1/4"])
    p.add_argument("--alpha", type=int, default=0, choices=[0, 1, 2, 4],
                   help="0 = non-hierarchical")
    p.add_argument("--rate-lp", default="1/2",
                   choices=["1/2", "2/3", "3/4", "5/6", "7/8"],
                   help="LP code rate (hierarchical only)")
    p.add_argument("--cell-id", type=int, default=0)


def mode_from_args(a: argparse.Namespace) -> DvbtMode:
    return DvbtMode(a.transmission, a.constellation, a.rate, a.guard,
                    alpha=a.alpha, code_rate_lp=a.rate_lp, cell_id=a.cell_id)


def read_iq(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.complex64)


def write_iq(path: str, iq: np.ndarray) -> None:
    np.asarray(iq, np.complex64).tofile(path)
