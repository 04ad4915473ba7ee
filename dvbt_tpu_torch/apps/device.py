"""The apps' ``--device`` flag: the card unless the CPU is asked for."""

from __future__ import annotations

import argparse

import torch


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the card, default) or cpu")


def device_from_args(a: argparse.Namespace, prog: str) -> torch.device:
    """The device ``--device`` names; exits nonzero when it is cuda and
    there is no CUDA device."""
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    return torch.device(a.device)
