"""The apps' ``--device`` flag: the card unless the CPU is asked for."""

from __future__ import annotations

import argparse
import subprocess

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


def card(device: torch.device) -> str:
    """What a result ran on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (the first card's), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
