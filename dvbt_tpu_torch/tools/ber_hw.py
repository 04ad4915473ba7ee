"""On-card BER points, the counterpart of tools/ber_hw.py: one point per
waterfall (2K QPSK 1/2 hard 5 dB, 8K UK hard 19 dB, 2K F1 hard 7 dB, 2K
P1 soft 8 dB), run through ``apps.ber_sweep.run_point`` for each of
``ber_curves.SEEDS`` seeds and held to the JAX package's curve by
``ber_curves.judge``'s limit rule.

    python3 -m dvbt_tpu_torch.tools.ber_hw [--device cpu] [--out PATH]

On the card it appends one JSON line a point to docs/BER_HW_H100.jsonl
(not ``ber_*``-named: the JAX curves stay as they are), naming the curve
file it belongs to, the card's name and power limit; on the CPU only with
--out.  It exits nonzero if a point misses the rule.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..apps import ber_sweep
from ..apps.device import add_device_arg, card, device_from_args
from ..mode import DvbtMode
from . import ber_curves

POINTS = [
    # (mode ctor args, snr_db, blocks, demap, profile, jsonl file the CPU
    #  curve lives in)
    (("2k", "qpsk", "1/2", "1/32"), 5.0, 8, "hard", None,
     "ber_2k_qpsk_12_hard.jsonl"),
    (("8k", "64qam", "2/3", "1/32"), 19.0, 4, "hard", None,
     "ber_8k_64qam_23_hard.jsonl"),
    # round-4 paths: Annex B multipath + CSI-weighted soft, on-device
    (("2k", "qpsk", "1/2", "1/32"), 7.0, 8, "hard", "F1",
     "ber_2k_qpsk_12_f1_hard.jsonl"),
    (("2k", "qpsk", "1/2", "1/32"), 8.0, 8, "soft", "P1",
     "ber_2k_qpsk_12_p1_soft.jsonl"),
]


def run(device, seeds) -> list[dict]:
    """Each of POINTS over ``seeds``: one line a point, with the rule's
    verdict on each stream."""
    device = torch.device(device)
    where = card(device)
    lines = []
    for args, snr, blocks, demap, profile, fname in POINTS:
        mode = DvbtMode(*args)
        t0 = time.time()
        runs = [ber_sweep.run_point(mode, snr, blocks, seed, demap, profile,
                                    device) for seed in seeds]
        ref = ber_curves.reference(fname[len("ber_"):-len(".jsonl")])[snr]
        lines.append({"curve": fname, "device": runs[0]["device"],
                      "card": where, "snr_db": snr, "blocks": blocks,
                      "demap": demap, "profile": profile or "none",
                      "seeds": len(seeds), "packets": runs[0]["packets"],
                      **ber_curves.check_point(ref, runs, mode.hierarchical),
                      "wall_s": round(time.time() - t0, 4)})
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(p)
    p.add_argument("--out", help="the JSONL file to append to (default on "
                   "the card: docs/BER_HW_H100.jsonl)")
    a = p.parse_args(argv)
    device = device_from_args(a, "ber_hw")
    lines = run(device, range(ber_curves.SEEDS))
    out = a.out or (ber_curves.DOCS / "BER_HW_H100.jsonl"
                    if device.type == "cuda" else None)
    for line in lines:
        print(json.dumps(line), flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    n_pass = sum(line["pass"] for line in lines)
    print(f"{n_pass}/{len(lines)} points within the rule"
          f"{f' -> {out}' if out else ''}", file=sys.stderr, flush=True)
    return 0 if n_pass == len(lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
