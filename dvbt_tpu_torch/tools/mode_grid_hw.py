"""On-card validation sweep, the counterpart of tools/mode_grid_hw.py:
byte-exact TX -> RX for

  * the full 2K constellation x code-rate grid at GI 1/4 (15 modes),
  * a guard-interval sweep at 2K 64-QAM 2/3,
  * 8K spot modes incl. the UK profile and rate 7/8,
  * hierarchical modes (2K 16-QAM alpha=4, 8K 64-QAM alpha=2 HP 2/3 LP 3/4).

Each mode streams two carried-state blocks (one mux) through the
symbol-aligned receiver and checks each recovered transport stream byte
for byte after the 11-packet delay, with zero RS corrections consumed: the
decode is exact before the RS safety net, so a kernel or convention fault
cannot hide behind RS's 8-byte budget.

    python3 -m dvbt_tpu_torch.tools.mode_grid_hw [--device cpu] [--out PATH]

On the card it writes docs/MODE_GRID_H100.json (the JAX artifact's fields,
``device`` the card's name and power limit); on the CPU only with --out.
A mode that raises is recorded and is not green; the run exits nonzero
unless every mode is green.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..apps.device import add_device_arg, card, device_from_args
from ..io import ts as tsio
from ..mode import DvbtMode
from ..models import rx as rxm, tx as txm
from ..ops.outer_interleaver import DELAY_PACKETS
from ..utils.streams import join, split

DOCS = Path(__file__).resolve().parents[2] / "docs"

# the JAX script's grid (local to its main()), same names, same order
GRID: list[tuple[str, DvbtMode]] = [
    (f"2k_{c}_{r.replace('/', '')}", DvbtMode("2k", c, r, "1/4"))
    for c in ("qpsk", "16qam", "64qam")
    for r in ("1/2", "2/3", "3/4", "5/6", "7/8")
] + [
    (f"2k_64qam_23_g{g.replace('/', '')}", DvbtMode("2k", "64qam", "2/3", g))
    for g in ("1/4", "1/8", "1/16", "1/32")
] + [
    ("8k_qpsk_12", DvbtMode("8k", "qpsk", "1/2", "1/4")),
    ("8k_16qam_34", DvbtMode("8k", "16qam", "3/4", "1/8")),
    ("8k_64qam_23_uk", DvbtMode("8k", "64qam", "2/3", "1/32")),
    ("8k_64qam_78", DvbtMode("8k", "64qam", "7/8", "1/16")),
    ("2k_16qam_a4_hier", DvbtMode("2k", "16qam", "1/2", "1/8",
                                  alpha=4, code_rate_lp="3/4")),
    ("8k_64qam_a2_hier", DvbtMode("8k", "64qam", "2/3", "1/32",
                                  alpha=2, code_rate_lp="3/4")),
]


def run_mode(mode: DvbtMode, device, n_blocks: int = 2) -> dict:
    """n_blocks carried-state blocks of ``make_ts_packets(seed=3)`` (the LP
    stream's seed=4) through TX -> RX on one mux: {"byte_exact",
    "rs_uncorrectable", "rs_corrected", "wall_s"}, byte_exact only when
    every stream is exact and no packet was corrected or uncorrectable."""
    device = torch.device(device)
    tx, n_pk, _ = txm.make_transmitter(mode, device)
    rx, _, _ = rxm.make_receiver(mode, device)
    hier = mode.hierarchical
    n_pk = split(n_pk, hier)
    packets = [tsio.make_ts_packets(n * n_blocks, seed=3 + k)
               for k, n in enumerate(n_pk)]
    tst = txm.init_tx_state(mode, 1, device)
    rst = rxm.init_rx_state(mode, 1, device)
    outs = [[] for _ in n_pk]
    bad = corr = 0
    t0 = time.time()
    for b in range(n_blocks):
        tst, iq = tx(tst, join([torch.as_tensor(
            pk[b * n:(b + 1) * n], device=device)[None]
            for pk, n in zip(packets, n_pk)], hier))
        rst, ts, m = rx(rst, iq)
        for out, ts_s, pre in zip(outs, split(ts, hier), ("", "lp_")):
            out.append(ts_s[0].cpu().numpy())
            bad += int(m[f"{pre}rs_uncorrectable"].sum())
            corr += int(m[f"{pre}rs_corrected"].sum())
    wall = time.time() - t0

    def exact(out, want):
        got = np.concatenate(out)[DELAY_PACKETS:]
        return bool(np.array_equal(got, want[:len(got)]))

    ok = all(exact(o, pk) for o, pk in zip(outs, packets))
    return {"byte_exact": ok and bad == 0 and corr == 0,
            "rs_uncorrectable": bad, "rs_corrected": corr,
            "wall_s": round(wall, 4)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(p)
    p.add_argument("--out", help="where to write the JSON artifact "
                   "(default on the card: docs/MODE_GRID_H100.json)")
    a = p.parse_args(argv)
    device = device_from_args(a, "mode_grid_hw")
    results = {}
    t_all = time.time()
    for name, mode in GRID:
        t0 = time.time()
        try:
            results[name] = run_mode(mode, device)
        except Exception as e:      # record, keep sweeping; not green
            traceback.print_exc()
            results[name] = {"byte_exact": False, "error": repr(e)[:200]}
        results[name]["total_s"] = round(time.time() - t0, 4)
        print(f"{name:24s} {json.dumps(results[name])}", flush=True)
    n_ok = sum(1 for r in results.values() if r["byte_exact"])
    artifact = {"device": card(device), "modes_green": n_ok,
                "modes_total": len(results),
                "wall_s": round(time.time() - t_all, 4), "results": results}
    out = a.out or (DOCS / "MODE_GRID_H100.json"
                    if device.type == "cuda" else None)
    if out is not None:
        with open(out, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
    print(f"{n_ok}/{len(results)} modes green on {artifact['device']}"
          f"{f' -> {out}' if out else ''}", file=sys.stderr, flush=True)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
