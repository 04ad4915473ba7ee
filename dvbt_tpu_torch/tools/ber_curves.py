"""BER curves on the card, the counterpart of tools/ber_r4.py,
tools/ber_r5.py and the round-3 ``ber_sweep`` runs of docs/BER.md: every
point of the 20 curves in docs/ber_*.jsonl, run through
``apps.ber_sweep.run_point`` for each of SEEDS seeds (each seed over the
curve's own block count) and held to the JAX package's value by one limit
rule, ``judge``; then two planted faults on one 2K and one 8K curve show
what the rule catches.

    python3 -m dvbt_tpu_torch.tools.ber_curves [--device cpu] [--out PATH]
        [stem ...]

The rule, for each stream of each point (HP and LP in hierarchical modes),
with J the JAX curve's ``ber_post_viterbi`` and S seeds:

  * J null (no correctable packet): the port's pooled ``per`` >= 0.99;
  * J 0: the pooled ``per`` <= 0.005;
  * the curve's ``per`` >= CLIFF_PER (a few correctable packets): the
    spread test below on ``per`` instead of ``ber_post_viterbi``;
  * otherwise the spread test on ``ber_post_viterbi``, which fails if a
    seed has no correctable packet:
    |J - mean| <= max(SPREAD_K * sigma * sqrt(1 + 1/S), REL_FLOOR * J),
    with mean and sigma (the sample standard deviation) over the seeds.
    The JAX value is one draw of its own noise, hence the 1/S term.

Viterbi errors come in bursts, so the limit comes from the seeds' measured
spread, not from a count of bits.  On the card it writes docs/BER_H100.json
(each point's JAX value, the port's mean, sigma, limit and verdict, the
planted faults' fail counts, the card's name and power limit); on the CPU
only with --out.  It exits nonzero if a point misses or a planted fault
passes every point of its curve.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from ..apps import ber_sweep
from ..apps.device import add_device_arg, card, device_from_args
from ..mode import MODE_2K_QPSK, MODE_8K_UK, DvbtMode

DOCS = Path(__file__).resolve().parents[2] / "docs"

MODE_16QAM_34 = DvbtMode("2k", "16qam", "3/4")
MODE_64QAM_78 = DvbtMode("2k", "64qam", "7/8")
# hierarchical 16-QAM alpha=2: HP 1/2 (robust), LP 3/4
MODE_HIER = DvbtMode("2k", "16qam", "1/2", alpha=2, code_rate_lp="3/4")
MODE_8K_16QAM_34 = DvbtMode("8k", "16qam", "3/4")

# (file stem, mode, demap, profile, snr list, blocks): the round-3 AWGN
# waterfalls (docs/BER.md), then tools/ber_r4.py's CURVES, then
# tools/ber_r5.py's
CURVES = [
    ("2k_qpsk_12_hard", MODE_2K_QPSK, "hard", None,
     [1, 2, 3, 4, 5, 6, 7, 8, 9], 8),
    ("2k_qpsk_12_soft", MODE_2K_QPSK, "soft", None,
     [2, 3, 4, 5, 6, 7], 8),
    ("8k_64qam_23_hard", MODE_8K_UK, "hard", None,
     [15, 16, 17, 18, 19, 20, 21, 22], 4),
    ("8k_64qam_23_soft", MODE_8K_UK, "soft", None,
     [15, 16, 17, 18, 19], 4),
    ("2k_qpsk_12_f1_hard", MODE_2K_QPSK, "hard", "F1",
     [3, 4, 5, 6, 7, 8, 9], 8),
    ("2k_qpsk_12_f1_soft", MODE_2K_QPSK, "soft", "F1",
     [2, 3, 4, 5, 6, 7], 8),
    ("2k_qpsk_12_p1_hard", MODE_2K_QPSK, "hard", "P1",
     [5, 6, 7, 8, 9, 10, 12, 14], 8),
    ("2k_qpsk_12_p1_soft", MODE_2K_QPSK, "soft", "P1",
     [4, 5, 6, 7, 8, 10], 8),
    ("8k_64qam_23_f1_hard", MODE_8K_UK, "hard", "F1",
     [17, 18, 19, 20, 21, 22], 4),
    ("8k_64qam_23_f1_soft", MODE_8K_UK, "soft", "F1",
     [16, 17, 18, 19], 4),
    ("8k_64qam_23_p1_hard", MODE_8K_UK, "hard", "P1",
     [19, 20, 21, 22, 23, 24, 26], 4),
    ("8k_64qam_23_p1_soft", MODE_8K_UK, "soft", "P1",
     [17, 18, 19, 20, 21, 22], 4),
    ("2k_16qam_34_hard", MODE_16QAM_34, "hard", None,
     [11, 12, 13, 14, 15, 16, 17], 8),
    ("2k_16qam_34_soft", MODE_16QAM_34, "soft", None,
     [10, 11, 12, 13, 14], 8),
    ("2k_64qam_78_hard", MODE_64QAM_78, "hard", None,
     [19, 20, 21, 22, 23, 24, 25], 8),
    ("2k_64qam_78_soft", MODE_64QAM_78, "soft", None,
     [18, 19, 20, 21, 22], 8),
    ("2k_16qam_hier_a2_hard", MODE_HIER, "hard", None,
     [6, 8, 10, 12, 14, 16, 18, 20, 22, 24], 8),
    ("8k_16qam_34_hard", MODE_8K_16QAM_34, "hard", None,
     [11, 12, 13, 14, 15, 16], 4),
    ("8k_16qam_34_soft", MODE_8K_16QAM_34, "soft", None,
     [10, 11, 12, 13, 14], 4),
    ("2k_16qam_hier_a2_soft", MODE_HIER, "soft", None,
     [4, 6, 8, 10, 12, 14, 16, 18, 20], 8),
]

# the limit rule (module docstring), fixed before the first run on the card
SEEDS = 16
SPREAD_K = 4.5
REL_FLOOR = 0.15
PER_ZERO_MAX = 0.005
PER_NULL_MIN = 0.99
CLIFF_PER = 0.95
# the planted faults: each point FAULT_DB lower, and the other demap at the
# same point, on one 2K and one 8K curve, judged against the true point
FAULT_DB = 0.25
FAULT_CURVES = ("2k_qpsk_12_hard", "8k_64qam_23_hard")


def reference(stem: str) -> dict[float, dict]:
    """The JAX package's curve docs/ber_<stem>.jsonl: {snr_db: line} of its
    CPU lines (a hardware line re-measures one of them)."""
    out = {}
    for line in (DOCS / f"ber_{stem}.jsonl").read_text().splitlines():
        d = json.loads(line)
        if d["device"] == "cpu":
            out[d["snr_db"]] = d
    return out


def judge(ref: dict, runs: list[dict], pre: str = "") -> dict:
    """The limit rule on one stream of one point: ``ref`` the JAX curve's
    line, ``runs`` run_point's result for each seed, ``pre`` the stream's
    key prefix ("" or "lp_").  Returns the values compared and "pass"."""
    want = ref[f"{pre}ber_post_viterbi"]
    per = float(np.mean([r[f"{pre}per"] for r in runs]))  # equal packets
    if want is None:
        return {"check": f"per >= {PER_NULL_MIN}", "jax": None, "per": per,
                "pass": per >= PER_NULL_MIN}
    if want == 0:
        return {"check": f"per <= {PER_ZERO_MAX}", "jax": 0.0, "per": per,
                "pass": per <= PER_ZERO_MAX}
    key = "per" if ref[f"{pre}per"] >= CLIFF_PER else "ber_post_viterbi"
    jax = ref[f"{pre}{key}"]
    vals = [r[f"{pre}{key}"] for r in runs]
    out = {"check": key, "jax": jax, "per": per, "values": vals}
    if any(v is None for v in vals):
        return {**out, "pass": False}
    mean, sigma = float(np.mean(vals)), float(np.std(vals, ddof=1))
    limit = max(SPREAD_K * sigma * math.sqrt(1 + 1 / len(vals)),
                REL_FLOOR * jax)
    return {**out, "mean": mean, "sigma": sigma, "limit": limit,
            "pass": abs(jax - mean) <= limit}


def check_point(ref: dict, runs: list[dict], hier: bool) -> dict:
    """``judge`` on each stream: {"pass", "hp"[, "lp"]} ("hp" is the only
    stream of a non-hierarchical mode)."""
    streams = {"hp": judge(ref, runs)}
    if hier:
        streams["lp"] = judge(ref, runs, "lp_")
    return {"pass": all(s["pass"] for s in streams.values()), **streams}


def run_curve(curve: tuple, device, seeds, shift_db: float = 0.0,
              demap: str | None = None) -> list[dict]:
    """Each point of ``curve`` (a CURVES entry) over ``seeds``, judged
    against the JAX curve at its own SNR; ``shift_db`` and ``demap`` plant
    a fault (run the chain that much lower, or with that demap)."""
    stem, mode, c_demap, profile, snrs, blocks = curve
    ref = reference(stem)
    points = []
    for snr in snrs:
        runs = [ber_sweep.run_point(mode, float(snr) + shift_db, blocks, seed,
                                    demap or c_demap, profile, device)
                for seed in seeds]
        points.append({"snr_db": float(snr),
                       **check_point(ref[float(snr)], runs,
                                     mode.hierarchical)})
    return points


def _line(stem: str, p: dict) -> str:
    return (f"{stem} {p['snr_db']:g} dB: " + ", ".join(
        f"{k} {s['check']} jax {s['jax']} mean {s.get('mean', s['per'])} "
        f"limit {s.get('limit')} {'pass' if s['pass'] else 'MISS'}"
        for k, s in p.items() if k in ("hp", "lp")))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(p)
    p.add_argument("--out", help="where to write the JSON artifact "
                   "(default on the card: docs/BER_H100.json)")
    p.add_argument("stems", nargs="*", help="curves to run (default: all)")
    a = p.parse_args(argv)
    device = device_from_args(a, "ber_curves")
    unknown = set(a.stems) - {c[0] for c in CURVES}
    if unknown:
        p.error(f"no such curve: {sorted(unknown)}")
    seeds = range(SEEDS)
    t_all = time.time()
    curves = {}
    for curve in CURVES:
        stem, mode, demap, profile, _, blocks = curve
        if a.stems and stem not in a.stems:
            continue
        t0 = time.time()
        points = run_curve(curve, device, seeds)
        for pt in points:
            print(_line(stem, pt), flush=True)
        curves[stem] = {"mode": dataclasses.asdict(mode), "demap": demap,
                        "profile": profile or "none", "blocks": blocks,
                        "wall_s": round(time.time() - t0, 4),
                        "points": points}
    planted = {}
    for curve in CURVES:
        stem, demap = curve[0], curve[2]
        if stem not in curves or stem not in FAULT_CURVES:
            continue
        other = "soft" if demap == "hard" else "hard"
        planted[stem] = {}
        for fault, kw in ((f"{FAULT_DB} dB lower", {"shift_db": -FAULT_DB}),
                          (f"{other} demap", {"demap": other})):
            points = run_curve(curve, device, seeds, **kw)
            failed = sum(not pt["pass"] for pt in points)
            planted[stem][fault] = {"failed": failed, "of": len(points),
                                    "points": points}
            print(f"planted fault {stem}, {fault}: fails {failed} of "
                  f"{len(points)} points", flush=True)
    streams = [s for c in curves.values() for pt in c["points"]
               for k, s in pt.items() if k in ("hp", "lp")]
    n_points = sum(len(c["points"]) for c in curves.values())
    n_pass = sum(pt["pass"] for c in curves.values() for pt in c["points"])
    toothless = [f"{stem}: {fault}" for stem, f in planted.items()
                 for fault, r in f.items() if r["failed"] == 0]
    artifact = {
        "device": card(device), "seeds": SEEDS,
        "rule": {"spread_k": SPREAD_K, "rel_floor": REL_FLOOR,
                 "per_zero_max": PER_ZERO_MAX, "per_null_min": PER_NULL_MIN,
                 "cliff_per": CLIFF_PER, "fault_db": FAULT_DB},
        "points_total": n_points, "points_passed": n_pass,
        "streams_total": len(streams),
        "streams_passed": sum(s["pass"] for s in streams),
        "wall_s": round(time.time() - t_all, 4),
        "curves": curves, "planted": planted}
    out = a.out or (DOCS / "BER_H100.json" if device.type == "cuda" else None)
    if out is not None:
        with open(out, "w") as f:
            json.dump(artifact, f, indent=1)
            f.write("\n")
    print(f"{n_pass}/{n_points} points within the rule on "
          f"{artifact['device']}; planted faults that no point caught: "
          f"{toothless or 'none'}{f' -> {out}' if out else ''}",
          file=sys.stderr, flush=True)
    return 0 if n_pass == n_points and not toothless else 1


if __name__ == "__main__":
    raise SystemExit(main())
