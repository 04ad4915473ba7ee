"""BER / packet-error rate against SNR over TX -> [Annex B profile] ->
AWGN -> RX, on the card.

    python3 -m dvbt_tpu_torch.apps.ber_sweep -t 8k -c 64qam -r 2/3 \\
        --snrs 16,18,20 --demap soft --profile P1

Counterpart of dvbt_tpu/apps/ber_sweep.py, with its flags, its
``run_point`` and its JSON line, one per SNR point:
  {"device": "gpu", "snr_db": ..., "ber_post_viterbi": ..., "ber_post_rs":
   ..., "byte_err_post_rs": ..., "per": ..., "packets": ..., [lp_...],
   "demap": ..., "profile": ...}
post-Viterbi BER is measured on the 204-byte RS codewords (pre-RS bytes),
post-RS BER on the descrambled TS bytes.  ``--device`` picks the card
(``cuda``, the default) or the CPU (``cpu``, only when asked); without a
card the default exits nonzero.  The noise comes from a
``torch.Generator`` seeded with seed + 1, so points agree with the JAX
app's statistically, not bit for bit.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

from ..io import ts as tsio
from ..models import channel, rx as rxm, tx as txm
from ..ops.outer_interleaver import DELAY_PACKETS
from ..utils.streams import join, split
from . import common
from .device import add_device_arg, device_from_args


@functools.lru_cache(maxsize=8)
def _build(mode, demap: str, device: torch.device):
    """One tx/rx pair per (mode, demap, device): a sweep re-uses the
    factories' tables across its SNR points."""
    tx, n_pk, _ = txm.make_transmitter(mode, device)
    rx, _, _ = rxm.make_receiver(mode, device, demap=demap,
                                 measure_pre_rs=True)
    return tx, rx, n_pk


def run_point(mode, snr_db: float, n_blocks: int, seed: int = 0,
              demap: str = "hard", profile: str | None = None,
              device="cuda"):
    """One BER point over TX -> [Annex B profile] -> AWGN -> RX, one mux.

    profile: None (AWGN only), "F1" (fixed/Ricean) or "P1"
    (portable/Rayleigh) — channel.annex_b_taps."""
    device = torch.device(device)
    tx, rx, n_pk = _build(mode, demap, device)
    hier = mode.hierarchical
    n_pk = split(n_pk, hier)
    # each stream's packets; the LP stream's from its own seed
    packets = [tsio.make_ts_packets(n * n_blocks, seed=seed + 100 * k)
               for k, n in enumerate(n_pk)]
    tst = txm.init_tx_state(mode, 1, device)
    rst = rxm.init_rx_state(mode, 1, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    taps = channel.annex_b_taps(profile) if profile else None
    prefixes = ("", "lp_")[:len(n_pk)]
    acc = [([], [], []) for _ in prefixes]
    for b in range(n_blocks):
        tst, iq = tx(tst, join([torch.as_tensor(
            pk[b * n:(b + 1) * n], device=device)[None]
            for pk, n in zip(packets, n_pk)], hier))
        if taps is not None:
            iq = channel.multipath(iq, taps)
        rst, out, m = rx(rst, channel.awgn(gen, iq, snr_db))
        for a, ts_s, pre in zip(acc, split(out, hier), prefixes):
            a[0].append(ts_s[0].cpu().numpy())
            a[1].append(m[f"{pre}rs_uncorrectable"][0].cpu().numpy())
            a[2].append(m[f"{pre}pre_rs_bit_errors"][0].cpu().numpy())

    def stats(outs, bads, pres, want_pk):
        out = np.concatenate(outs)[DELAY_PACKETS:]
        bad = np.concatenate(bads)[DELAY_PACKETS:]
        pre = np.concatenate(pres)[DELAY_PACKETS:]
        want = want_pk[: len(out)]
        # post-RS: byte/bit errors on the recovered TS
        diff = out != want
        bit_err_rs = int(np.unpackbits(out ^ want).sum())
        n_bits = out.size * 8
        # post-Viterbi (pre-RS) BER: exact on correctable packets — the
        # receiver re-encodes each corrected RS message and XORs with its
        # received 204-B codeword (metrics[...pre_rs_bit_errors]);
        # uncorrectable packets are excluded (their true error count is
        # unknowable, >= 9 bytes).
        ok = bad == 0
        pre_rs_bits = int(ok.sum()) * 204 * 8
        return {
            "ber_post_viterbi": (float(pre[ok].sum()) / pre_rs_bits
                                 if pre_rs_bits else None),
            "ber_post_rs": bit_err_rs / n_bits if n_bits else None,
            "byte_err_post_rs": int(diff.sum()),
            "per": float(bad.mean()) if len(bad) else 0.0,
            "packets": int(len(out)),
        }

    result = {"device": "gpu" if device.type == "cuda" else "cpu",
              "snr_db": snr_db}
    for pre, a, pk in zip(prefixes, acc, packets):
        result.update({f"{pre}{k}": v for k, v in stats(*a, pk).items()})
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_mode_args(p)
    p.add_argument("--snrs", default="2,4,6,8,10,12",
                   help="comma-separated SNR points in dB")
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--demap", choices=["hard", "soft"], default="hard",
                   help="hard = reference parity; soft = 4-bit max-log "
                        "metrics into the soft Viterbi (~2 dB gain)")
    p.add_argument("--profile", choices=["none", "F1", "P1"], default="none",
                   help="EN300744 Annex B propagation profile before AWGN")
    add_device_arg(p)
    a = p.parse_args(argv)
    device = device_from_args(a, "ber_sweep")
    mode = common.mode_from_args(a)
    profile = None if a.profile == "none" else a.profile
    for snr in [float(s) for s in a.snrs.split(",")]:
        print(json.dumps({**run_point(mode, snr, a.blocks, a.seed, a.demap,
                                      profile, device),
                          "demap": a.demap, "profile": a.profile}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
