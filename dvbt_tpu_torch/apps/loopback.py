"""dvbt-loopback: TX -> impaired channel -> RX in one process; prints a JSON
report.

    python3 -m dvbt_tpu_torch.apps.loopback --blocks 8 --cfo 0.3 --snr 25

Counterpart of dvbt_tpu/apps/loopback.py, with its flags and its JSON
line (mode, blocks_tx, blocks_rx, snr_db, cfo, packets, rs_corrected,
rs_uncorrectable, byte_errors, bytes_compared, byte_error_rate, tx_msps,
rx_msps, useful_bitrate_mbps): the port's transmitter, channel models
and StreamingReceiver.  The noise comes from a ``torch.Generator`` seeded
with ``--seed``, not jax.random.  ``--device`` picks the card (``cuda``,
the default) or the CPU (``cpu``, only when asked); without a card the
default exits nonzero.  Exits 0 when the decoded TS is byte-exact (or
when ``--snr`` is given), else 1.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..io import ts as tsio
from ..models import channel, tx as txm
from ..models.loopback import StreamingReceiver
from ..ops import sync as syncop
from ..ops.outer_interleaver import DELAY_PACKETS
from . import common
from .device import add_device_arg, device_from_args


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_mode_args(p)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--snr", type=float, default=None, help="AWGN SNR in dB")
    p.add_argument("--cfo", type=float, default=0.0,
                   help="carrier offset in subcarrier spacings")
    p.add_argument("--offset", type=int, default=0,
                   help="drop this many leading samples (timing offset)")
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    a = p.parse_args(argv)
    device = device_from_args(a, "loopback")
    mode = common.mode_from_args(a)

    tx, n_pk, n_samp = txm.make_transmitter(mode, device)
    packets = tsio.make_ts_packets(n_pk * a.blocks, seed=a.seed)
    state = txm.init_tx_state(mode, 1, device)
    chunks = []
    t0 = time.time()
    for b in range(a.blocks):
        state, iq = tx(state, torch.as_tensor(
            packets[b * n_pk:(b + 1) * n_pk], device=device)[None])
        chunks.append(iq)
    stream = torch.cat(chunks, dim=-1)
    if a.cfo:
        stream = channel.apply_cfo(stream, a.cfo, mode.fft_len)
    if a.snr is not None:
        gen = torch.Generator(device=device).manual_seed(a.seed)
        stream = channel.awgn(gen, stream, a.snr)
    stream = stream[0].cpu().numpy()
    tx_s = time.time() - t0
    stream = stream[a.offset:]

    srx = StreamingReceiver(mode, device)
    t0 = time.time()
    reports = srx.feed(stream)
    rx_s = time.time() - t0

    out = np.concatenate([r.packets for r in reports]) if reports else \
        np.zeros((0, 188), np.uint8)
    # align the decoded stream to the TX packets by the detected block
    n_err_bytes = n_cmp = 0
    if len(out) > DELAY_PACKETS:
        k0 = ((reports[0].stream_offset + a.offset + syncop.DEFAULT_BACKOFF)
              // mode.samples_per_block)
        want = packets[k0 * n_pk:]
        got = out[DELAY_PACKETS:]
        n = min(len(got), len(want))
        n_err_bytes = int((got[:n] != want[:n]).sum())
        n_cmp = n * 188
    rs_bad = int(sum(r.rs_uncorrectable.sum() for r in reports))
    rs_corr = int(sum(r.rs_corrected.sum() for r in reports))
    report = {
        "mode": f"{mode.transmission}_{mode.constellation}_{mode.code_rate}"
                f"_gi{mode.guard}",
        "blocks_tx": a.blocks, "blocks_rx": len(reports),
        "snr_db": a.snr, "cfo": a.cfo,
        "packets": len(out), "rs_corrected": rs_corr,
        "rs_uncorrectable": rs_bad,
        "byte_errors": n_err_bytes, "bytes_compared": n_cmp,
        "byte_error_rate": n_err_bytes / n_cmp if n_cmp else None,
        "tx_msps": len(stream) / tx_s / 1e6,
        "rx_msps": len(stream) / rx_s / 1e6,
        "useful_bitrate_mbps": mode.useful_bitrate / 1e6,
    }
    print(json.dumps(report))
    return 0 if (n_cmp and n_err_bytes == 0) or a.snr is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
