"""dvbt-tx: MPEG-TS file -> DVB-T baseband IQ file (complex64, 64/7 Msps).

    python3 -m dvbt_tpu_torch.apps.tx --in in.ts --out air.iq [-t 8k ...]

Counterpart of dvbt_tpu/apps/tx.py, with its flags and its output: the
whole TX chain runs on the device a block at a time, and the IQ goes to a
file or an SDR sink (io/source.open_sink).  ``--device`` picks the card
(``cuda``, the default) or the CPU (``cpu``, only when asked); without a
card the default exits nonzero.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..io import source as src
from ..io import ts as tsio
from ..models import tx as txm
from . import common
from .device import add_device_arg, device_from_args


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_mode_args(p)
    p.add_argument("--in", dest="infile",
                   help="input .ts file (default: synthesized test stream)")
    p.add_argument("--in-lp", dest="infile_lp",
                   help="LP-stream .ts file (hierarchical modes)")
    p.add_argument("--out", dest="outfile", required=True,
                   help="output IQ file (raw complex64)")
    p.add_argument("--packets", type=int, default=0,
                   help="limit / synthesize this many TS packets")
    p.add_argument("--blocks", type=int, default=0,
                   help="limit the number of super-blocks")
    add_device_arg(p)
    a = p.parse_args(argv)
    device = device_from_args(a, "tx")
    mode = common.mode_from_args(a)

    tx, n_pk, n_samp = txm.make_transmitter(mode, device)
    n_hp, n_lp = (n_pk if mode.hierarchical else (n_pk, 0))

    def load(path, per_block):
        if path:
            pk = tsio.read_ts_file(path)
            return pk[: a.packets] if a.packets else pk
        return tsio.make_ts_packets(a.packets or per_block * 8)

    packets = load(a.infile, n_hp)
    n_blocks = len(packets) // n_hp
    if mode.hierarchical:
        packets_lp = load(a.infile_lp, n_lp)
        n_blocks = min(n_blocks, len(packets_lp) // n_lp)
    if a.blocks:
        n_blocks = min(n_blocks, a.blocks)
    if n_blocks == 0:
        print(f"need at least {n_hp} packets per block", file=sys.stderr)
        return 2

    def block(pk, n, b):
        return torch.as_tensor(pk[b * n:(b + 1) * n], device=device)[None]

    state = txm.init_tx_state(mode, 1, device)
    t0 = time.time()
    sink = src.open_sink(a.outfile)     # file or SDR hardware
    try:
        for b in range(n_blocks):
            arg = ((block(packets, n_hp, b), block(packets_lp, n_lp, b))
                   if mode.hierarchical else block(packets, n_hp, b))
            state, iq = tx(state, arg)
            sink.write(iq[0].cpu().numpy())
    finally:
        sink.close()
    dt = time.time() - t0
    total = n_blocks * n_samp
    print(f"tx: {n_blocks} blocks, {n_blocks * n_hp} packets, "
          f"{total} samples ({total / mode.sample_rate:.2f} s of air time) "
          f"in {dt:.2f} s [{total / dt / 1e6:.1f} Msps]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
