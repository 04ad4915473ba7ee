"""dvbt-rx: DVB-T baseband IQ file (complex64) -> MPEG-TS file.

    python3 -m dvbt_tpu_torch.apps.rx --in air.iq --out out.ts [-t 8k ...]

Counterpart of dvbt_tpu/apps/rx.py, with its flags and its output: full
acquisition (unknown timing, carrier offset and frame alignment are
recovered by models/loopback.StreamingReceiver) from a file or an SDR
source (io/source.open_source).  ``--device`` picks the card (``cuda``,
the default) or the CPU (``cpu``, only when asked); without a card the
default exits nonzero.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..io.source import open_source
from ..models.loopback import StreamingReceiver
from . import common
from .device import add_device_arg, device_from_args


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_mode_args(p)
    p.add_argument("--in", dest="infile", required=True,
                   help="input IQ source: raw-complex64 file path, or an "
                        "SDR URL (soapy://, usrp://, rtlsdr://)")
    p.add_argument("--out", dest="outfile", required=True,
                   help="output .ts file")
    p.add_argument("--out-lp", dest="outfile_lp",
                   help="LP-stream output .ts (hierarchical modes)")
    p.add_argument("--max-int-cfo", type=int, default=8,
                   help="integer CFO search range (subcarriers)")
    p.add_argument("--chunk", type=int, default=1 << 20,
                   help="file read chunk (samples)")
    add_device_arg(p)
    a = p.parse_args(argv)
    device = device_from_args(a, "rx")
    mode = common.mode_from_args(a)

    srx = StreamingReceiver(mode, device, max_int_cfo=a.max_int_cfo)
    n_pk = srx.n_packets[0] if mode.hierarchical else srx.n_packets
    flp = open(a.outfile_lp, "wb") if (mode.hierarchical and a.outfile_lp) \
        else None
    t0 = time.time()
    n_blocks = n_corr = n_bad = n_samples = 0

    def emit(rep):
        nonlocal n_blocks, n_corr, n_bad
        n_blocks += 1
        n_corr += int(rep.rs_corrected.sum())
        n_bad += int(rep.rs_uncorrectable.sum())
        if rep.reacquired:
            print(f"rx: acquired at sample {rep.stream_offset} "
                  f"(cfo {float(rep.info['cfo_frac']) + float(rep.info['cfo_int']):+.3f} "
                  f"subcarriers)", file=sys.stderr)
        rep.packets.tofile(fo)
        if flp is not None:
            rep.packets_lp.tofile(flp)

    src = open_source(a.infile)
    try:
        with open(a.outfile, "wb") as fo:
            while True:
                chunk = src.read(a.chunk)
                if len(chunk) == 0:
                    break
                n_samples += len(chunk)
                for rep in srx.feed(chunk):
                    emit(rep)
            for rep in srx.flush():
                emit(rep)
    finally:
        src.close()
        if flp is not None:
            flp.close()
    dt = time.time() - t0
    print(f"rx: {n_blocks} blocks, {n_blocks * n_pk} packets "
          f"(rs corrected bytes: {n_corr}, uncorrectable packets: {n_bad}) "
          f"from {n_samples} samples in {dt:.2f} s "
          f"[{n_samples / max(dt, 1e-9) / 1e6:.1f} Msps]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
