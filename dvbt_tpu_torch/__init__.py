"""dvbt_tpu_torch — the DVB-T (ETSI EN 300 744) modem of ``dvbt_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``dvbt_tpu`` is the reference: each module here mirrors its
counterpart's path and contract, and the tests hold the two against each
other.  The port imports nothing of ``dvbt_tpu`` and nothing of JAX: the
mode object (``mode.py``), the EN 300 744 tables (``tables.py``) and the
test-stream helpers (``io/ts.py``) are its own copies, held equal to the
originals by the tests.

Layout:
  mode.py, tables.py, io/ts.py — mode object, EN 300 744 tables, TS
              packets and files
  blocks.py — the block registry: one descriptor per DSP block, as in the
              JAX package, with factories in this package
  ops/      — the DSP blocks: the flagship TX -> RX path, acquisition and
              synchronization, channel estimation and TPS
  kernels/  — CUDA kernels (csrc/*.cu) with their plain PyTorch versions
  models/   — make_transmitter / make_receiver (hard or soft demap, one
              stream or hierarchical HP + LP), batched over muxes, the
              channel models (AWGN, CFO, multipath, Annex B F1/P1) and
              the block-level receive chain from a raw capture (one
              stream or hierarchical HP + LP)
  apps/     — ber_sweep (``python3 -m dvbt_tpu_torch.apps.ber_sweep``):
              BER / PER against SNR, the JAX app's JSON line
  utils/    — bit packing, the puncture pattern, the (hp, lp) stream
              pairs of hierarchical modes, carried-state exchange with
              the JAX package
  bench.py  — the TX -> RX step as one CUDA graph (``GraphStep``), which
              the benchmark drives: ``python3 -m benchmark.run --workload
              <cell> --seed <n> --seconds <s> --trace <0|1>``, the cells
              uk_headend_8mux, de_headend_soft_8mux, hier_headend_8mux
              and uk_capture_8mux (BENCHMARK.json)
  profile_slice.py — per-stage device time of the flagship step

Factories take an explicit ``device``, build their tables there once and
return plain functions on tensors with a leading mux axis.  A kernel runs
when its input lies on a CUDA device; on the CPU its plain version runs.
"""

from .io.ts import make_ts_packets  # noqa: F401
from .mode import DvbtMode, MODE_2K_QPSK, MODE_8K_UK  # noqa: F401
