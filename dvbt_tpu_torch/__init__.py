"""dvbt_tpu_torch — the DVB-T (ETSI EN 300 744) modem of ``dvbt_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``dvbt_tpu`` is the reference: each module here mirrors its
counterpart's path and contract, and the tests hold the two against each
other.  The mode object, the EN 300 744 tables and the test-stream
generator are reused from ``dvbt_tpu`` (those modules import no JAX);
nothing here imports JAX.

Layout:
  ops/      — the DSP blocks of the flagship TX -> RX path
  kernels/  — CUDA kernels (csrc/*.cu) with their plain PyTorch versions
  models/   — make_transmitter / make_receiver, batched over muxes
  utils/    — bit packing, the puncture pattern, carried-state exchange
              with the JAX package
  profile_slice.py — per-stage device time of the flagship step

Factories take an explicit ``device``, build their tables there once and
return plain functions on tensors with a leading mux axis.  A kernel runs
when its input lies on a CUDA device; on the CPU its plain version runs.
"""

from dvbt_tpu.io.ts import make_ts_packets  # noqa: F401
from dvbt_tpu.mode import DvbtMode, MODE_2K_QPSK, MODE_8K_UK  # noqa: F401
