"""Faults and controls planted under a run's timed path: each is a context
manager that wraps the program's functions that a driver calls, so the
rest of the run (inputs, window, checks) is the run's own.

Faults, each of which has to make ``correct`` come out false:

- ``altered``: one byte of one TS packet changed where it is produced (in
  a hierarchical head-end, of the LP stream only);
- ``stale_state``: the step returns its carried state unchanged;
- ``half_batch``: the second half of the muxes (captures) left out, their
  TS zero (on both streams of a hierarchical head-end);
- ``ref_bf16``: the head-end cells' control: the plain reference
  transmitter in the program's place, computed in bfloat16 (the step runs
  eagerly: the reference launches neither of the kernels the program's
  graph holds);
- ``cfo_bias``: the acquisition's carrier offset estimate off by
  ``CFO_BIAS`` subcarrier, four times the residual the configuration
  allows;
- ``timing_early``: the acquisition's FFT window two guard intervals
  early, outside the guard.

Readings, planted to see what a number reads and not held to fail:

- ``sync_fp32``: the acquisition's running sums in single precision
  (complex64 and float32) where the program takes them in double: the
  step a rewrite of the synchronizer would be tempted to take.

Not every cell can have every fault: a stream carries one mux, and the
block path starts every capture from the receiver's initial state.
"""

from __future__ import annotations

import contextlib

import numpy as np

from .drivers.graph_step import join, streams

FAULTS = {
    "graph_step": ("altered", "stale_state", "half_batch", "ref_bf16"),
    "stream_feeder": ("altered", "stale_state", "cfo_bias"),
    "capture_passes": ("altered", "half_batch", "cfo_bias", "timing_early"),
}
READINGS = {
    "graph_step": (),
    "stream_feeder": ("sync_fp32",),
    "capture_passes": ("sync_fp32",),
}
# subcarriers added to the estimated carrier offset by ``cfo_bias``
CFO_BIAS = 0.02


def _alter(ts):
    """One byte changed; of a (HP, LP) pair, in the LP stream."""
    *rest, last = streams(ts)
    last = last.clone()
    last[0, last.shape[1] // 2, 5] ^= 1
    return join((*rest, last))


def _halve(ts):
    halved = []
    for t in streams(ts):
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        halved.append(t)
    return join(tuple(halved))


def _acquisition_fp32(mode, n_samples: int):
    """The program's CP-correlation acquisition
    (``ops/ofdm.make_symbol_acquisition``) with its running sums taken in
    single precision."""
    import torch
    N, G = mode.fft_len, mode.guard_len
    L = N + G
    n_folds = (n_samples - N - G) // L
    rho = 0.1

    def acquire(iq):
        r = iq.to(torch.complex64)
        a, b = r[..., : n_samples - N], r[..., N:]
        prod = a * b.conj()
        eng = (a.abs() ** 2 + b.abs() ** 2) * 0.5
        cs = torch.nn.functional.pad(torch.cumsum(prod, -1), (1, 0))
        ce = torch.nn.functional.pad(torch.cumsum(eng, -1), (1, 0))
        gamma = cs[..., G:] - cs[..., :-G]
        phi = ce[..., G:] - ce[..., :-G]
        metric = gamma.abs() - rho * phi
        usable = n_folds * L
        m = metric[..., :usable].reshape(*metric.shape[:-1], n_folds, L)
        g = gamma[..., :usable].reshape(*metric.shape[:-1], n_folds, L)
        theta = m.sum(-2).argmax(-1)
        g_sum = torch.gather(g.sum(-2), -1, theta[..., None])[..., 0]
        cfo = (-torch.angle(g_sum) / (2.0 * np.pi)).to(torch.float32)
        return theta.to(torch.int32), cfo

    return acquire


def _reference_tx(ctx, make_tx):
    """``make_transmitter`` with the reference in bfloat16 in its place:
    each step transmits the previous step's packets and its own from the
    reference's start and keeps the second half, which is what a
    transmitter carried across steps sends (a step is whole superframes)."""
    import torch
    from .reference import tx as reference
    rmode = reference.mode_from(ctx.config)

    def make(*a, **k):
        _, n_pk, n_samp = make_tx(*a, **k)
        last: list = []

        def tx(st, pk):
            pk = streams(pk)
            prev = last or [torch.zeros_like(p) for p in pk]
            both = join(tuple(torch.cat([a, b], dim=1)
                              for a, b in zip(prev, pk)))
            iq = reference.transmit(rmode, both, "bfloat16")[:, n_samp:]
            last[:] = [p.clone() for p in pk]
            return st, iq.to(torch.complex64)
        return tx, n_pk, n_samp
    return make


@contextlib.contextmanager
def planted(driver: str, fault: str, ctx=None):
    """Plant ``fault`` (or a reading) under the driver ``driver`` while
    the block runs; ``ref_bf16`` needs the run's context."""
    if fault not in FAULTS[driver] + READINGS[driver]:
        raise ValueError(f"{driver} cannot have the fault {fault!r}")
    from dvbt_tpu_torch import bench
    from dvbt_tpu_torch.models import flowgraph, loopback
    from dvbt_tpu_torch.models import rx as rxm
    from dvbt_tpu_torch.models import tx as txm
    from dvbt_tpu_torch.ops import ofdm

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    if fault in ("cfo_bias", "timing_early", "sync_fp32"):
        make_acq = ofdm.make_symbol_acquisition
        if fault == "sync_fp32":
            patch(ofdm, "make_symbol_acquisition", _acquisition_fp32)
        else:
            def make_acq_bad(mode, n_samples):
                acquire = make_acq(mode, n_samples)
                L = mode.fft_len + mode.guard_len

                def bad(iq):
                    theta, cfo = acquire(iq)
                    if fault == "cfo_bias":
                        return theta, cfo + CFO_BIAS
                    return (theta - 2 * mode.guard_len) % L, cfo
                return bad
            patch(ofdm, "make_symbol_acquisition", make_acq_bad)
    elif driver == "graph_step":
        make_rx, make_tx = rxm.make_receiver, txm.make_transmitter
        if fault == "ref_bf16":
            patch(txm, "make_transmitter", _reference_tx(ctx, make_tx))
            patch(bench, "GraphStep", lambda eager, *a, **k: eager)
        elif fault == "stale_state":
            def make_tx_stale(*a, **k):
                tx, n_pk, n_samp = make_tx(*a, **k)
                return (lambda st, pk: (st, tx(st, pk)[1])), n_pk, n_samp
            patch(txm, "make_transmitter", make_tx_stale)
        else:
            wrap = _alter if fault == "altered" else _halve

            def make_rx_bad(*a, **k):
                rx, n_pk, n_samp = make_rx(*a, **k)

                def bad(st, iq):
                    st, ts, met = rx(st, iq)
                    return st, wrap(ts), met
                return bad, n_pk, n_samp
            patch(rxm, "make_receiver", make_rx_bad)
    elif driver == "stream_feeder":
        cls = loopback.StreamingReceiver
        init = cls.__init__

        def init_bad(self, *a, **k):
            init(self, *a, **k)
            track_rx = self.track_rx

            def bad(rx_state, *args):
                new, phase, ts, met = track_rx(rx_state, *args)
                if fault == "stale_state":
                    return rx_state, phase, ts, met
                return new, phase, _alter(ts), met
            self.track_rx = bad
        patch(cls, "__init__", init_bad)
    else:
        make = flowgraph.make_block_receiver
        wrap = _alter if fault == "altered" else _halve

        def make_bad(*a, **k):
            rx, n_pk = make(*a, **k)

            def bad(st, cap):
                st, ts, info = rx(st, cap)
                return st, wrap(ts), info
            return bad, n_pk
        patch(flowgraph, "make_block_receiver", make_bad)
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)
