"""The program's TX -> RX step captured into one CUDA graph: the step the
benchmark's head-end cells drive (``python3 -m benchmark.run``, through
``benchmark/drivers/graph_step.py``).

``make_step(..., graph=True)`` captures one TX + RX step (TX, then
symbol-aligned RX with ``metrics="min"``, batched over muxes) once into a
CUDA graph over static input tensors (``GraphStep``) and replays it every
call; the carried state comes back into the static inputs by one ``copy_``
per state leaf captured at the end of the graph.  ``graph=False`` runs the
same step eagerly.  A hierarchical mode's step takes and gives (HP, LP)
pairs, as the program's transmitter and receiver do: packets, TS and
uncorrectable flags, one static input a stream in the graph.  At capture
``GraphStep`` holds each kernel's launches in the graph, read from the
port's one launch count (``kernels/_build.launches``), to
``captured_launches``.
"""

from __future__ import annotations

import contextlib

import torch

from .kernels import _build
from .mode import DvbtMode
from .models import rx as rxm
from .models import tx as txm
from .utils.streams import join, split
from .utils.telemetry import Recorder, stage

GRAPH_WARMUP_STEPS = 2          # eager steps on a side stream before capture
# each kernel's launches in the captured step of one stream: the RS encoder
# and K2 code it, the demap kernel demaps it, K1 and the RS decoder decode
# it, once each; a hierarchical step launches each once a stream but the
# demap, which writes both streams' metrics in one launch
# (``captured_launches``)
CAPTURED_LAUNCHES = {"byte_coder": 1, "viterbi_punct": 1, "rs_decode": 1,
                     "rs_encode": 1, "demap": 1}
ONCE_A_STEP = ("demap",)


def captured_launches(packets) -> dict:
    """Each kernel's launches expected in the captured step that takes
    ``packets``: ``CAPTURED_LAUNCHES`` once a stream, so twice for a
    hierarchical mode's (HP, LP) pair, but those in ``ONCE_A_STEP`` once
    a step."""
    n = 2 if isinstance(packets, (tuple, list)) else 1
    return {k: v if k in ONCE_A_STEP else n * v
            for k, v in CAPTURED_LAUNCHES.items()}


def state_leaves(tx_state: dict, rx_state: dict) -> list:
    """[(name, tensor)] of both carried states, nested dicts flattened."""
    out = []

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                out.append((prefix + k, v))

    walk("tx.", tx_state)
    walk("rx.", rx_state)
    return out


class GraphStep:
    """One TX + RX step captured into a CUDA graph and replayed a call.

    ``step(tst, rst, packets) -> (tst', rst', ts, rs_uncorrectable)``, with
    ``packets`` one tensor or, in a hierarchical mode, the (HP, LP) pair,
    and ``ts`` and ``rs_uncorrectable`` alike.  The returned states are the
    graph's static inputs, updated in place by the replay; passed back in,
    they cost no copy (any other tensors are copied in first, a stream's
    packets too).  ``ts`` and ``rs_uncorrectable`` live in the graph's
    pool and are overwritten by the next replay: clone what is kept.
    ``captured`` holds each kernel's launches in the captured step, which
    every replay launches again: ``captured_launches(packets)``, or the
    capture fails.

    The captured body, state copy-back included, runs in the stage
    ``graph_step``.  With ``telemetry`` (a ``utils.telemetry.Recorder``),
    the step is captured with the recorder active, so that each stage's
    CUDA events are nodes of the graph and every replay records them:
    after a replay and a synchronize, ``telemetry.collect()`` reads that
    replay's device time of each stage.  Without it the graph holds the
    step's operations alone."""

    def __init__(self, eager, tst: dict, rst: dict, packets,
                 telemetry: Recorder | None = None):
        self._hier = isinstance(packets, (tuple, list))
        self._packets = split(packets, self._hier)
        dev = self._packets[0].device
        # the graph reads the step's tables (the closures' tensors) by
        # address: keep them alive as long as the graph
        self._eager = eager
        self._tst, self._rst = tst, rst
        self._static = state_leaves(tst, rst)
        # cuFFT plans, the kernel library and K1's launch attributes are
        # made by eager steps; none of them may be made during capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_STEPS):
                eager(tst, rst, packets)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _build.launches.copy()
        self.graph = torch.cuda.CUDAGraph()
        try:
            recording = (contextlib.nullcontext() if telemetry is None
                         else telemetry)
            with recording, torch.cuda.graph(self.graph), \
                    stage("graph_step"):
                new_t, new_r, self._ts, self._bad = eager(tst, rst, packets)
                new = state_leaves(new_t, new_r)
                _check_new_state(new, self._static)
                for (_, dst), (_, src) in zip(self._static, new):
                    dst.copy_(src)
        except Exception as e:
            raise RuntimeError(f"capturing the TX -> RX step into a CUDA "
                               f"graph failed: {e}") from e
        self.captured = dict(_build.launches - before)
        want = captured_launches(packets)
        if self.captured != want:
            raise RuntimeError(f"the captured step launched the kernels "
                               f"{self.captured}, not {want}")

    def __call__(self, tst: dict, rst: dict, packets):
        given = state_leaves(tst, rst)
        if [n for n, _ in given] != [n for n, _ in self._static]:
            raise ValueError("the carried state does not have the captured "
                             "step's leaves")
        for (_, dst), (_, src) in zip(self._static, given):
            if src is not dst:
                dst.copy_(src)
        if isinstance(packets, (tuple, list)) != self._hier:
            raise ValueError("the captured step takes "
                             + ("the (HP, LP) pair of packets" if self._hier
                                else "one tensor of packets"))
        for dst, src in zip(self._packets, split(packets, self._hier),
                            strict=True):
            if src is not dst:
                dst.copy_(src)
        self.graph.replay()
        return self._tst, self._rst, self._ts, self._bad


def _check_new_state(new: list, static: list) -> None:
    """Each new leaf is copied into the static input of its name at the end
    of the graph: the leaves must pair up by name, type and shape, and no
    copy may overwrite a static input that a later copy reads."""
    if [(n, t.dtype, t.shape) for n, t in new] != [
            (n, t.dtype, t.shape) for n, t in static]:
        raise RuntimeError("the step's new state does not match its input "
                           "state leaf for leaf")
    ptrs = {t.untyped_storage().data_ptr(): name for name, t in static}
    for (name, t), (_, dst) in zip(new, static):
        hit = ptrs.get(t.untyped_storage().data_ptr())
        if hit is not None and t is not dst:
            raise RuntimeError(f"new state leaf {name} aliases the static "
                               f"input {hit}")


def make_step(mode: DvbtMode, device, n_mux: int, n_frames: int,
              graph: bool = True, demap: str = "hard",
              telemetry: Recorder | None = None):
    """The head-end step: ``step(tst, rst, packets) -> (tst', rst', ts,
    rs_uncorrectable)`` with packets uint8 (n_mux, n_packets, 188), ts
    alike and rs_uncorrectable bool (n_mux, n_packets).  In a hierarchical
    mode each of the three is the (HP, LP) pair, n_packets the (n_hp,
    n_lp) pair, and the flags are the receiver's ``rs_uncorrectable`` and
    ``lp_rs_uncorrectable``.  The receiver demaps as ``demap`` says
    ("hard", or "soft": CSI-weighted max-log).

    ``graph=True`` captures the step into a CUDA graph (``GraphStep``,
    over zeroed static packets of each stream); it needs a CUDA device
    and raises where capture fails.  ``graph=False`` returns the eager
    step.  Either has ``n_packets`` and ``n_samples`` (per mux)
    attributes.

    With ``telemetry`` (a ``utils.telemetry.Recorder``) every call records
    one span per stage: the graph's stage events are captured into it, the
    eager step runs with the recorder active.  After a call, synchronize,
    then ``telemetry.collect()``; ``telemetry.summary()`` gives each
    stage's device ms a step (``rs_decode``, ``demap_deinterleave``,
    ``viterbi_decode``, ...; ``graph_step`` is the whole replay, and its
    ``self_device_ms`` the device time in no named stage)."""
    device = torch.device(device)
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, not {device}")
    tx, n_pk, n_samp = txm.make_transmitter(mode, device, n_frames)
    rx, _, _ = rxm.make_receiver(mode, device, n_frames, metrics="min",
                                 demap=demap)

    hier = mode.hierarchical
    # the receiver's uncorrectable flags of each stream, HP first
    flags = ("rs_uncorrectable", "lp_rs_uncorrectable")[:1 + hier]

    def eager(tst, rst, packets):
        tst, iq = tx(tst, packets)
        rst, ts, met = rx(rst, iq)
        return tst, rst, ts, join([met[f] for f in flags], hier)

    if graph:
        step = GraphStep(
            eager, txm.init_tx_state(mode, n_mux, device),
            rxm.init_rx_state(mode, n_mux, device),
            join([torch.zeros(n_mux, n, 188, dtype=torch.uint8,
                              device=device)
                  for n in split(n_pk, hier)], hier),
            telemetry=telemetry)
    elif telemetry is not None:
        def step(tst, rst, packets):
            with telemetry:
                return eager(tst, rst, packets)
    else:
        step = eager
    step.n_packets, step.n_samples = n_pk, n_samp
    return step
