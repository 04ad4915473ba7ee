"""Carried TX/RX state between the JAX package and this port.

The port's state dicts have the JAX package's leaves under the same keys,
with a leading mux axis on every leaf (the layout ``jax.vmap`` gives a
batched JAX state).  These helpers take such a JAX state as numpy arrays
and return the port's tensors, and back, so a stream can be handed over
mid-way in either direction.  DVB-T has no weights: both sides build their
static tables from the same EN 300 744 definitions.

``mode_from_jax`` gives the port's DvbtMode for a mode of the JAX package,
field by field.

TX leaves: dispersal_phase, outer_tail, coder_state, frame_idx.
RX leaves: deint_tail, viterbi {x, y, xm, ym}, descr_phase, descr_locked,
chan_tail (complex), chan_valid.
Hierarchical modes add the LP stream's leaves under ``"lp"``: the TX
stream leaves (dispersal_phase, outer_tail, coder_state) or the RX stream
leaves (deint_tail, viterbi, descr_phase, descr_locked).
The time-sharded loopback's carry (parallel/time_sharding.py) goes across
with ``carry_from_jax`` / ``carry_to_jax``; in hierarchical modes its
packet tail is the (hp, lp) pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mode import DvbtMode

_TX_STREAM_KEYS = ("dispersal_phase", "outer_tail", "coder_state")
_RX_STREAM_KEYS = ("deint_tail", "viterbi", "descr_phase", "descr_locked")
_TX_KEYS = _TX_STREAM_KEYS + ("frame_idx",)
_RX_KEYS = _RX_STREAM_KEYS + ("chan_tail", "chan_valid")
_DTYPES = {
    "dispersal_phase": torch.int32, "outer_tail": torch.uint8,
    "coder_state": torch.uint8, "frame_idx": torch.int32,
    "deint_tail": torch.uint8, "viterbi": torch.uint8,
    "descr_phase": torch.int32, "descr_locked": torch.bool,
    "chan_tail": torch.complex64, "chan_valid": torch.bool,
}


def mode_from_jax(jmode) -> DvbtMode:
    """The port's DvbtMode with the fields of `jmode` (a DvbtMode of the JAX
    package, or any object with the same fields)."""
    return DvbtMode(**{f.name: getattr(jmode, f.name)
                       for f in dataclasses.fields(DvbtMode)})


def _from_jax(jstate, keys, lp_keys, device) -> dict:
    want = set(keys) | ({"lp"} if "lp" in jstate else set())
    if set(jstate) != want:
        raise ValueError(f"state keys {sorted(jstate)} != {sorted(want)}")

    def leaf(key, arr):
        arr = np.array(arr)             # a writable, contiguous copy
        if arr.ndim == 0:
            raise ValueError(f"leaf {key!r} has no mux axis")
        return torch.as_tensor(arr, device=device).to(_DTYPES[key])

    out = {k: ({n: leaf(k, a) for n, a in v.items()} if isinstance(v, dict)
               else leaf(k, v))
           for k, v in jstate.items() if k != "lp"}
    if "lp" in jstate:
        out["lp"] = _from_jax(jstate["lp"], lp_keys, (), device)
    return out


def to_jax(state: dict) -> dict:
    """Port state -> the same tree of numpy arrays (leading mux axis)."""
    return {k: (to_jax(v) if isinstance(v, dict) else v.cpu().numpy())
            for k, v in state.items()}


def tx_state_from_jax(jstate: dict, device) -> dict:
    """Batched JAX TX state (numpy leaves, leading mux axis) -> tensors."""
    return _from_jax(jstate, _TX_KEYS, _TX_STREAM_KEYS, device)


def rx_state_from_jax(jstate: dict, device) -> dict:
    """Batched JAX RX state (numpy leaves, leading mux axis) -> tensors."""
    return _from_jax(jstate, _RX_KEYS, _RX_STREAM_KEYS, device)


def _packet_tail(pk, device) -> torch.Tensor:
    pk = np.array(pk)                   # a writable copy
    if pk.dtype != np.uint8 or pk.ndim != 2:
        raise ValueError(f"packet tail {pk.dtype}{pk.shape} is not uint8 "
                         "(packets, 188)")
    return torch.as_tensor(pk, device=device)


def carry_from_jax(jcarry, device) -> tuple:
    """The JAX time-sharded loopback's carry (prev_pk (12, 188) uint8, in
    hierarchical modes the (hp, lp) pair of them; prev_iq (H * symbol_len,)
    complex64; step_idx int32), as numpy arrays or scalars -> the port's
    carry (tensors on ``device``, int step)."""
    prev_pk, prev_iq, step_idx = jcarry
    if isinstance(prev_pk, (tuple, list)):
        pk = tuple(_packet_tail(p, device) for p in prev_pk)
    else:
        pk = _packet_tail(prev_pk, device)
    iq = np.array(prev_iq)
    if iq.ndim != 1:
        raise ValueError(f"sample tail {iq.dtype}{iq.shape} is not 1-D")
    return (pk, torch.as_tensor(iq.astype(np.complex64), device=device),
            int(step_idx))


def carry_to_jax(carry) -> tuple:
    """The port's time-sharded carry -> numpy (prev_pk uint8 or the (hp,
    lp) pair, prev_iq complex64, np.int32 step_idx), the leaves of the
    JAX carry."""
    prev_pk, prev_iq, step_idx = carry
    pk = (tuple(p.cpu().numpy() for p in prev_pk)
          if isinstance(prev_pk, tuple) else prev_pk.cpu().numpy())
    return pk, prev_iq.cpu().numpy(), np.int32(step_idx)
