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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mode import DvbtMode

_TX_KEYS = ("dispersal_phase", "outer_tail", "coder_state", "frame_idx")
_RX_KEYS = ("deint_tail", "viterbi", "descr_phase", "descr_locked",
            "chan_tail", "chan_valid")
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


def _from_jax(jstate, keys, device) -> dict:
    if "lp" in jstate:
        raise NotImplementedError(
            "hierarchical state is not ported yet (ROADMAP queue 1, item 20)")
    if set(jstate) != set(keys):
        raise ValueError(f"state keys {sorted(jstate)} != {sorted(keys)}")

    def leaf(key, arr):
        arr = np.ascontiguousarray(np.asarray(arr))
        if arr.ndim == 0:
            raise ValueError(f"leaf {key!r} has no mux axis")
        return torch.as_tensor(arr, device=device).to(_DTYPES[key])

    return {k: ({n: leaf(k, a) for n, a in v.items()} if isinstance(v, dict)
                else leaf(k, v)) for k, v in jstate.items()}


def to_jax(state: dict) -> dict:
    """Port state -> the same tree of numpy arrays (leading mux axis)."""
    return {k: (to_jax(v) if isinstance(v, dict) else v.cpu().numpy())
            for k, v in state.items()}


def tx_state_from_jax(jstate: dict, device) -> dict:
    """Batched JAX TX state (numpy leaves, leading mux axis) -> tensors."""
    return _from_jax(jstate, _TX_KEYS, device)


def rx_state_from_jax(jstate: dict, device) -> dict:
    """Batched JAX RX state (numpy leaves, leading mux axis) -> tensors."""
    return _from_jax(jstate, _RX_KEYS, device)
