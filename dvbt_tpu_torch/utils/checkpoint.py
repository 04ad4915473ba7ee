"""Checkpoint / resume of carried state.

Counterpart of dvbt_tpu/utils/checkpoint.py: every chain's carried state
is a nested dict (tuples and lists allowed) of tensors, so a mid-stream
suspend and resume is writing it out.  ``np.savez`` files whose keys are
the joined paths of the leaves ("viterbi/x", "chan_tail"), as the JAX
package writes them, so a file is self-describing; extras go under
``__extra__/``.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, prefix: str = ""):
    """[(path, leaf)] of a nested dict/tuple/list in the order of its
    keys as given (dicts) or of its items."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _rebuild(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(
            _rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(like))
    return leaves[prefix]


def state_to_arrays(state) -> dict:
    """Nested state -> {path: np.ndarray} (host copies)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in _leaves(state)}


def save_state(path: str, state, **extra) -> None:
    """Write a carried state (and scalar or array extras) to ``path``."""
    arrays = state_to_arrays(state)
    arrays.update({f"__extra__/{k}": np.asarray(v) for k, v in extra.items()})
    np.savez(path, **arrays)


def load_state(path: str, like):
    """Read a state written by save_state; ``like`` gives the structure
    and each leaf's device and dtype (e.g. models.rx.init_rx_state(mode,
    1, device)).  Returns (state, extras).  Raises KeyError for a leaf the
    file lacks and ValueError for one of another shape."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    extras = {k.split("/", 1)[1]: data.pop(k)
              for k in list(data) if k.startswith("__extra__/")}
    leaves = {}
    for k, leaf in _leaves(like):
        if k not in data:
            raise KeyError(f"checkpoint missing leaf {k!r}")
        arr = data[k]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"leaf {k!r}: checkpoint shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        leaves[k] = torch.as_tensor(arr).to(leaf.device, leaf.dtype)
    return _rebuild(like, leaves), extras
