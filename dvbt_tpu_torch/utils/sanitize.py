"""Numeric sanitizer: NaN/Inf scanning of every op of a call.

Counterpart of dvbt_tpu/utils/sanitize.py, which runs the receive chain
under ``checkify.float_checks``.  Here a ``TorchDispatchMode`` sees every
ATen op a call runs and scans each floating or complex output for NaN or
Inf; the first op that yields one raises ``FloatingPointError`` naming
it.  Views are not scanned: they alias a tensor that is.  A debug tool
for diagnosing a numeric corruption (every scan reads the device back),
never on the bench path.

Usage::

    rx, n_packets, n_samples = make_checked_receiver(mode, device)
    state, ts, metrics = rx(state, iq)      # raises on NaN/Inf
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class _FloatChecks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_flatten(out)[0]:
                if (isinstance(t, torch.Tensor)
                        and (t.is_floating_point() or t.is_complex())
                        and not bool(torch.isfinite(t).all())):
                    raise FloatingPointError(
                        f"{func} produced NaN or Inf (output "
                        f"{t.dtype}{tuple(t.shape)})")
        return out


def checked(fn):
    """``fn`` with every floating or complex op output scanned for NaN and
    Inf: the returned callable raises ``FloatingPointError`` naming the
    first op that yields one."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return run


def make_checked_receiver(mode, device, n_frames=None, **kwargs):
    """``models.rx.make_receiver`` with NaN/Inf scanning on every op."""
    from ..models import rx as rxm

    rx, n_packets, n_samples = rxm.make_receiver(mode, device, n_frames,
                                                 **kwargs)
    return checked(rx), n_packets, n_samples
