"""Complex helpers.

Counterpart of dvbt_tpu/utils/cplx.py.  Only ``cis`` is needed: the JAX
package's ``czeros`` builds complex zeros on a TPU backend that cannot
create them eagerly, and ``torch.zeros(..., dtype=torch.complex64)`` has
no such gap.
"""

from __future__ import annotations

import torch


def cis(ang: torch.Tensor) -> torch.Tensor:
    """exp(1j * ang) for real `ang`, as cos + j*sin in complex64."""
    ang = torch.as_tensor(ang, dtype=torch.float32)
    return torch.complex(torch.cos(ang), torch.sin(ang))
