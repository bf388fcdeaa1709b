"""Hand the reference package's numpy arrays to the port.

`np.asarray` of a JAX array is read-only, and `torch.from_numpy` warns on
(and would alias) such an array, so read-only inputs are copied.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, dtype, device):
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def from_reference(dm=None, grouping=None, perms=None, *, device):
    """(dm f32, grouping int32, perms int32) as tensors on `device`; an
    argument left as None stays None."""
    return (None if dm is None else _tensor(dm, torch.float32, device),
            None if grouping is None else _tensor(grouping, torch.int32,
                                                  device),
            None if perms is None else _tensor(perms, torch.int32, device))
