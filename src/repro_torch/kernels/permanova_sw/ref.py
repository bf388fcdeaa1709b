"""Plain PyTorch versions the permanova_sw kernels are held against.

Twin of `repro/kernels/permanova_sw/ref.py`: the vectorized brute force
(tied back to the literal Algorithm 1 in core.fstat by the tests), plus a
float64 numpy version for tolerance calibration, and `tf32_round`, the
rounding the matmul kernel's tensor-core split applies (for the tests
that pin why it takes two TF32 products).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fstat

# The brute-force form holds (block, n, n) temporaries; cap block * n^2 so
# the plain version stays runnable on the card at the paper's n.
_MAX_BLOCK_ELEMS = 2 ** 28


def sw_ref(mat2: torch.Tensor, groupings: torch.Tensor,
           inv_group_sizes: torch.Tensor) -> torch.Tensor:
    """(n_perms,) f32 s_W via the vectorized upper-triangle brute force."""
    n = mat2.shape[0]
    block = max(1, min(8, groupings.shape[0], _MAX_BLOCK_ELEMS // (n * n)))
    return fstat.sw_brute(mat2, groupings, inv_group_sizes, block=block)


def sw_rows_ref(mat2_rows: torch.Tensor, groupings: torch.Tensor,
                inv_group_sizes: torch.Tensor, row_offset: int
                ) -> torch.Tensor:
    """(P, ceil(n_rows / 64)) f32 band partials of a row slab, the plain
    version of the brute kernel's row-slab entry (fstat.sw_rows_bands)."""
    n_rows, n = mat2_rows.shape
    block = max(1, min(8, groupings.shape[0],
                       _MAX_BLOCK_ELEMS // (n_rows * n)))
    return fstat.sw_rows_bands(mat2_rows, row_offset, groupings,
                               inv_group_sizes, block=block)


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = (a.double() if a.is_floating_point() else a).numpy()
    return np.asarray(a, dtype)


def sw_ref_f64(mat2, groupings, inv_group_sizes) -> np.ndarray:
    """Higher-precision reference (numpy float64), one permutation at a
    time; accepts tensors on any device or numpy arrays."""
    mat2 = _host(mat2, np.float64)
    groupings = _host(groupings, np.int64)
    w = _host(inv_group_sizes, np.float64)
    n = mat2.shape[0]
    triu = np.triu(np.ones((n, n), bool), k=1)
    out = []
    for g in groupings:
        same = g[:, None] == g[None, :]
        out.append(np.sum(np.where(same & triu, mat2 * w[g][:, None], 0.0)))
    return np.asarray(out)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds: add half of the dropped
    13 bits' range to the magnitude's bit pattern and clear them."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
