"""Streaming distance construction for the stream bridge.

Twin of the stream part of `repro/pipeline/streaming.py`: D row blocks
are squared and diagonal-masked as they are produced, and written into
ONE (n, n) mat2 buffer, so the raw distance matrix D is never
materialized. The Gower marginals (row sums, grand sum) are accumulated
in float64 in the same pass, so s_T comes free.

The reference fills a host numpy buffer and copies it to the device; here
the buffer is allocated on the features' own device, which keeps the
contract (one sustained (n, n) array) without a host round trip.
(The fused bridges come with a later slice.)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class GowerStats(NamedTuple):
    """Marginals of mat2 accumulated during the streaming pass."""
    row_sums: torch.Tensor   # (n,) float64 — sum_j mat2[i, j]
    total: float             # sum_ij mat2[i, j]
    n: int

    @property
    def s_t(self) -> float:
        """s_T = sum_{i<j} d^2 / n = total / 2 / n (zero diagonal)."""
        return self.total / 2.0 / self.n


def gower_center(mat2: torch.Tensor,
                 stats: Optional[GowerStats] = None) -> torch.Tensor:
    """Gower-centered matrix G = -1/2 (mat2 - rowmean - colmean +
    grandmean), from the streamed marginals when given."""
    n = mat2.shape[0]
    if stats is None:
        rs = mat2.sum(dim=1)
        total = rs.sum()
    else:
        rs = stats.row_sums.to(mat2.device, mat2.dtype)
        total = stats.total
    rm = rs[:, None] / n
    cm = rs[None, :] / n
    return -0.5 * (mat2 - rm - cm + total / (n * n))


def mat2_row_blocks(xprep: torch.Tensor, rows_fn: Callable, *, block: int):
    """Yield (lo, mat2_rows) covering rows [0, n) in order: each slab is
    rows_fn's distances squared, with the exact global diagonal
    (global_row == col) zeroed. The last slab holds the n - lo remaining
    rows: the kernels mask ragged shapes, so no row is padded."""
    n = int(xprep.shape[0])
    block = int(max(1, min(block, n)))
    for lo in range(0, n, block):
        slab = rows_fn(xprep[lo:lo + block], xprep)
        slab = slab * slab
        torch.diagonal(slab, offset=lo).zero_()
        yield lo, slab


def build_mat2_streaming(xprep: torch.Tensor, rows_fn: Callable, *,
                         block: int):
    """mat2 via the streaming producer: ONE (n, n) buffer on xprep's
    device, filled blockwise. Returns (mat2 f32 tensor, GowerStats
    accumulated in the same pass)."""
    n = int(xprep.shape[0])
    mat2 = torch.empty((n, n), dtype=torch.float32, device=xprep.device)
    row_sums = torch.empty((n,), dtype=torch.float64, device=xprep.device)
    for lo, slab in mat2_row_blocks(xprep, rows_fn, block=block):
        hi = lo + slab.shape[0]
        mat2[lo:hi] = slab
        row_sums[lo:hi] = slab.sum(dim=1, dtype=torch.float64)
    return mat2, GowerStats(row_sums=row_sums,
                            total=float(row_sums.sum()), n=n)
