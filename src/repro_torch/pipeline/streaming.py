"""Streaming distance construction and fused distance -> s_W sweeps.

Twin of `repro/pipeline/streaming.py` for one device. Three ways from an
(n, d) table to s_W without the raw distance matrix D:

  stream   D row blocks are squared and diagonal-masked as they are
           produced and written into ONE (n, n) mat2 buffer; the Gower
           marginals (row sums, grand sum) are accumulated in float64 in
           the same pass, so s_T comes free. The reference fills a host
           numpy buffer and copies it up; here the buffer lives on the
           features' device (the same contract, one sustained (n, n)
           array, without the host round trip).
  fused    never an (n, n) array: each mat2 row slab feeds every
           permutation chunk directly (row-partial s_W in the one-hot
           matmul form), with the chunk's labels made again per slab.
           Peak residency is one (row_block, n) slab + one chunk's
           labels and one-hot factor, independent of n^2.
  fused-kernel
           the single-pass form: distances built AND contracted inside
           one launch per permutation chunk (kernels/fused_sw, D^2 tiles
           never leave registers), or its plain twin `fused_sw_onepass`
           (row blocks x chunks in torch) off the card.

Labels are the port's counter-based draws from `seed` or slices of an
explicit `perms` tensor (engine.scheduler's label source), so any
chunking gives the same rows. s_W is accumulated, and s_T computed, in
float64 on the device; the reference copies every chunk to host numpy.
(Design, sharded and out-of-core sweeps come with later slices.)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import fstat
from repro_torch.engine.scheduler import _check_perms, _labels
from repro_torch.kernels.fused_sw import ops as _fops
from repro_torch.kernels.fused_sw import ref as _fref


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


# ---------------------------------------------------------------------------
# The fused bridge: mat2 row slabs straight into the permutation sweep.
# ---------------------------------------------------------------------------

class FusedStats(NamedTuple):
    """How the fused sweep actually ran."""
    n_total: int
    chunk: int
    n_chunks: int
    row_block: int
    n_row_blocks: int
    peak_slab_bytes: int     # (row_block, n) mat2 slab — the live matrix
    peak_label_bytes: int    # (chunk, n) labels


def _fused_sw_step(m2rows: torch.Tensor, labels: torch.Tensor,
                   inv_gs: torch.Tensor, lo_r: int) -> torch.Tensor:
    """Row-partial s_W (fstat's matmul-form contraction) of one chunk's
    labels over mat2 rows [lo_r, lo_r + len(m2rows)): every (row slab x
    chunk) cell is independent and the cells sum to the full statistic."""
    e = fstat.onehot_perm_factors(labels, inv_gs, m2rows.dtype)  # (P, n, G)
    e_rows = e[:, lo_r:lo_r + m2rows.shape[0]]
    return fstat.sw_matmul_contract(m2rows, e, e_rows)


def _sweep(slabs, n: int, grouping, inv_gs, n_total: int, chunk: int,
           seed: int, perms):
    """Outer loop over (lo_r, mat2 slab), inner over permutation chunks
    (labels made again per slab). (s_w (n_total,) f64, row_sums (n,) f64,
    number of slabs), all on the slabs' device."""
    dev = grouping.device
    s_w = torch.zeros((n_total,), dtype=torch.float64, device=dev)
    row_sums = torch.empty((n,), dtype=torch.float64, device=dev)
    n_slabs = 0
    for lo_r, slab in slabs:
        n_slabs += 1
        row_sums[lo_r:lo_r + slab.shape[0]] = slab.sum(dim=1,
                                                      dtype=torch.float64)
        for lo in range(0, n_total, chunk):
            hi = min(lo + chunk, n_total)
            g = _labels(grouping, lo, hi, seed=seed, perms=perms)
            s_w[lo:hi] += _fused_sw_step(slab, g, inv_gs, lo_r)
    return s_w, row_sums, n_slabs


def fused_sw(xprep: torch.Tensor, rows_fn: Callable, grouping: torch.Tensor,
             inv_gs: torch.Tensor, n_total: int, *, row_block: int,
             chunk: int, seed: int = 0,
             perms: Optional[torch.Tensor] = None):
    """s_W for permutation indices [0, n_total) without ever holding the
    (n, n) matrix: outer loop over mat2 row slabs (each built once by
    rows_fn, squared and diagonal-masked), inner loop over permutation
    chunks consuming the live slab.

    seed / perms: the port's labels from `seed`, or an explicit
    (n_total, n) int32 label tensor. Returns (s_w (n_total,) float64,
    s_t 0-d float64, FusedStats), the tensors on xprep's device.
    """
    n = int(xprep.shape[0])
    _check_perms(perms, n_total, n)
    row_block = int(max(1, min(row_block, n)))
    chunk = int(max(1, min(chunk, n_total)))
    s_w, row_sums, n_slabs = _sweep(
        mat2_row_blocks(xprep, rows_fn, block=row_block), n, grouping,
        inv_gs, n_total, chunk, seed, perms)
    stats = FusedStats(
        n_total=n_total, chunk=chunk, n_chunks=-(-n_total // chunk),
        row_block=row_block, n_row_blocks=n_slabs,
        peak_slab_bytes=4 * row_block * n, peak_label_bytes=4 * chunk * n)
    return s_w, row_sums.sum() / 2.0 / n, stats


# ---------------------------------------------------------------------------
# Fused-kernel: single-pass distance -> s_W.
# ---------------------------------------------------------------------------

class FusedKernelStats(NamedTuple):
    """How the single-pass sweep actually ran."""
    impl: str                # 'cuda' | 'torch'
    n_total: int
    chunk: int
    n_chunks: int
    row_block: int           # rows per slab (torch) or per kernel tile
    peak_slab_bytes: int     # torch: the (row_block, n) D^2 slab; cuda:
                             # the kernel's partial buffers (D^2 itself
                             # never leaves its registers)
    peak_label_bytes: int    # (chunk, n) labels (+ the (chunk, n, G)
                             # one-hot factor in the torch form)


def fused_sw_onepass(xprep: torch.Tensor, rows_fn: Callable,
                     grouping: torch.Tensor, inv_gs: torch.Tensor,
                     n_total: int, *, row_block: int, chunk: int,
                     seed: int = 0, perms: Optional[torch.Tensor] = None):
    """The plain twin of the megakernel sweep: loops over row blocks x
    permutation chunks; each D^2 block is built once (masked by global
    index, squared) and consumed by every chunk before the next.

    Returns (s_w (n_total,) float64, s_t 0-d float64, FusedKernelStats).
    """
    n = int(xprep.shape[0])
    _check_perms(perms, n_total, n)
    block = int(max(1, min(row_block, n)))
    chunk = int(max(1, min(chunk, n_total)))
    s_w, row_sums, _ = _sweep(
        mat2_row_blocks(xprep, rows_fn, block=block), n, grouping, inv_gs,
        n_total, chunk, seed, perms)
    stats = FusedKernelStats(
        impl="torch", n_total=n_total, chunk=chunk,
        n_chunks=-(-n_total // chunk), row_block=block,
        peak_slab_bytes=4 * block * n,
        peak_label_bytes=4 * chunk * n * (int(inv_gs.shape[0]) + 1))
    return s_w, row_sums.sum() / 2.0 / n, stats


def fused_sw_megakernel(xprep: torch.Tensor, grouping: torch.Tensor,
                        inv_gs: torch.Tensor, n_total: int, *,
                        kernel_metric: str, chunk: int,
                        tuning: Optional[dict] = None, seed: int = 0,
                        perms: Optional[torch.Tensor] = None):
    """The fused sweep through the megakernel (kernels/fused_sw): one
    launch per permutation chunk covers every tile and permutation of the
    chunk, so the only device traffic per chunk is the feature table and
    the (chunk, n) labels. The partial buffers are allocated once for the
    sweep. s_T comes from the FIRST chunk's row sums (every chunk gives
    the same ones).

    Returns (s_w (n_total,) float64, s_t 0-d float64, FusedKernelStats).
    """
    n = int(xprep.shape[0])
    _check_perms(perms, n_total, n)
    chunk = int(max(1, min(chunk, n_total)))
    xprep = xprep.to(torch.float32).contiguous()
    workspace = (_fops.alloc_workspace(n, n, chunk, xprep.device)
                 if xprep.device.type == "cuda" else None)
    s_w = torch.empty((n_total,), dtype=torch.float64, device=xprep.device)
    row_sums = None
    for lo in range(0, n_total, chunk):
        hi = min(lo + chunk, n_total)
        g = _labels(grouping, lo, hi, seed=seed, perms=perms)
        sw, rs = _fops.fused_sw_rows(xprep, xprep, g, g, inv_gs, 0,
                                     metric=kernel_metric,
                                     workspace=workspace, **(tuning or {}))
        s_w[lo:hi] = sw
        if row_sums is None:
            row_sums = rs
    stats = FusedKernelStats(
        impl="cuda", n_total=n_total, chunk=chunk,
        n_chunks=-(-n_total // chunk), row_block=_fops.TILE,
        peak_slab_bytes=_fops.workspace_bytes(n, n, chunk),
        peak_label_bytes=4 * chunk * n)
    return s_w, row_sums.sum(dtype=torch.float64) / 2.0 / n, stats


def fused_kernel_sw(xprep: torch.Tensor, rows_fn: Callable,
                    grouping: torch.Tensor, inv_gs: torch.Tensor,
                    n_total: int, *, impl: str, kernel_metric: str,
                    row_block: int, chunk: int,
                    tuning: Optional[dict] = None, seed: int = 0,
                    perms: Optional[torch.Tensor] = None):
    """Dispatch the single-pass fused sweep to the planned implementation.

    impl: 'cuda' (the megakernel; its plain version on CPU tensors) or
    'torch' (the row-block x chunk loops). Both return (s_w (n_total,)
    float64, s_t 0-d float64, FusedKernelStats) with the same statistic
    for the same labels.
    """
    if impl == "cuda":
        return fused_sw_megakernel(
            xprep, grouping, inv_gs, n_total, kernel_metric=kernel_metric,
            chunk=chunk, tuning=tuning, seed=seed, perms=perms)
    if impl == "torch":
        _fref.reject_precision(tuning)
        return fused_sw_onepass(xprep, rows_fn, grouping, inv_gs, n_total,
                                row_block=row_block, chunk=chunk, seed=seed,
                                perms=perms)
    raise ValueError(f"unknown fused-kernel impl {impl!r}; "
                     "expected 'cuda' or 'torch'")
