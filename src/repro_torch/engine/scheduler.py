"""Streaming permutation scheduler.

Twin of `repro/engine/scheduler.py`. Runs an n_total-permutation sweep in
fixed-size chunks. The labels of each chunk are made on the device from
their GLOBAL permutation indices (`core.permutations`), so the
(n_total, n) label tensor never exists and any chunk size gives the same
labels; or they are sliced from a caller's explicit `perms` tensor. The
s_W values stay on the device: the sweep never waits for the card between
chunks. While tracing (obs), each chunk is an `engine.sw_chunk` span that
waits for its chunk; with metrics on, `engine.perm_chunks` counts the
chunks and `engine.peak_label_bytes` gauges the live label footprint.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import obs as _obs
from repro_torch.core import permutations
from repro_torch.engine import planner


class StreamStats(NamedTuple):
    """How the sweep actually ran."""
    n_total: int
    chunk: int
    n_chunks: int
    peak_label_bytes: int   # (chunk, n) int32 — the live label footprint


def _count(stats: StreamStats) -> StreamStats:
    """Record a finished sweep's chunks and label footprint (obs)."""
    _obs.metrics.inc("engine.perm_chunks", stats.n_chunks)
    _obs.metrics.gauge_set("engine.peak_label_bytes", stats.peak_label_bytes)
    return stats


def _labels(grouping, lo, hi, *, seed, perms, strata=None,
            index_perms=None, draw_budget=None):
    """(hi - lo, n) int32 permuted labels for global indices [lo, hi):
    sliced from explicit `perms`, or the grouping gathered through
    explicit `index_perms`, or drawn from `seed` (within `strata` blocks
    when given) in sub-blocks whose transients fit `draw_budget` bytes
    (the label budget; None: the planner's default)."""
    if perms is not None:
        return perms[lo:hi].to(grouping.device, torch.int32).contiguous()
    if index_perms is not None:
        return grouping.to(torch.int32)[
            index_perms[lo:hi].to(grouping.device).long()]
    kind = "labels" if strata is None else "strata"
    rows = permutations.draw_rows(grouping.shape[0],
                                  planner.label_budget(draw_budget), kind)
    if strata is not None:
        return permutations.strata_label_batch(grouping, strata, lo, hi,
                                               seed=seed, block_rows=rows)
    return permutations.permutation_batch(grouping, lo, hi, seed=seed,
                                          block_rows=rows)


def _index_perms(strata, lo, hi, *, seed, index_perms, draw_budget=None):
    """(hi - lo, n) int32 index permutations for global indices [lo, hi):
    sliced from explicit `index_perms`, or drawn from `seed` within
    `strata` blocks (a constant strata vector is the free draw) in
    sub-blocks sized to `draw_budget` as _labels draws them."""
    if index_perms is not None:
        return index_perms[lo:hi].to(strata.device, torch.int32)
    return permutations.strata_permutation_batch(
        strata, lo, hi, seed=seed,
        block_rows=permutations.draw_rows(strata.shape[0],
                                          planner.label_budget(draw_budget),
                                          "index"))


def _check_perms(perms, n_total, n, name="perms"):
    if perms is not None and tuple(perms.shape) != (n_total, n):
        raise ValueError(f"{name} must be (n_perms + 1, n) = "
                         f"{(n_total, n)}, got {tuple(perms.shape)}")


def sw_streaming(mat2: torch.Tensor, grouping: torch.Tensor,
                 inv_gs: torch.Tensor, n_total: int, fn: Callable, *,
                 chunk: int, seed: int = 0,
                 perms: Optional[torch.Tensor] = None,
                 strata: Optional[torch.Tensor] = None,
                 index_perms: Optional[torch.Tensor] = None,
                 draw_budget: Optional[float] = None):
    """s_W for global permutation indices [0, n_total) in chunks.

    fn: batch impl fn(mat2, groupings, inv_gs) -> (P,) (a registry impl
        bound via SwImpl.bound(), or any compatible callable).
    perms: optional explicit (n_total, n) int32 labels, row 0 the
        identity; it replaces the seed.
    strata: optional (n,) int32 blocks: labels drawn within them.
    index_perms: optional explicit (n_total, n) int32 index permutations,
        row 0 the identity; the labels are grouping[index_perms].
    draw_budget: the label budget in bytes (None: the planner's default)
        that sizes the sub-blocks of the seed's draws.
    Returns ((n_total,) f32 tensor on mat2's device, StreamStats). The
    last chunk may be shorter than `chunk`.
    """
    n = int(mat2.shape[0])
    _check_perms(perms, n_total, n)
    _check_perms(index_perms, n_total, n, "index_perms")
    chunk = int(max(1, min(chunk, n_total)))
    out = torch.empty((n_total,), dtype=torch.float32, device=mat2.device)
    n_chunks = 0
    for lo in range(0, n_total, chunk):
        with _obs.span("engine.sw_chunk", {"lo": lo}):
            hi = min(lo + chunk, n_total)
            out[lo:hi] = fn(mat2, _labels(grouping, lo, hi, seed=seed,
                                          perms=perms, strata=strata,
                                          index_perms=index_perms,
                                          draw_budget=draw_budget), inv_gs)
            _obs.maybe_block(out)
        n_chunks += 1
    return out, _count(StreamStats(n_total=n_total, chunk=chunk,
                                   n_chunks=n_chunks,
                                   peak_label_bytes=4 * chunk * n))


def sw_batch(mat2: torch.Tensor, grouping: torch.Tensor,
             inv_gs: torch.Tensor, n_total: int, fn: Callable, *,
             seed: int = 0, perms: Optional[torch.Tensor] = None,
             strata: Optional[torch.Tensor] = None,
             index_perms: Optional[torch.Tensor] = None,
             draw_budget: Optional[float] = None):
    """One-shot path for small sweeps: all labels at once, one call."""
    n = int(mat2.shape[0])
    _check_perms(perms, n_total, n)
    _check_perms(index_perms, n_total, n, "index_perms")
    with _obs.span("engine.sw_chunk", {"lo": 0}):
        s_w = fn(mat2, _labels(grouping, 0, n_total, seed=seed, perms=perms,
                               strata=strata, index_perms=index_perms,
                               draw_budget=draw_budget),
                 inv_gs).to(torch.float32)
        s_w = _obs.maybe_block(s_w)
    return s_w, _count(StreamStats(n_total=n_total, chunk=n_total,
                                   n_chunks=1,
                                   peak_label_bytes=4 * n_total * n))


def sw_cols_streaming(mat2: torch.Tensor, basis: torch.Tensor,
                      strata: torch.Tensor, n_total: int, fn: Callable, *,
                      chunk: int, seed: int = 0,
                      index_perms: Optional[torch.Tensor] = None,
                      draw_budget: Optional[float] = None):
    """Per-column statistic (n_total, K) of a dense design in chunks.

    Each chunk draws (chunk, n) index permutations within `strata` (pass
    zeros(n) for free permutations) or slices them from `index_perms`,
    gathers the (chunk, n, K) permuted basis and contracts it with
    fn(mat2, vperms) -> (chunk, K) (a registry companion bound by
    registry.bound_cols); draw_budget sizes the draws' sub-blocks as in
    sw_streaming. Returns ((n_total, K) f32 on mat2's device,
    StreamStats).
    """
    from repro_torch.core import fstat
    n = int(mat2.shape[0])
    k = int(basis.shape[1])
    _check_perms(index_perms, n_total, n, "index_perms")
    chunk = int(max(1, min(chunk, n_total)))
    out = torch.empty((n_total, k), dtype=torch.float32, device=mat2.device)
    n_chunks = 0
    for lo in range(0, n_total, chunk):
        with _obs.span("engine.sw_chunk", {"lo": lo, "cols": k}):
            hi = min(lo + chunk, n_total)
            idx = _index_perms(strata, lo, hi, seed=seed,
                               index_perms=index_perms,
                               draw_budget=draw_budget)
            out[lo:hi] = fn(mat2, fstat.basis_perm_factors(basis, idx))
            _obs.maybe_block(out)
        n_chunks += 1
    return out, _count(StreamStats(n_total=n_total, chunk=chunk,
                                   n_chunks=n_chunks,
                                   peak_label_bytes=4 * chunk * n * (k + 1)))
