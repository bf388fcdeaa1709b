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
           never in device memory), or its plain twin `fused_sw_onepass`
           (row blocks x chunks in torch) off the card.

Labels are the port's counter-based draws from `seed` (within `strata`
blocks when given) or slices of an explicit `perms` / `index_perms` tensor
(engine.scheduler's label source), so any chunking gives the same rows.
Each sweep has a `_design` twin for dense designs (core.design): index
permutations gather the basis rows and the contraction is per column
(`fstat.sw_cols_contract`, the fused_sw_cols kernel), (n_total, K) out.
s_W is accumulated, and s_T computed, in float64 on the device; the
reference copies every chunk to host numpy.

Out of core (`fused_sw_ooc`, `fused_sw_ooc_design`) the feature table
lives in a slab cache (data.slabcache): `ooc_mat2_row_blocks` plays
`mat2_row_blocks`' part, assembling each mat2 row slab from (slab, slab)
distance tiles of slabs the prefetcher streams in, and the same `_sweep`
/ `_sweep_cols` consume it, so the statistic equals the in-memory fused
bridge's at row_block == slab_rows bit for bit.

Over a DeviceMesh (`fused_sw_sharded`) 'model' shards the feature rows and
the other axes the permutation windows; each rank sweeps its row slab and
the ranks' partials are all-gathered and summed in rank order.

Telemetry (obs), at the reference's sites: while tracing, each stream
block is a `stream.mat2_block` span, each row slab of the fused bridge a
`fused.row_slab`, of the out-of-core sweep an `ooc.row_slab` (its column
slabs' fetch waits and tiles and its chunks), each megakernel launch a
`fusedk.chunk`, each permutation window of the sharded sweep a
`fusedk.window`; each waits for its device work (obs.maybe_block), and
each chunk's labels or index permutations are an `engine.draw` span
(engine.scheduler's draws). With metrics on:
`pipeline.mat2_bytes_built`, `fused.row_slabs` / `fused.chunk_steps`
(the fused bridge, in memory or out of core) and `engine.perm_chunks`
(the fused-kernel sweeps, either kind).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import obs as _obs
from repro_torch.core import distance as _dist
from repro_torch.core import fstat
from repro_torch.core import permutations as _perm
from repro_torch.engine import planner as _eplanner
from repro_torch.engine.scheduler import _check_perms, _index_perms, _labels
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


def mat2_row_blocks(xprep: torch.Tensor, rows_fn: Callable, *, block: int,
                    rows: Optional[tuple] = None):
    """Yield (lo, mat2_rows) covering rows [0, n) (or the range `rows`,
    (r0, r1)) in order: each slab is rows_fn's distances squared, with
    the exact global diagonal (global_row == col) zeroed. The last slab
    holds the remaining rows: the kernels mask ragged shapes, so no row
    is padded."""
    n = int(xprep.shape[0])
    block = int(max(1, min(block, n)))
    r0, r1 = (0, n) if rows is None else rows
    for lo in range(r0, r1, block):
        slab = rows_fn(xprep[lo:min(lo + block, r1)], xprep)
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
        with _obs.span("stream.mat2_block", {"lo": lo}):
            hi = lo + slab.shape[0]
            mat2[lo:hi] = slab
            row_sums[lo:hi] = slab.sum(dim=1, dtype=torch.float64)
            _obs.maybe_block(row_sums)
    _obs.metrics.inc("pipeline.mat2_bytes_built", 4.0 * n * n)
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


def _sweep(slabs, n: int, grouping, inv_gs, n_total: int, chunk: int, *,
           span: Optional[str] = None, **label_src):
    """Outer loop over (lo_r, mat2 slab), inner over permutation chunks
    (labels made again per slab from `label_src`: seed, perms, strata,
    index_perms as engine.scheduler._labels takes them); each slab's work
    a `span` span while tracing (the fused bridge's `fused.row_slab`;
    None: no span). (s_w (n_total,) f64, row_sums (n,) f64, number of
    slabs), all on the slabs' device."""
    dev = grouping.device
    s_w = torch.zeros((n_total,), dtype=torch.float64, device=dev)
    row_sums = torch.empty((n,), dtype=torch.float64, device=dev)
    n_slabs = 0
    for lo_r, slab in slabs:
        with _slab_span(span, lo_r):
            n_slabs += 1
            row_sums[lo_r:lo_r + slab.shape[0]] = slab.sum(
                dim=1, dtype=torch.float64)
            for lo in range(0, n_total, chunk):
                hi = min(lo + chunk, n_total)
                g = _labels(grouping, lo, hi, **label_src)
                s_w[lo:hi] += _fused_sw_step(slab, g, inv_gs, lo_r)
                del g   # freed before the next chunk's labels are drawn
            _obs.maybe_block(s_w)
    return s_w, row_sums, n_slabs


def _slab_span(name: Optional[str], lo_r: int, **attrs):
    """A slab's or a chunk's span, attrs {"lo": lo_r, **attrs}: the shared
    no-op span without a name or while tracing is off (nothing is
    allocated)."""
    if name is None or not _obs.trace_enabled():
        return _obs.core.NOOP_SPAN
    return _obs.span(name, {"lo": lo_r, **attrs})


def _count_fused(n_slabs: int, n_chunks: int) -> None:
    """The fused bridge's counters: row slabs and (slab, chunk) steps."""
    _obs.metrics.inc("fused.row_slabs", n_slabs)
    _obs.metrics.inc("fused.chunk_steps", n_slabs * n_chunks)


def _fused_sw_step_cols(m2rows: torch.Tensor, v: torch.Tensor, lo_r: int,
                        groups=()) -> torch.Tensor:
    """Dense-design cousin of _fused_sw_step: the row-partial per-column
    forms (chunk, K) of the permuted basis v (chunk, n, K) over mat2 rows
    [lo_r, lo_r + len(m2rows)); `groups` (fstat.sparse_col_groups)
    switches to the block-sparse form."""
    v_rows = v[:, lo_r:lo_r + m2rows.shape[0]]
    if groups:
        return fstat.sw_cols_contract_sparse(m2rows, v, v_rows, groups)
    return fstat.sw_cols_contract(m2rows, v, v_rows)


def _design_strata(design, n: int, device) -> torch.Tensor:
    """The design's strata, or zeros (the free draw) without them."""
    if design.strata is not None:
        return design.strata.to(device)
    return torch.zeros((n,), dtype=torch.int32, device=device)


def _sweep_cols(slabs, n: int, design, n_total: int, chunk: int, *,
                seed: int, index_perms, groups=(), draw_budget=None,
                span: Optional[str] = None):
    """_sweep for a dense design: per (slab, chunk) cell, the chunk's
    index permutations gather the basis and the per-column forms are
    accumulated; each slab's work a `span` span as in _sweep. (s_cols
    (n_total, K) f64, row_sums (n,) f64, number of slabs)."""
    basis = design.basis
    dev = basis.device
    strata = _design_strata(design, n, dev)
    s_cols = torch.zeros((n_total, design.k_cols), dtype=torch.float64,
                         device=dev)
    row_sums = torch.empty((n,), dtype=torch.float64, device=dev)
    n_slabs = 0
    for lo_r, slab in slabs:
        with _slab_span(span, lo_r, cols=design.k_cols):
            n_slabs += 1
            row_sums[lo_r:lo_r + slab.shape[0]] = slab.sum(
                dim=1, dtype=torch.float64)
            for lo in range(0, n_total, chunk):
                hi = min(lo + chunk, n_total)
                v = fstat.basis_perm_factors(basis, _index_perms(
                    strata, lo, hi, seed=seed, index_perms=index_perms,
                    draw_budget=draw_budget))
                s_cols[lo:hi] += _fused_sw_step_cols(slab, v, lo_r, groups)
                del v   # freed before the next chunk's index draw
            _obs.maybe_block(s_cols)
    return s_cols, row_sums, n_slabs


def _label_src(n_total, n, *, seed, perms, strata, index_perms,
               draw_budget=None):
    """The label source of a sweep (engine.scheduler._labels' keywords),
    with explicit tensors checked against (n_total, n); draw_budget (the
    label budget, None: the planner's default) sizes the draws'
    sub-blocks."""
    _check_perms(perms, n_total, n)
    _check_perms(index_perms, n_total, n, "index_perms")
    return dict(seed=seed, perms=perms, strata=strata,
                index_perms=index_perms, draw_budget=draw_budget)


def fused_sw(xprep: torch.Tensor, rows_fn: Callable, grouping: torch.Tensor,
             inv_gs: torch.Tensor, n_total: int, *, row_block: int,
             chunk: int, seed: int = 0,
             perms: Optional[torch.Tensor] = None,
             strata: Optional[torch.Tensor] = None,
             index_perms: Optional[torch.Tensor] = None,
             draw_budget: Optional[float] = None):
    """s_W for permutation indices [0, n_total) without ever holding the
    (n, n) matrix: outer loop over mat2 row slabs (each built once by
    rows_fn, squared and diagonal-masked), inner loop over permutation
    chunks consuming the live slab.

    seed / perms / strata / index_perms: the port's labels from `seed`
    (within `strata` blocks when given), or an explicit (n_total, n)
    int32 label tensor, or the grouping gathered through explicit index
    permutations. Returns (s_w (n_total,) float64, s_t 0-d float64,
    FusedStats), the tensors on xprep's device.
    """
    n = int(xprep.shape[0])
    src = _label_src(n_total, n, seed=seed, perms=perms, strata=strata,
                     index_perms=index_perms, draw_budget=draw_budget)
    row_block = int(max(1, min(row_block, n)))
    chunk = int(max(1, min(chunk, n_total)))
    s_w, row_sums, n_slabs = _sweep(
        mat2_row_blocks(xprep, rows_fn, block=row_block), n, grouping,
        inv_gs, n_total, chunk, span="fused.row_slab", **src)
    stats = FusedStats(
        n_total=n_total, chunk=chunk, n_chunks=-(-n_total // chunk),
        row_block=row_block, n_row_blocks=n_slabs,
        peak_slab_bytes=4 * row_block * n, peak_label_bytes=4 * chunk * n)
    _count_fused(n_slabs, stats.n_chunks)
    return s_w, row_sums.sum() / 2.0 / n, stats


def _design_groups(design):
    """A strata-blocked basis's column groups (fstat.sparse_col_groups),
    or () where the support is dense (the gather buys nothing)."""
    if design.strata is None:
        return ()
    groups = fstat.sparse_col_groups(design.basis, design.strata)
    return groups if len(groups) > 1 else ()


def fused_sw_design(xprep: torch.Tensor, rows_fn: Callable, design,
                    n_total: int, *, row_block: int, chunk: int,
                    seed: int = 0,
                    index_perms: Optional[torch.Tensor] = None,
                    draw_budget: Optional[float] = None,
                    onepass: bool = False):
    """The plain design sweep (the fused bridge, and the torch kind of
    the fused-kernel bridge): per-column quadratic forms accumulated over
    mat2 row slabs, nothing (n, n)-shaped ever resident. Strata-blocked
    bases contract block-sparsely (each column group only touches its
    strata's samples; the skipped terms are exact zeros).

    onepass: run as the torch kind of the fused-kernel bridge, which the
    reference counts as `engine.perm_chunks` (no slab spans, no fused
    counters).

    Returns (s_cols (n_total, K) float64, s_t 0-d float64, FusedStats).
    """
    n = int(xprep.shape[0])
    _check_perms(index_perms, n_total, n, "index_perms")
    k = design.k_cols
    groups = _design_groups(design)
    row_block = int(max(1, min(row_block, n)))
    chunk = int(max(1, min(chunk, n_total)))
    s_cols, row_sums, n_slabs = _sweep_cols(
        mat2_row_blocks(xprep, rows_fn, block=row_block), n, design,
        n_total, chunk, seed=seed, index_perms=index_perms, groups=groups,
        draw_budget=draw_budget, span=None if onepass else "fused.row_slab")
    stats = FusedStats(
        n_total=n_total, chunk=chunk, n_chunks=-(-n_total // chunk),
        row_block=row_block, n_row_blocks=n_slabs,
        peak_slab_bytes=4 * row_block * n,
        peak_label_bytes=4 * chunk * n * (k + 1))
    if onepass:
        _obs.metrics.inc("engine.perm_chunks", stats.n_chunks)
    else:
        _count_fused(n_slabs, stats.n_chunks)
    return s_cols, row_sums.sum() / 2.0 / n, stats


# ---------------------------------------------------------------------------
# Out of core: the feature table in a slab cache, never in memory whole.
# ---------------------------------------------------------------------------

class OocStats(NamedTuple):
    """How the out-of-core sweep actually ran."""
    n_total: int
    chunk: int
    n_chunks: int
    slab_rows: int
    n_slabs: int
    tiles: int               # distance calls, one per (row, column) slab
    disk_bytes_read: int     # bytes through the prefetcher
    stall_s: float           # the sweep's time blocked on slab reads
    sweep_s: float           # the whole sweep, its device work included


def ooc_mat2_row_blocks(cache, prepare: Callable, rows_fn: Callable, *,
                        device, stats: Optional[dict] = None):
    """Yield (lo, mat2_rows) for the table in a slab cache, as
    mat2_row_blocks does for a resident one: one row slab per cache slab,
    the last holding the n - lo remaining rows.

    The prefetcher (data.slabcache.SlabPrefetcher, PREFETCH_DEPTH slabs
    ahead) brings the slabs to `device` in ooc_schedule order: each row
    slab, then every column slab. `prepare` runs on each slab (row-local
    for every metric: clr, presence), in place where it would copy
    (core.distance.inplace_prepare: the fetched slabs are the sweep's
    own), `rows_fn` on each (row slab, column slab) pair (on the card one
    distance-kernel launch), and each tile is squared straight into ONE
    preallocated (slab_rows, n) buffer, reused for every row slab, with
    the global diagonal zeroed.

    On the card the host syncs once a tile and once a row: before it
    takes the next column slab it waits for the tile before last, and
    before it yields a row for the row's last tile. A slab handed over
    with record_stream goes back to the allocator only once the kernels
    that read it are done, so without the per-tile wait the host would
    run ahead and the freed slabs still held would pile up; with it at
    most two column slabs and one row slab of the sweep are held beside
    the prefetched ones (planner.ooc_footprint). The consumer must be
    done with a yielded slab before asking for the next. `stats` (a dict)
    receives the prefetcher's counters and the number of tiles when the
    sweep ends."""
    from repro_torch.data import slabcache as _slabcache
    n, block, n_slabs = cache.n, cache.slab_rows, cache.n_slabs
    prepare = _dist.inplace_prepare(prepare)
    device = torch.device(device)
    cuda = device.type == "cuda"
    pf = _slabcache.SlabPrefetcher(cache, _slabcache.ooc_schedule(n_slabs),
                                   depth=_slabcache.PREFETCH_DEPTH,
                                   device=device)
    buf = torch.empty((block, n), dtype=torch.float32, device=device)
    tiles = 0
    try:
        for r in range(n_slabs):
            _, x_rows = next(pf)
            lo_r, rows_r = r * block, cache.rows_in_slab(r)
            # the row's span stays open across the yield: it covers the
            # row's column fetches and tiles and the consumer's chunks
            with _slab_span("ooc.row_slab", lo_r):
                prep_r = prepare(x_rows[:rows_r])
                done = []          # the events of this row's tiles
                for c in range(n_slabs):
                    if len(done) >= 2:
                        # one host sync a tile: the tile before last is
                        # done, so its column slab is free before the
                        # next arrives
                        done[-2].synchronize()
                    _, x_cols = next(pf)
                    lo_c, rows_c = c * block, cache.rows_in_slab(c)
                    tile = rows_fn(prep_r, prepare(x_cols[:rows_c]))
                    dst = buf[:rows_r, lo_c:lo_c + rows_c]
                    torch.mul(tile, tile, out=dst)
                    if c == r:
                        torch.diagonal(dst).zero_()
                    tiles += 1
                    del x_cols, tile
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(device))
                        done.append(ev)
                if done:
                    # and one a row: its last tiles are done, so its slabs
                    # are free before the consumer draws labels
                    done[-1].synchronize()
                del x_rows, prep_r
                yield lo_r, buf[:rows_r]
    finally:
        pf.close()
        if stats is not None:
            stats.update(tiles=tiles, bytes_read=pf.bytes_read,
                         stall_s=pf.stall_s, slabs=pf.slabs_fetched)


def _ooc_stats(cache, n_total: int, chunk: int, counters: dict,
               t0: float) -> OocStats:
    return OocStats(
        n_total=n_total, chunk=chunk, n_chunks=-(-n_total // chunk),
        slab_rows=cache.slab_rows, n_slabs=cache.n_slabs,
        tiles=counters["tiles"], disk_bytes_read=counters["bytes_read"],
        stall_s=counters["stall_s"], sweep_s=time.perf_counter() - t0)


def fused_sw_ooc(cache, prepare: Callable, rows_fn: Callable,
                 grouping: torch.Tensor, inv_gs: torch.Tensor, n_total: int,
                 *, chunk: int, seed: int = 0,
                 perms: Optional[torch.Tensor] = None,
                 strata: Optional[torch.Tensor] = None,
                 index_perms: Optional[torch.Tensor] = None,
                 draw_budget: Optional[float] = None):
    """s_W with the feature table on DISK: the fused bridge's `_sweep`
    over the row slabs ooc_mat2_row_blocks assembles from the cache, on
    grouping's device. Labels as fused_sw takes them. The same arithmetic
    as fused_sw at row_block == cache.slab_rows, so the same bits.

    Returns (s_w (n_total,) float64, s_t 0-d float64, OocStats); the
    sweep's time includes its device work (s_T is read on the host)."""
    n = cache.n
    src = _label_src(n_total, n, seed=seed, perms=perms, strata=strata,
                     index_perms=index_perms, draw_budget=draw_budget)
    chunk = int(max(1, min(chunk, n_total)))
    counters: dict = {}
    t0 = time.perf_counter()
    s_w, row_sums, _ = _sweep(
        ooc_mat2_row_blocks(cache, prepare, rows_fn,
                            device=grouping.device, stats=counters),
        n, grouping, inv_gs, n_total, chunk, **src)
    s_t = row_sums.sum() / 2.0 / n
    s_t.item()
    _count_fused(cache.n_slabs, -(-n_total // chunk))
    return s_w, s_t, _ooc_stats(cache, n_total, chunk, counters, t0)


def fused_sw_ooc_design(cache, prepare: Callable, rows_fn: Callable, design,
                        n_total: int, *, chunk: int, seed: int = 0,
                        index_perms: Optional[torch.Tensor] = None,
                        draw_budget: Optional[float] = None):
    """fused_sw_ooc for DENSE designs: the per-column sweep `_sweep_cols`
    (block-sparse for a strata-blocked basis, as fused_sw_design) over
    the cache's assembled row slabs, on the design's device. Returns
    (s_cols (n_total, K) float64, s_t 0-d float64, OocStats)."""
    n = cache.n
    _check_perms(index_perms, n_total, n, "index_perms")
    chunk = int(max(1, min(chunk, n_total)))
    counters: dict = {}
    t0 = time.perf_counter()
    s_cols, row_sums, _ = _sweep_cols(
        ooc_mat2_row_blocks(cache, prepare, rows_fn,
                            device=design.basis.device, stats=counters),
        n, design, n_total, chunk, seed=seed, index_perms=index_perms,
        groups=_design_groups(design), draw_budget=draw_budget)
    s_t = row_sums.sum() / 2.0 / n
    s_t.item()
    _count_fused(cache.n_slabs, -(-n_total // chunk))
    return s_cols, s_t, _ooc_stats(cache, n_total, chunk, counters, t0)


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
                             # never reaches device memory)
    peak_label_bytes: int    # (chunk, n) labels (+ the (chunk, n, G)
                             # one-hot factor in the torch form; the
                             # (chunk, n, K) basis of a design)
    slots: int = 0           # cuda: the kernel's blocks (partial rows)
    draw_rows: int = 0       # rows of a label / index draw's sub-block
    peak_draw_bytes: int = 0  # their modelled transients (0: explicit
                              # perms or index_perms, nothing drawn)


def fused_sw_onepass(xprep: torch.Tensor, rows_fn: Callable,
                     grouping: torch.Tensor, inv_gs: torch.Tensor,
                     n_total: int, *, row_block: int, chunk: int,
                     seed: int = 0, perms: Optional[torch.Tensor] = None,
                     strata: Optional[torch.Tensor] = None,
                     index_perms: Optional[torch.Tensor] = None,
                     draw_budget: Optional[float] = None):
    """The plain twin of the megakernel sweep: loops over row blocks x
    permutation chunks; each D^2 block is built once (masked by global
    index, squared) and consumed by every chunk before the next.

    Returns (s_w (n_total,) float64, s_t 0-d float64, FusedKernelStats).
    """
    n = int(xprep.shape[0])
    src = _label_src(n_total, n, seed=seed, perms=perms, strata=strata,
                     index_perms=index_perms, draw_budget=draw_budget)
    block = int(max(1, min(row_block, n)))
    chunk = int(max(1, min(chunk, n_total)))
    s_w, row_sums, _ = _sweep(
        mat2_row_blocks(xprep, rows_fn, block=block), n, grouping, inv_gs,
        n_total, chunk, **src)
    stats = FusedKernelStats(
        impl="torch", n_total=n_total, chunk=chunk,
        n_chunks=-(-n_total // chunk), row_block=block,
        peak_slab_bytes=4 * block * n,
        peak_label_bytes=4 * chunk * n * (int(inv_gs.shape[0]) + 1))
    _obs.metrics.inc("engine.perm_chunks", stats.n_chunks)
    return s_w, row_sums.sum() / 2.0 / n, stats


_PRECISION_KEYS = ("feat_bf16", "feat_fp8", "feat_packed", "feat_scale")


def _precision_roundtrip(xprep: torch.Tensor, metric: str,
                         tuning: Optional[dict]) -> torch.Tensor:
    """Value parity for the plain (torch) sweep: the feature table
    quantized ONCE per the precision knobs and cast back to f32 (the plain
    sweep computes in f32 whatever the knobs say; they buy bytes only on
    the kernel path), so both fused impls contract the same quantized
    features."""
    t = tuning or {}
    mode, scale = _fref.resolve_precision(
        xprep, metric, **{k: t.get(k) for k in _PRECISION_KEYS})
    return xprep if mode == "f32" else _fref.roundtrip(xprep, mode, scale)


def _fp8_scale_kwargs(xprep: torch.Tensor, metric: str,
                      tuning: dict) -> dict:
    """The per-metric fp8 calibration, computed ONCE per study before the
    chunk loop (per chunk it would reduce the whole table again); a
    caller's feat_scale stands."""
    if int(tuning.get("feat_fp8") or 0) \
            and tuning.get("feat_scale") is None:
        return {"feat_scale": _dist.fp8_metric_scale(xprep, metric)}
    return {}


def _sweep_tuning(xprep: torch.Tensor, metric: str,
                  tuning: Optional[dict], x_rows=None) -> dict:
    """A megakernel sweep's keyword arguments for every launch: the
    precision knobs, the fp8 scale (_fp8_scale_kwargs) and the table (and
    the row slab `x_rows`, default the table) quantized ONCE for the
    sweep (`quantized`), so neither the quantization's time nor its
    transients are paid a launch."""
    tuning = dict(tuning or {})
    tuning.update(_fp8_scale_kwargs(xprep, metric, tuning))
    mode, scale = _fref.resolve_precision(
        xprep, metric, **{k: tuning.get(k) for k in _PRECISION_KEYS})
    tuning["quantized"] = _fops.quantize_slabs(
        xprep if x_rows is None else x_rows, xprep, mode, scale)
    return tuning


def fused_sw_megakernel(xprep: torch.Tensor, grouping: torch.Tensor,
                        inv_gs: torch.Tensor, n_total: int, *,
                        kernel_metric: str, chunk: int,
                        tuning: Optional[dict] = None, seed: int = 0,
                        perms: Optional[torch.Tensor] = None,
                        strata: Optional[torch.Tensor] = None,
                        index_perms: Optional[torch.Tensor] = None,
                        draw_budget: Optional[float] = None, mesh=None,
                        row_block: Optional[int] = None):
    """The fused sweep through the megakernel (kernels/fused_sw): one
    launch per permutation chunk covers every pair and permutation of the
    chunk (the whole table against itself, so the kernel visits the tiles
    j >= i only), and the only device traffic per chunk is the feature
    table and the (chunk, n) labels. The kernel's partials, one s_W value
    per (slot, permutation) and one D2 total per slot (SW_SLOTS blocks at
    most, so nothing grows with n^2), are allocated once for the sweep,
    and the fp8 scale computed once; on the card the planner sizes the
    chunk by them and the labels, and `draw_budget` (what that workset
    and the slack leave of the budget) sizes the label draws'
    sub-blocks. s_T comes from the FIRST chunk's D2 total (every chunk
    gives the same one). `tuning` holds the precision knobs (feat_bf16 /
    feat_fp8 / feat_packed / feat_scale).

    Over a `mesh` (fused_sw_sharded's 'cuda' form) the rank launches on
    its row slab (_rank_rows, rows in multiples of `row_block`) with its
    row offset, and each chunk is the rank's share of a permutation
    window (_windows), one `fusedk.window` span; without one, a chunk is
    a `fusedk.chunk` span. Either way a chunk's partials pass through
    _gather_window, which on one host is a copy.

    Returns (s_w (n_total,) float64, s_t 0-d float64, FusedKernelStats).
    """
    from repro_torch.core import distributed as _distrib
    lay = _distrib.ONE_HOST if mesh is None else _distrib.layout(mesh)
    n = int(xprep.shape[0])
    src = _label_src(n_total, n, seed=seed, perms=perms, strata=strata,
                     index_perms=index_perms, draw_budget=draw_budget)
    r0, r1, _ = _rank_rows(n, lay, n if row_block is None else row_block)
    chunk = _chunk_local(chunk, n_total, lay)
    xprep = xprep.to(torch.float32).contiguous()
    whole = r0 == 0 and r1 == n
    x_rows = xprep if whole else xprep[r0:r1]
    tuning = _sweep_tuning(xprep, kernel_metric, tuning, x_rows)
    workspace = (_fops.alloc_workspace(r1 - r0, n, chunk, xprep.device,
                                       whole)
                 if xprep.device.type == "cuda" and r1 > r0 else None)
    s_w = torch.empty((n_total,), dtype=torch.float64, device=xprep.device)
    total = None
    windows = _windows(n_total, chunk, lay)
    for wlo, lo, hi in windows:
        with _slab_span("fusedk.chunk" if mesh is None else "fusedk.window",
                        wlo):
            # the rank's partials (zero past n_total) and, in the last
            # slot, its slab's D2 total
            mine = torch.zeros((chunk + 1,), dtype=torch.float64,
                               device=xprep.device)
            if hi > lo and r1 > r0:
                g = _labels(grouping, lo, hi, **src)
                mine[:hi - lo], mine[-1] = _fops.fused_sw_rows(
                    x_rows, xprep, g if whole else g[:, r0:r1].contiguous(),
                    g, inv_gs, r0, metric=kernel_metric, workspace=workspace,
                    row_sums=False, **tuning)
                del g   # freed before the next chunk's labels are drawn
            tot = _gather_window(mine, lay, s_w, wlo, chunk, n_total)
            total = tot if total is None else total
            _obs.maybe_block(s_w)
    n_chunks = len(windows) * lay.perm_ways
    _obs.metrics.inc("engine.perm_chunks", n_chunks)
    rows, draw = _draw_stats(n, chunk, draw_budget, "labels"
                             if strata is None else "strata",
                             perms is None and index_perms is None)
    stats = FusedKernelStats(
        impl="cuda", n_total=n_total, chunk=chunk, n_chunks=n_chunks,
        row_block=_fops.TILE,
        peak_slab_bytes=_fops.workspace_bytes(max(1, r1 - r0), n, chunk,
                                              whole),
        peak_label_bytes=4 * chunk * n,
        slots=_fops.n_slots(max(1, r1 - r0), n, whole, "fused_sw"),
        draw_rows=rows, peak_draw_bytes=draw)
    return s_w, total / 2.0 / n, stats


def _draw_stats(n: int, chunk: int, draw_budget, kind: str, drawn: bool):
    """(rows, modelled transient bytes) of the draws' largest sub-block
    at `draw_budget` (None: the planner's label budget), as
    engine.scheduler draws a chunk; (0, 0) where nothing is drawn."""
    if not drawn:
        return 0, 0
    rows = min(_perm.draw_rows(n, _eplanner.label_budget(draw_budget),
                               kind), chunk)
    return rows, _perm.draw_transient_bytes(rows, n, kind)


def fused_sw_megakernel_design(xprep: torch.Tensor, design, n_total: int, *,
                               kernel_metric: str, chunk: int,
                               tuning: Optional[dict] = None, seed: int = 0,
                               index_perms: Optional[torch.Tensor] = None,
                               draw_budget: Optional[float] = None):
    """The megakernel sweep for DENSE designs (kernels/fused_sw's
    fused_sw_cols): one launch per permutation chunk, fed the chunk's
    permuted basis (chunk, n, K) in place of labels; the partial buffers
    are allocated once for the sweep, and the fp8 scale computed once.
    Each chunk's basis is freed before the next chunk's index draw, whose
    sub-blocks `draw_budget` sizes. s_T comes from the first chunk's D2
    total. `tuning` holds the precision knobs.

    Returns (s_cols (n_total, K) float64, s_t 0-d float64,
    FusedKernelStats).
    """
    n = int(xprep.shape[0])
    _check_perms(index_perms, n_total, n, "index_perms")
    k = design.k_cols
    basis = design.basis.to(torch.float32)
    strata = _design_strata(design, n, basis.device)
    chunk = int(max(1, min(chunk, n_total)))
    xprep = xprep.to(torch.float32).contiguous()
    tuning = _sweep_tuning(xprep, kernel_metric, tuning)
    workspace = (_fops.alloc_cols_workspace(n, n, chunk, k, xprep.device)
                 if xprep.device.type == "cuda" else None)
    s_cols = torch.empty((n_total, k), dtype=torch.float64,
                         device=xprep.device)
    total = None
    for lo in range(0, n_total, chunk):
        with _slab_span("fusedk.chunk", lo, cols=k):
            hi = min(lo + chunk, n_total)
            v = fstat.basis_perm_factors(basis, _index_perms(
                strata, lo, hi, seed=seed, index_perms=index_perms,
                draw_budget=draw_budget))
            sc, tot = _fops.fused_sw_rows_cols(xprep, xprep, v, v, 0,
                                               metric=kernel_metric,
                                               workspace=workspace,
                                               row_sums=False, **tuning)
            s_cols[lo:hi] = sc
            if total is None:
                total = tot
            del v   # freed before the next chunk's index draw
            _obs.maybe_block(s_cols)
    _obs.metrics.inc("engine.perm_chunks", -(-n_total // chunk))
    rows, draw = _draw_stats(n, chunk, draw_budget, "index",
                             index_perms is None)
    stats = FusedKernelStats(
        impl="cuda", n_total=n_total, chunk=chunk,
        n_chunks=-(-n_total // chunk), row_block=_fops.TILE,
        peak_slab_bytes=_fops.cols_workspace_bytes(n, n, chunk, k),
        peak_label_bytes=4 * chunk * n * (k + 1),
        slots=_fops.n_slots(n, n, True, "fused_sw_cols"),
        draw_rows=rows, peak_draw_bytes=draw)
    return s_cols, total / 2.0 / n, stats


def fused_kernel_sw(xprep: torch.Tensor, rows_fn: Callable,
                    grouping: torch.Tensor, inv_gs: torch.Tensor,
                    n_total: int, *, impl: str, kernel_metric: str,
                    row_block: int, chunk: int,
                    tuning: Optional[dict] = None, seed: int = 0,
                    perms: Optional[torch.Tensor] = None,
                    strata: Optional[torch.Tensor] = None,
                    index_perms: Optional[torch.Tensor] = None,
                    draw_budget: Optional[float] = None):
    """Dispatch the single-pass fused sweep to the planned implementation.

    impl: 'cuda' (the megakernel; its plain version on CPU tensors) or
    'torch' (the row-block x chunk loops, on the table round-tripped per
    the precision knobs in `tuning`). Both return (s_w (n_total,)
    float64, s_t 0-d float64, FusedKernelStats) with the same statistic
    for the same labels.
    """
    labels = dict(seed=seed, perms=perms, strata=strata,
                  index_perms=index_perms, draw_budget=draw_budget)
    if impl == "cuda":
        return fused_sw_megakernel(
            xprep, grouping, inv_gs, n_total, kernel_metric=kernel_metric,
            chunk=chunk, tuning=tuning, **labels)
    if impl == "torch":
        return fused_sw_onepass(
            _precision_roundtrip(xprep, kernel_metric, tuning), rows_fn,
            grouping, inv_gs, n_total, row_block=row_block, chunk=chunk,
            **labels)
    raise ValueError(f"unknown fused-kernel impl {impl!r}; "
                     "expected 'cuda' or 'torch'")


def fused_kernel_sw_design(xprep: torch.Tensor, rows_fn: Callable, design,
                           n_total: int, *, impl: str, kernel_metric: str,
                           row_block: int, chunk: int,
                           tuning: Optional[dict] = None, seed: int = 0,
                           index_perms: Optional[torch.Tensor] = None,
                           draw_budget: Optional[float] = None):
    """fused_kernel_sw for DENSE designs: 'cuda' runs
    fused_sw_megakernel_design, 'torch' the plain sweep fused_sw_design
    (on the round-tripped table, as fused_kernel_sw's). Both return
    (s_cols (n_total, K) float64, s_t 0-d float64, FusedKernelStats)."""
    if impl == "cuda":
        return fused_sw_megakernel_design(
            xprep, design, n_total, kernel_metric=kernel_metric, chunk=chunk,
            tuning=tuning, seed=seed, index_perms=index_perms,
            draw_budget=draw_budget)
    if impl == "torch":
        s_cols, s_t, st = fused_sw_design(
            _precision_roundtrip(xprep, kernel_metric, tuning), rows_fn,
            design, n_total, row_block=row_block, chunk=chunk, seed=seed,
            index_perms=index_perms, draw_budget=draw_budget, onepass=True)
        return s_cols, s_t, FusedKernelStats(
            impl="torch", n_total=st.n_total, chunk=st.chunk,
            n_chunks=st.n_chunks, row_block=st.row_block,
            peak_slab_bytes=st.peak_slab_bytes,
            peak_label_bytes=st.peak_label_bytes)
    raise ValueError(f"unknown fused-kernel impl {impl!r}; "
                     "expected 'cuda' or 'torch'")


# ---------------------------------------------------------------------------
# Multi-device fused sharding: row slabs over 'model', perms over the rest.
# ---------------------------------------------------------------------------

def _rank_rows(n: int, lay, row_block: int) -> tuple:
    """(r0, r1, block): the feature rows this rank's 'model' index holds,
    ceil(n / model_ways) up to a multiple of block = min(row_block, that)
    (the last slab ends at n and may be shorter or empty)."""
    rows = -(-n // lay.model_ways)
    block = int(max(1, min(row_block, rows)))
    rows = -(-rows // block) * block
    r0 = min(n, lay.model_index[lay.rank] * rows)
    return r0, min(n, r0 + rows), block


def _chunk_local(chunk: int, n_total: int, lay) -> int:
    """A rank's permutations a window: `chunk`, at most its share."""
    return int(max(1, min(chunk, -(-n_total // lay.perm_ways))))


def _windows(n_total: int, chunk_local: int, lay) -> list:
    """[(wlo, lo, hi)]: window wlo holds the global indices [wlo, wlo +
    perm_ways * chunk_local); this rank's chunk of it is [lo, hi) at its
    permutation block (empty past n_total)."""
    pidx = lay.perm_index[lay.rank]
    out = []
    for wlo in range(0, n_total, chunk_local * lay.perm_ways):
        lo = min(n_total, wlo + pidx * chunk_local)
        out.append((wlo, lo, min(n_total, lo + chunk_local)))
    return out


def _gather_window(mine: torch.Tensor, lay, out: torch.Tensor, wlo: int,
                   chunk_local: int, n_total: int) -> torch.Tensor:
    """All-gather a window's partials (each rank's chunk_local values and,
    last, its slab's D2 total), and write each permutation block's s_W
    into `out`, summed over the 'model' slabs in float64, in row order.
    Returns the window's D2 total (its first block's)."""
    from repro_torch.core import distributed as _distrib
    parts = _distrib.all_gather(mine, lay)
    total = None
    for b in range(lay.perm_ways):
        blo = wlo + b * chunk_local
        bhi = min(n_total, blo + chunk_local)
        if bhi <= blo:
            continue
        acc = parts[lay.first_rank(perm=b, model=0)].clone()
        for m in range(1, lay.model_ways):
            acc += parts[lay.first_rank(perm=b, model=m)]
        out[blo:bhi] = acc[:bhi - blo]
        if total is None:
            total = acc[-1]
    return total


def fused_sw_sharded(mesh, xprep: torch.Tensor, rows_fn: Callable,
                     grouping: torch.Tensor, inv_gs: torch.Tensor,
                     n_total: int, *, impl: str, kernel_metric: str,
                     row_block: int, chunk: int,
                     tuning: Optional[dict] = None, seed: int = 0,
                     perms: Optional[torch.Tensor] = None,
                     draw_budget: Optional[float] = None):
    """The fused-kernel sweep over a (..., 'data', 'model') DeviceMesh,
    every rank returning the whole result.

    'model' shards the feature-table ROWS: each rank sweeps only its row
    slab (_rank_rows); the other axes shard the PERMUTATIONS by window
    (_windows). impl 'cuda' is fused_sw_megakernel over the mesh
    (fused_sw_rows on the slab with its row offset; the whole table,
    visited j >= i, when model_ways is 1; its plain version on CPU
    tensors); 'torch' runs the slab's row blocks through the one-hot
    contraction, each block built once for every window. Each window's
    partials (and the slabs' D2 totals) are all-gathered and each
    permutation's s_W summed over the slabs in float64, in row order
    (_gather_window), one `fusedk.window` span a window. A permutation's
    s_W from fused_sw_rows is the same bits in any chunk, so with
    model_ways 1 the 'cuda' result is the single-host sweep's bit for
    bit.

    Returns (s_w (n_total,) float64, s_t 0-d float64, FusedKernelStats).
    """
    if impl == "cuda":
        return fused_sw_megakernel(
            xprep, grouping, inv_gs, n_total, kernel_metric=kernel_metric,
            chunk=chunk, tuning=tuning, seed=seed, perms=perms,
            draw_budget=draw_budget, mesh=mesh, row_block=row_block)
    if impl != "torch":
        raise ValueError(f"unknown fused-kernel impl {impl!r}; "
                         "expected 'cuda' or 'torch'")
    from repro_torch.core import distributed as _distrib
    lay = _distrib.layout(mesh)
    n = int(xprep.shape[0])
    src = _label_src(n_total, n, seed=seed, perms=perms, strata=None,
                     index_perms=None, draw_budget=draw_budget)
    r0, r1, block = _rank_rows(n, lay, row_block)
    chunk = _chunk_local(chunk, n_total, lay)
    xprep = _precision_roundtrip(xprep.to(torch.float32).contiguous(),
                                 kernel_metric, tuning)
    windows = _windows(n_total, chunk, lay)
    mine = torch.zeros((len(windows), chunk + 1), dtype=torch.float64,
                       device=xprep.device)
    for lo_r, slab in mat2_row_blocks(xprep, rows_fn, block=block,
                                      rows=(r0, r1)):
        for w, (_, lo, hi) in enumerate(windows):
            if hi > lo:
                g = _labels(grouping, lo, hi, **src)
                mine[w, :hi - lo] += _fused_sw_step(slab, g, inv_gs, lo_r)
                del g
        mine[:, -1] += slab.sum(dtype=torch.float64)
    out = torch.empty((n_total,), dtype=torch.float64, device=xprep.device)
    total = None
    for w, (wlo, _, _) in enumerate(windows):
        with _slab_span("fusedk.window", wlo):
            tot = _gather_window(mine[w], lay, out, wlo, chunk, n_total)
            total = tot if total is None else total
            _obs.maybe_block(out)
    stats = FusedKernelStats(
        impl="torch", n_total=n_total, chunk=chunk,
        n_chunks=len(windows) * lay.perm_ways, row_block=block,
        peak_slab_bytes=4 * block * n,
        peak_label_bytes=4 * chunk * n * (int(inv_gs.shape[0]) + 1))
    _obs.metrics.inc("engine.perm_chunks", stats.n_chunks)
    return out, total / 2.0 / n, stats
