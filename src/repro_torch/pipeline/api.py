"""Pipeline entry point: raw abundance table -> F statistic and p-value.

Twin of `repro/pipeline/api.py` for one study on one device. Through the
dense and stream bridges stage 1 and the bridge come from this package
and stage 2 from engine.run; the fused and fused-kernel bridges compute
s_W themselves (pipeline.streaming) and never hold an (n, n) array. A
design (covariates, strata, weights, or a prebuilt core.design.Design)
goes through `_pipeline_design`: the same bridges with engine.run_design
or the sweeps' design twins, per-term F and p in `.terms`.
`core.permanova.permanova()` delegates here when handed features instead
of a matrix, and the launch CLI exposes it as `--from-features`.
`pipeline_many` runs a stack of studies one after another through the
same bridges (dense, or the fused-kernel sweeps). Over a DeviceMesh
(launch.mesh), `pipeline(mesh=)` shards the fused-kernel sweep
(streaming.fused_sw_sharded: rows over 'model', permutations over the
other axes) and `pipeline_many(mesh=)` the study axis over 'data'; every
rank passes the same arguments and returns the whole result. `ordination=k` adds the
top-k PCoA axes from the same dataflow (pipeline.ordination): eigh on the
dense bridge, the implicit centered operator on the stream bridge's mat2,
the feature-streamed slabs on the fused bridges. `autotune=True` runs the
planners' shoot-outs where they apply: stage 1 on the dense and stream
bridges (and the s_W impl in engine.run), the fused-kernel impl on the
fused-kernel bridge. Features in a slab cache (data.slabcache, or its
directory) go through `_pipeline_ooc`: read once into the resident path
while the f32 table fits the device budget, else the out-of-core sweep.
`trace=` scopes telemetry (obs) to the call: spans for stage 1
(`stage1.<metric>`), each bridge (`bridge.fused`, `bridge.fused-kernel`,
`bridge.ooc`) and PCoA (`pipeline.pcoa`), with the predicted traffic of
`_stage1_attrs` / `_fused_attrs` (also counted in
`pipeline.predicted_bytes`) for obs.report().
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional

import torch

from repro_torch import engine, hw
from repro_torch import obs as _obs
from repro_torch.core import design as _design
from repro_torch.core import permutations
from repro_torch.core.permanova import (PermanovaResult, f_from_sw,
                                        p_value_from_null)
from repro_torch.data import slabcache as _slabcache
from repro_torch.pipeline import ordination as _ordination
from repro_torch.pipeline import planner as _planner
from repro_torch.pipeline import registry as _registry
from repro_torch.pipeline import streaming as _streaming


def _feat_words(d: int, dist_tuning) -> int:
    """The distance kernel's feature width: packed jaccard reads 32-bit
    presence words."""
    return -(-d // 32) if int((dist_tuning or {}).get("packed", 0)) else d


def _stage1_attrs(pl, dspec, n: int, d: int, bridge: str, backend: str):
    """Span attrs for the distance stage, its predicted traffic also
    counted in `pipeline.predicted_bytes`; None while tracing is off (the
    disabled path allocates nothing).

    On 'cpu', and for a torch impl on the card, the reference's model:
    the registry's workset per row block (the dense form one block of n
    rows) plus the 4n^2 mat2 write. The card's kernel ('<metric>.cuda'
    on 'cuda'): what its launches move (kernels.distance.ops.
    launch_bytes): the dense bridge's one whole-table call; the stream
    bridge's (block, n) slab calls, each slab then squared, its diagonal
    zeroed, copied into mat2 and summed by rows (20 bytes an element)."""
    if not _obs.trace_enabled():
        return None
    if backend == "cuda" and dspec.kind == "cuda":
        from repro_torch.kernels.distance import ops as _dops
        words = _feat_words(d, pl.dist_tuning)
        if bridge == "dense":
            predicted = _dops.launch_bytes(n, n, words, symmetric=True)
        else:
            block = int(min(pl.row_block, n))
            predicted = sum(
                _dops.launch_bytes(min(block, n - lo), n, words)
                + 20.0 * min(block, n - lo) * n
                for lo in range(0, n, block))
    else:
        block = n if bridge == "dense" else int(min(pl.row_block, n))
        n_blocks = -(-n // block)
        predicted = (float(dspec.workset_bytes(n, d, block)) * n_blocks
                     + 4.0 * n * n)
    _obs.metrics.inc("pipeline.predicted_bytes", predicted)
    return {"bridge": bridge, "impl": pl.dist_impl,
            "predicted_bytes": predicted}


def _fused_attrs(pl, n: int, d: int, n_groups: int, n_total: int, *,
                 fspec=None, studies: int = 1, backend: str = "cpu",
                 n_cols=None):
    """Span attrs for the fused bridges, the predicted traffic also
    counted in `pipeline.predicted_bytes`; None while tracing is off.

    On 'cpu', the reference's models: the fused (two-stage) sweep builds
    every mat2 row slab once and streams the (chunk, n, G + 1)-equivalent
    label state per (slab, chunk) pair; the fused-kernel sweep's feature
    traffic comes from the registry's precision-aware model per chunk,
    plus the label state per chunk. On 'cuda': the fused-kernel bridge
    counts what each megakernel launch moves (kernels.fused_sw.ops.
    launch_bytes, n_cols = K for a dense design) plus what each chunk's
    draw writes (labels, or the index permutations and the gathered
    basis); the fused bridge, through the distance kernel, each slab's
    launch, its square and row sums (12 bytes an element), and per (slab,
    chunk) the slab read and the label state."""
    if not _obs.trace_enabled():
        return None
    block = int(min(pl.row_block, n))
    n_blocks = -(-n // block)
    ch = int(max(1, min(pl.sw.chunk, n_total)))
    n_chunks = -(-n_total // ch)
    if fspec is not None:
        bridge, impl = "fused-kernel", fspec.name
        if backend == "cuda" and fspec.kind == "cuda":
            from repro_torch.kernels.fused_sw import ops as _fops
            bpe = _registry.feat_element_bytes(
                {**dict(fspec.tuning), **pl.fused_tuning})
            k = 0 if n_cols is None else int(n_cols)
            predicted = 0.0
            for lo in range(0, n_total, ch):
                p = min(ch, n_total - lo)
                predicted += (_fops.launch_bytes(n, n, d, p, feat_bytes=bpe,
                                                 n_cols=n_cols)
                              + 4.0 * p * n * (k + 1))
        else:
            predicted = (
                _registry.fused_feat_traffic_bytes(
                    fspec, n, d, pl.fused_tuning, block) * n_chunks
                + 4.0 * ch * n * (n_groups + 1) * n_chunks)
    else:
        bridge, impl = "fused", pl.sw.impl
        label_state = n_blocks * n_chunks * 4.0 * ch * n * (n_groups + 1)
        if backend == "cuda" and \
                _registry.get(pl.dist_impl).kind == "cuda":
            from repro_torch.kernels.distance import ops as _dops
            words = _feat_words(d, pl.dist_tuning)
            predicted = label_state + 4.0 * n * n * n_chunks + sum(
                _dops.launch_bytes(min(block, n - lo), n, words)
                + 12.0 * min(block, n - lo) * n
                for lo in range(0, n, block))
        else:
            predicted = 4.0 * n * n + label_state
    predicted *= studies
    _obs.metrics.inc("pipeline.predicted_bytes", predicted)
    attrs = {"bridge": bridge, "impl": impl, "predicted_bytes": predicted}
    if studies > 1:
        attrs["studies"] = studies
    return attrs


def pipeline(x, grouping=None, *, metric: str = "braycurtis",
             n_perms: int = 999, seed: int = 0,
             perms: Optional[torch.Tensor] = None,
             index_perms: Optional[torch.Tensor] = None,
             n_groups: Optional[int] = None,
             dist_impl: str = "auto", sw_impl: str = "auto",
             materialize: str = "auto", row_block: Optional[int] = None,
             chunk: Optional[int] = None,
             memory_budget_bytes: Optional[float] = None,
             matrix_budget_bytes: Optional[float] = None,
             slab_budget_bytes: Optional[float] = None,
             dist_tuning: Optional[Dict[str, int]] = None,
             fused_impl: str = "auto",
             fused_tuning: Optional[Dict[str, int]] = None,
             mesh=None, ordination: Optional[int] = None,
             covariates=None, strata=None, weights=None,
             autotune: bool = False, trace=None,
             device_budget_bytes: Optional[float] = None,
             host_budget_bytes: Optional[float] = None,
             device="cuda") -> PermanovaResult:
    """Full features->p-value PERMANOVA under one joint plan.

    x:           (n, d) abundance table (raw features, NOT distances), or
                 a data.slabcache.SlabCache (or its directory path): the
                 table stays on disk and the planner grades its residency
                 against device_budget_bytes (default 2 GiB) and
                 host_budget_bytes (32 GiB); below 'hbm' the sweep runs
                 out of core (slabs streamed through the prefetcher into
                 the fused bridge's sweep; its OocStats in
                 `result.ooc_stats`), F, p and the null equal to the
                 in-memory fused bridge at row_block == slab_rows bit for
                 bit on the CPU forms and the card's '<metric>.cuda'
                 kernels. A pinned '<metric>.blocked' or '.dense' impl on
                 the card runs cuBLAS, whose split-k choice may depend on
                 the call's shape: out of core it is called on (slab,
                 slab) tiles, in memory on (slab, n), so there the
                 identity is not promised.
    materialize: 'auto' | 'dense' | 'stream' | 'fused' | 'fused-kernel' —
                 whether the (n, n) matrix D is built outright (D and mat2
                 both resident), its squared row blocks are streamed into
                 one mat2 buffer, never materialized at all (fused: mat2
                 row slabs feed the permutation chunks), or swept in a
                 single pass with distance tiles contracted in-kernel
                 (fused-kernel; what 'auto' picks when not even one (n, n)
                 buffer fits matrix_budget_bytes, e.g. n > 16,384 at the
                 default 1 GiB).
    fused_impl:  'auto' | 'cuda' | 'torch' (or the reference's 'pallas' /
                 'xla', or a fused registry name) — which single-pass
                 sweep runs a fused-kernel plan: the CUDA megakernel (the
                 card's choice) or the plain torch loops.
    fused_tuning: overrides of the fused impl's knobs: the precision knobs
                 feat_bf16 / feat_fp8 / feat_packed (one at a time; packed
                 for jaccard only; e.g. registry.precision_tuning('fp8'))
                 select the kernel's feature mode on the fused-kernel
                 bridge (ValueError on another bridge).
    dist_impl:   'auto' or a registry name ('<metric>.cuda' — alias
                 '<metric>.pallas' — '.dense', '.blocked').
    dist_tuning: overrides of the impl's knobs, e.g. {'packed': 1} for
                 jaccard's popcount kernel.
    grouping:    (n,) labels, or a prebuilt core.design.Design (then
                 covariates / strata / weights stay None).
    covariates / strata / weights: a design (core.design.build):
                 sequential per-term F and p in `.terms`, permutations
                 within strata blocks; every bridge takes it.
    seed / perms / index_perms: as engine.run — the port's draws from
                 `seed`, an explicit (n_perms + 1, n) int32 label tensor
                 (labels-mode designs only), or explicit (n_perms + 1, n)
                 int32 index permutations.
    ordination:  k: also the top-k PCoA axes (coordinates, eigenvalues,
                 explained variance) in `result.ordination`, from the
                 bridge's own dataflow (pipeline.ordination); the stream
                 and fused bridges never build the Gower matrix.
    autotune:    measure instead of trusting the heuristics: on the dense
                 and stream bridges the stage-1 candidates (dist_impl
                 'auto') and the s_W impl (engine.run, sw_impl 'auto'), on
                 the fused-kernel bridge the fused candidates (fused_impl
                 'auto'); winners persist (engine.planner's cache). On the
                 card every candidate is a hand kernel.
    device:      'cuda' (default; raises without a card) or 'cpu'.

    trace:       telemetry for this call: True enables scoped span
                 tracing + metrics (obs.session), a string also exports the
                 Chrome trace_event JSON to that path on return; None /
                 False (default) leaves telemetry as the process had it
                 (nothing recorded, no sync, when it is off). Read it with
                 obs.report() / obs.trace.stage_table() afterwards.
                 Tracing waits for the card at each span's end, so the
                 spans time finished device work (not while a
                 torch.profiler records: obs.maybe_block); F, p and the
                 null are unchanged.

    mesh:        a DeviceMesh (launch.mesh.make_mesh) with a 'model' axis:
                 every rank runs the same call and gets the whole result
                 on the mesh's device. The fused-kernel bridge only
                 (materialize 'auto' / 'fused-kernel', else ValueError):
                 'model' shards the table's rows, the other axes the
                 permutation windows (streaming.fused_sw_sharded). The
                 sweep is the card's megakernel (`.fusedk.cuda`; its plain
                 version on the CPU) unless fused_impl pins 'torch'. With
                 'model' = 1 the result is the single-host fused-kernel
                 bridge's (fused_impl='cuda') bit for bit. Plain
                 single-factor designs only (ValueError otherwise, as the
                 reference: shard design studies with pipeline_many); a
                 slab cache with a mesh raises ValueError. The plan
                 records '+mesh'.

    Budgets split per stage: matrix/slab for distances,
    memory_budget_bytes for s_W labels. For the same labels every bridge
    gives the same F and p-value (to f32 accumulation order).
    """
    if trace:
        with _obs.session(trace if isinstance(trace, str) else None):
            return pipeline(
                x, grouping, metric=metric, n_perms=n_perms, seed=seed,
                perms=perms, index_perms=index_perms, n_groups=n_groups,
                dist_impl=dist_impl, sw_impl=sw_impl,
                materialize=materialize, row_block=row_block, chunk=chunk,
                memory_budget_bytes=memory_budget_bytes,
                matrix_budget_bytes=matrix_budget_bytes,
                slab_budget_bytes=slab_budget_bytes,
                dist_tuning=dist_tuning, fused_impl=fused_impl,
                fused_tuning=fused_tuning, mesh=mesh, ordination=ordination,
                covariates=covariates, strata=strata, weights=weights,
                autotune=autotune, trace=None,
                device_budget_bytes=device_budget_bytes,
                host_budget_bytes=host_budget_bytes, device=device)
    if isinstance(x, (str, os.PathLike)):
        x = _slabcache.SlabCache.open(x)
    if isinstance(x, _slabcache.SlabCache):
        return _pipeline_ooc(
            x, grouping, metric=metric, n_perms=n_perms, seed=seed,
            perms=perms, index_perms=index_perms, n_groups=n_groups,
            dist_impl=dist_impl, sw_impl=sw_impl, materialize=materialize,
            row_block=row_block, chunk=chunk,
            memory_budget_bytes=memory_budget_bytes,
            matrix_budget_bytes=matrix_budget_bytes,
            slab_budget_bytes=slab_budget_bytes, dist_tuning=dist_tuning,
            fused_impl=fused_impl, fused_tuning=fused_tuning, mesh=mesh,
            ordination=ordination, covariates=covariates, strata=strata,
            weights=weights, autotune=autotune,
            device_budget_bytes=device_budget_bytes,
            host_budget_bytes=host_budget_bytes,
            dev=hw.resolve_device(device))
    if mesh is not None:
        if (covariates is not None or strata is not None
                or weights is not None
                or (isinstance(grouping, _design.Design)
                    and not grouping.is_plain_labels)):
            raise ValueError(_MESH_DESIGN)
        if materialize not in ("auto", "fused-kernel"):
            raise ValueError(
                "mesh execution is fused-kernel only; use "
                "materialize='auto'/'fused-kernel' (or core.distributed "
                "for matrix-resident sharding)")
        materialize = "fused-kernel"
        from repro_torch.launch import mesh as _mesh   # deferred: a leaf
        dev = _mesh.mesh_device(mesh)   # the rank's, whatever `device` says
    else:
        dev = hw.resolve_device(device)
    x = torch.as_tensor(x).to(dev, torch.float32)
    if x.dim() != 2:
        raise ValueError(f"features must be (n, d); got shape "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    grouping, n_groups, design = _build_design(
        grouping, covariates, strata, weights, n_groups, n, dev)
    if design is not None:
        return _pipeline_design(
            x, design, metric=metric, n_perms=n_perms, seed=seed,
            perms=perms, index_perms=index_perms, dist_impl=dist_impl,
            sw_impl=sw_impl, materialize=materialize, row_block=row_block,
            chunk=chunk, memory_budget_bytes=memory_budget_bytes,
            matrix_budget_bytes=matrix_budget_bytes,
            slab_budget_bytes=slab_budget_bytes, dist_tuning=dist_tuning,
            fused_impl=fused_impl, fused_tuning=fused_tuning,
            ordination=ordination, autotune=autotune, dev=dev)
    if grouping is None:
        raise ValueError("pipeline needs grouping labels, covariates, or a "
                         "Design")
    grouping = torch.as_tensor(grouping).to(dev, torch.int32)
    if n_groups is None:
        n_groups = int(grouping.max()) + 1
    if mesh is not None:
        if index_perms is not None:
            raise ValueError("mesh execution takes labels (seed= or "
                             "perms=), not index_perms=")
        if autotune:
            warnings.warn("autotune=True ignored: mesh execution runs the "
                          "megakernel sweep (or a pinned fused_impl)",
                          stacklevel=2)
            autotune = False
        if fused_impl == "auto":
            # the port's mesh runs the card's kernel (its plain version on
            # the CPU), where the reference's runs its XLA sweep
            fused_impl = "cuda"

    def _plan():
        return _planner.plan_pipeline(
            n, d, n_perms + 1, n_groups, backend=dev.type, metric=metric,
            dist_impl=dist_impl, materialize=materialize,
            row_block=row_block, matrix_budget_bytes=matrix_budget_bytes,
            slab_budget_bytes=slab_budget_bytes,
            memory_budget_bytes=memory_budget_bytes, sw_impl=sw_impl,
            chunk=chunk, fused_impl=fused_impl, fused_tuning=fused_tuning)

    pl = _plan()
    if autotune:
        # measure only what the resolved plan runs; the winners persist,
        # so the plan made again reads them back
        if pl.materialize == "fused-kernel" and fused_impl == "auto":
            fused_impl = _planner.autotune_fused(
                x, grouping, metric=metric, n_groups=n_groups, seed=seed)
            pl = _plan()
        elif pl.materialize in ("dense", "stream") and dist_impl == "auto":
            # never on 'fused': the stage-1 shoot-out builds whole dense
            # matrices, what that bridge exists to avoid
            dist_impl = _planner.autotune_stage1(x, metric)
            pl = _plan()
        elif pl.materialize == "fused":
            warnings.warn(
                "autotune=True ignored: the fused bridge computes s_W in "
                "its one-hot matmul form (use materialize='stream'/'dense' "
                "to let measurements pick the s_W impl, or "
                "materialize='fused-kernel' for the measured single-pass "
                "candidates)", stacklevel=2)
    # planner-resolved tuning (row block folded in) <- caller overrides
    dspec = _registry.get(pl.dist_impl)
    prepare, rows_fn, dense_fn = dspec.bound(
        **{**pl.dist_tuning, **(dist_tuning or {})})
    if pl.materialize in _planner.FUSED_MODES:
        xprep = prepare(x)
        res = _fused_bridge(pl, xprep, rows_fn, grouping, n_perms,
                            n_groups, seed, perms, index_perms,
                            memory_budget_bytes, d=int(d), mesh=mesh)
        return dataclasses.replace(res, ordination=_features_ordination(
            pl, xprep, rows_fn, ordination))
    run_kw = dict(n_perms=n_perms, seed=seed, perms=perms,
                  index_perms=index_perms, n_groups=n_groups, impl=sw_impl,
                  memory_budget_bytes=memory_budget_bytes, chunk=chunk,
                  autotune=autotune, device=dev)
    ordn = None
    if pl.materialize == "dense":
        with _obs.span(f"stage1.{metric}", _stage1_attrs(
                pl, dspec, n, d, "dense", dev.type)):
            dm = _obs.maybe_block(dense_fn(x))
        res = engine.run(dm, grouping, **run_kw)
        if ordination is not None:
            # the dense bridge budgets (n, n) transients: G and eigh
            with _obs.span("pipeline.pcoa"):
                ordn = _ordination.pcoa_eigh(dm * dm, ordination)
    else:
        with _obs.span(f"stage1.{metric}", _stage1_attrs(
                pl, dspec, n, d, "stream", dev.type)):
            mat2, gower = _streaming.build_mat2_streaming(
                prepare(x), rows_fn, block=pl.row_block)
        res = engine.run(mat2, grouping, squared=True, s_t=gower.s_t,
                         **run_kw)
        if ordination is not None:
            # the implicit centered operator on the same mat2 and the
            # marginals the streaming pass accumulated: no second (n, n)
            with _obs.span("pipeline.pcoa"):
                ordn = _ordination.pcoa_subspace(mat2, ordination,
                                                 stats=gower)

    # engine.run planned stage 2 (autotune may have picked it): report
    # its record once
    executed_sw = res.method.split("[", 1)[1].rstrip("]")
    return dataclasses.replace(
        res,
        method=f"pipeline[{pl.dist_impl}->{pl.materialize}->{executed_sw}]",
        plan=f"{pl.describe_stage1()} | {pl.reason} :: {res.plan}",
        ordination=ordn)


_MESH_DESIGN = ("single-study mesh execution supports plain single-factor "
                "designs only; shard design studies over the 'data' axis "
                "via pipeline_many/permanova_many instead")


def _features_ordination(pl: _planner.PipelinePlan, xprep, rows_fn,
                         ordination):
    """The fused bridges' PCoA: every matvec of the subspace iteration
    rebuilds the squared-distance slabs from the features (on the card
    through the distance kernel), so nothing (n, n) is added. None
    without ordination=."""
    if ordination is None:
        return None
    with _obs.span("pipeline.pcoa"):
        return _ordination.pcoa_features(xprep, rows_fn, ordination,
                                         row_block=pl.row_block)


def _fused_bridge(pl: _planner.PipelinePlan, xprep, rows_fn, grouping,
                  n_perms: int, n_groups: int, seed: int, perms,
                  index_perms, draw_budget, *, d: int, mesh=None):
    """The fused and fused-kernel bridges: s_W from the streaming sweeps
    (over `mesh`, the sharded fused-kernel sweep), then F and p as
    engine.run assembles them; the joint plan string is authoritative (no
    engine.run runs). Each bridge is a span while tracing (`bridge.fused`
    / `bridge.fused-kernel`, `_fused_attrs`)."""
    n = int(xprep.shape[0])
    n_total = n_perms + 1
    inv_gs = permutations.inv_group_sizes(grouping, n_groups)
    backend = xprep.device.type
    if pl.materialize == "fused":
        with _obs.span("bridge.fused", _fused_attrs(
                pl, n, d, n_groups, n_total, backend=backend)):
            s_w, s_t, stats = _streaming.fused_sw(
                xprep, rows_fn, grouping, inv_gs, n_total,
                row_block=pl.row_block, chunk=pl.sw.chunk, seed=seed,
                perms=perms, index_perms=index_perms,
                draw_budget=draw_budget)
            _obs.maybe_block(s_w)
        ran = (f"rows={stats.row_block}x{stats.n_row_blocks} "
               f"chunks={stats.n_chunks} "
               f"slab={stats.peak_slab_bytes/2**20:.1f}MiB")
    else:
        fspec = _registry.get_fused(pl.fused_impl)
        with _obs.span("bridge.fused-kernel", _fused_attrs(
                pl, n, d, n_groups, n_total, fspec=fspec, backend=backend)):
            if mesh is not None:
                s_w, s_t, stats = _streaming.fused_sw_sharded(
                    mesh, xprep, rows_fn, grouping, inv_gs, n_total,
                    impl=fspec.kind, kernel_metric=fspec.kernel_metric,
                    row_block=pl.row_block, chunk=pl.sw.chunk,
                    tuning=pl.fused_tuning, seed=seed, perms=perms,
                    draw_budget=_draw_budget(pl, draw_budget))
            else:
                s_w, s_t, stats = _streaming.fused_kernel_sw(
                    xprep, rows_fn, grouping, inv_gs, n_total,
                    impl=fspec.kind, kernel_metric=fspec.kernel_metric,
                    row_block=pl.row_block, chunk=pl.sw.chunk,
                    tuning=pl.fused_tuning, seed=seed, perms=perms,
                    index_perms=index_perms,
                    draw_budget=_draw_budget(pl, draw_budget))
            _obs.maybe_block(s_w)
        _obs.record_device_memory()
        ran = _kernel_ran(stats, mesh is not None)
    return _sweep_result(
        s_w, s_t, n, n_groups, n_perms,
        method=f"pipeline[{pl.dist_impl}->{pl.materialize}->{pl.sw.impl}]",
        plan=f"{pl.describe()} :: {ran}")


def _sweep_result(s_w, s_t, n: int, n_groups: int, n_perms: int, *,
                  method: str, plan: str) -> PermanovaResult:
    """F and p from a labels sweep's float64 s_W (n_perms + 1,) and s_T,
    as engine.run assembles them."""
    s_t = s_t.to(torch.float32)
    f_all = f_from_sw(s_w.to(torch.float32), s_t, n, n_groups)
    return PermanovaResult(
        f_stat=f_all[0], p_value=p_value_from_null(f_all), s_t=s_t,
        s_w=s_w[0].to(torch.float32), f_perms=f_all, n_objects=n,
        n_groups=n_groups, n_perms=n_perms, method=method, plan=plan)


def _kernel_ran(stats, mesh: bool = False) -> str:
    """How a fused-kernel sweep ran, for the plan record: its chunks and
    buffers ('+mesh' when sharded), and on the card the kernel's slots and
    the draws' sub-blocks (rows and modelled transients)."""
    ran = (f"{stats.impl}{'+mesh' if mesh else ''} rows={stats.row_block} "
           f"chunks={stats.n_chunks} "
           f"slab={stats.peak_slab_bytes/2**20:.2f}MiB "
           f"labels={stats.peak_label_bytes/2**20:.2f}MiB")
    if stats.impl == "cuda" and not mesh:
        ran += (f" slots={stats.slots} draw={stats.draw_rows}rows/"
                f"{stats.peak_draw_bytes/2**20:.2f}MiB")
    return ran


def _draw_budget(pl: _planner.PipelinePlan, memory_budget_bytes):
    """The budget of a fused-kernel sweep's label or index draws: on the
    card what the planned workset leaves of the label budget, else the
    label budget itself."""
    return (memory_budget_bytes if pl.draw_budget is None
            else pl.draw_budget)


def _build_design(grouping, covariates, strata, weights, n_groups, n: int,
                  dev: torch.device):
    """The call's design (a Design passed as the grouping, or built from
    covariates / strata / weights), or None for plain labels; a plain
    labels design comes back as (grouping, n_groups, None)."""
    design = None
    if isinstance(grouping, _design.Design):
        if covariates is not None or strata is not None \
                or weights is not None:
            raise ValueError("pass covariates/strata/weights either to "
                             "pipeline() or inside the Design, not both")
        design = grouping.to(dev)
    elif covariates is not None or strata is not None or weights is not None:
        design = _design.build(grouping=grouping, covariates=covariates,
                               strata=strata, weights=weights,
                               n_groups=n_groups, n=int(n), device=dev)
    if design is not None and design.is_plain_labels:
        return design.grouping, design.n_groups, None
    return grouping, n_groups, design


def _pipeline_ooc(cache: _slabcache.SlabCache, grouping, *, metric: str,
                  n_perms: int, seed: int, perms, index_perms, n_groups,
                  dist_impl, sw_impl, materialize, row_block, chunk,
                  memory_budget_bytes, matrix_budget_bytes,
                  slab_budget_bytes, dist_tuning, fused_impl, fused_tuning,
                  mesh, ordination, covariates, strata, weights, autotune,
                  device_budget_bytes, host_budget_bytes,
                  dev: torch.device) -> PermanovaResult:
    """pipeline() when the features live in a slab cache.

    The planner grades the residency tier from the f32 table: 'hbm'
    reads the cache once and runs the ordinary resident path (its plan
    marked `features=slab-cache(residency=hbm)`); 'host' / 'disk' run the
    out-of-core sweep (pipeline.streaming.fused_sw_ooc: the prefetcher
    streams slab k+1 while slab k's distance tiles are built, on the card
    by the distance kernel, one launch a (row slab, column slab) pair,
    and the fused bridge's own sweep contracts each assembled row slab),
    so F, p and the null are the in-memory fused bridge's at row_block ==
    slab_rows bit for bit, for labels, labels within strata and dense
    designs (on the card through the '.cuda' kernels; a pinned cuBLAS
    impl is not promised it). Out of core, ordination raises (it needs resident
    features) and autotune is ignored with a warning (its shoot-outs run
    on resident operands).
    """
    n, d = cache.n, cache.d
    n_total = n_perms + 1
    if mesh is not None:
        raise ValueError("slab-cache features run single-device; mesh "
                         "execution needs the resident table")
    if cache.fmt == "csr" and metric != "jaccard":
        raise ValueError(
            f"csr slab caches store presence structure only; metric "
            f"{metric!r} needs the dense format (jaccard reads it)")
    grouping, n_groups, design = _build_design(
        grouping, covariates, strata, weights, n_groups, n, dev)
    dense_mode = design is not None and design.mode == _design.MODE_DENSE
    if design is None:
        if grouping is None:
            raise ValueError("pipeline needs grouping labels, covariates, "
                             "or a Design")
        grouping = torch.as_tensor(grouping).to(dev, torch.int32)
        if n_groups is None:
            n_groups = int(grouping.max()) + 1
        n_groups_plan = n_groups
    else:
        if design.n != n:
            raise ValueError(f"design is for n={design.n}, cache is "
                             f"({n}, {d})")
        if dense_mode and perms is not None:
            raise ValueError("perms= (explicit labels) applies to "
                             "labels-mode designs; a dense design takes "
                             "index_perms=")
        n_groups_plan = (design.n_groups if design.n_groups is not None
                         else design.rank)
    k = design.k_cols if dense_mode else None
    pl = _planner.plan_pipeline(
        n, d, n_total, n_groups_plan, backend=dev.type, metric=metric,
        dist_impl=dist_impl, materialize=materialize, row_block=row_block,
        matrix_budget_bytes=matrix_budget_bytes,
        slab_budget_bytes=slab_budget_bytes,
        memory_budget_bytes=memory_budget_bytes, sw_impl=sw_impl,
        chunk=chunk, fused_impl=fused_impl, fused_tuning=fused_tuning,
        design_cols=k, draw=("strata" if design is not None
                             and not dense_mode else "labels"),
        features_on_disk=True, slab_rows=cache.slab_rows,
        features_disk_bytes=cache.disk_bytes,
        device_budget_bytes=device_budget_bytes,
        host_budget_bytes=host_budget_bytes, dist_tuning=dist_tuning,
        sparse_design=dense_mode and bool(_streaming._design_groups(design)))

    if pl.residency == "hbm":
        # the f32 table fits the device budget: read the cache ONCE and
        # run the ordinary resident path
        res = pipeline(
            torch.from_numpy(cache.to_array()),
            grouping if design is None else design, metric=metric,
            n_perms=n_perms, seed=seed, perms=perms,
            index_perms=index_perms, n_groups=n_groups,
            dist_impl=dist_impl, sw_impl=sw_impl, materialize=materialize,
            row_block=row_block, chunk=chunk,
            memory_budget_bytes=memory_budget_bytes,
            matrix_budget_bytes=matrix_budget_bytes,
            slab_budget_bytes=slab_budget_bytes, dist_tuning=dist_tuning,
            fused_impl=fused_impl, fused_tuning=fused_tuning,
            ordination=ordination, autotune=autotune, device=dev)
        return dataclasses.replace(
            res, plan=f"{res.plan} | features=slab-cache(residency=hbm)")

    if ordination is not None:
        raise ValueError(
            "ordination needs resident features; raise "
            "device_budget_bytes (residency must reach 'hbm') or run it "
            "separately on a subsample")
    if autotune:
        warnings.warn(
            "autotune=True ignored out of core: the shoot-outs run on "
            "resident operands", stacklevel=3)
    prepare, rows_fn, _ = _registry.get(pl.dist_impl).bound(
        **{**pl.dist_tuning, **(dist_tuning or {})})
    sweep_kw = dict(chunk=pl.sw.chunk, seed=seed, index_perms=index_perms,
                    draw_budget=memory_budget_bytes)
    span_attrs = None
    if _obs.trace_enabled():
        # the reference's model: the disk reads, (n_slabs + 1) passes
        predicted = _registry.ooc_disk_traffic_bytes(cache.n_slabs,
                                                     cache.disk_bytes)
        _obs.metrics.inc("pipeline.predicted_bytes", predicted)
        span_attrs = {"bridge": f"ooc-{pl.materialize}",
                      "residency": pl.residency,
                      "predicted_bytes": predicted}
    with _obs.span("bridge.ooc", span_attrs):
        if design is None:
            inv_gs = permutations.inv_group_sizes(grouping, n_groups)
            s_w, s_t, ost = _streaming.fused_sw_ooc(
                cache, prepare, rows_fn, grouping, inv_gs, n_total,
                perms=perms, **sweep_kw)
        elif dense_mode:
            s_cols, _, ost = _streaming.fused_sw_ooc_design(
                cache, prepare, rows_fn, design, n_total, **sweep_kw)
        else:
            inv_gs = permutations.inv_group_sizes(design.grouping,
                                                  design.n_groups)
            s_w, s_t, ost = _streaming.fused_sw_ooc(
                cache, prepare, rows_fn, design.grouping, inv_gs, n_total,
                perms=perms, strata=design.strata, **sweep_kw)
        if span_attrs is not None:
            # read at the span's exit: the measured overlap evidence
            # lands in the trace
            span_attrs["stall_ms"] = round(ost.stall_s * 1e3, 3)
            span_attrs["disk_bytes_read"] = ost.disk_bytes_read
    _obs.record_device_memory()

    sweep = (f"residency={pl.residency} slabs={ost.n_slabs}"
             f"x{ost.slab_rows} chunks={ost.n_chunks} "
             f"read={ost.disk_bytes_read/2**20:.1f}MiB "
             f"stall={ost.stall_s*1e3:.1f}ms/{ost.sweep_s*1e3:.0f}ms "
             f"tiles={ost.tiles} ({pl.dist_impl})")
    form = f"ooc-{pl.materialize}"
    if design is None:
        res = _sweep_result(s_w, s_t, n, n_groups, n_perms,
                            method=f"pipeline[{form}]", plan=sweep)
    elif dense_mode:
        res = engine.design_result(
            s_cols.to(torch.float32), design, n_objects=n, n_perms=n_perms,
            method=f"pipeline-design[{form}]", plan=sweep)
    else:
        res = engine.label_design_result(
            s_w.to(torch.float32), s_t.to(torch.float32), design,
            n_objects=n, n_perms=n_perms, method=f"pipeline[{form}+strata]",
            plan=f"{sweep} strata")
    return dataclasses.replace(res, plan=f"{pl.describe()} :: {res.plan}",
                               ooc_stats=ost)


def _pipeline_design(x: torch.Tensor, design: _design.Design, *,
                     metric: str, n_perms: int, seed: int, perms,
                     index_perms, dist_impl: str, sw_impl: str,
                     materialize: str, row_block, chunk,
                     memory_budget_bytes, matrix_budget_bytes,
                     slab_budget_bytes, dist_tuning, fused_impl,
                     fused_tuning, dev: torch.device, ordination=None,
                     autotune: bool = False) -> PermanovaResult:
    """features -> per-term F and p for a non-plain design.

    Every bridge keeps its residency contract: dense and stream hand the
    (squared) distance matrix to engine.run_design; the fused bridges
    contract the permuted basis (dense designs) or strata-restricted
    labels (one factor with strata) against D^2 row slabs or tiles as the
    label sweeps do — only the right-hand operand changes.
    """
    n, d = (int(v) for v in x.shape)
    if design.n != n:
        raise ValueError(f"design is for n={design.n}, features are "
                         f"({n}, {d})")
    n_total = n_perms + 1
    dense_mode = design.mode == _design.MODE_DENSE
    if dense_mode and perms is not None:
        raise ValueError("perms= (explicit labels) applies to labels-mode "
                         "designs; a dense design takes index_perms=")
    k = design.k_cols if dense_mode else None
    n_groups_plan = (design.n_groups if design.n_groups is not None
                     else design.rank)

    def _plan():
        return _planner.plan_pipeline(
            n, d, n_total, n_groups_plan, backend=dev.type, metric=metric,
            dist_impl=dist_impl, materialize=materialize,
            row_block=row_block, matrix_budget_bytes=matrix_budget_bytes,
            slab_budget_bytes=slab_budget_bytes,
            memory_budget_bytes=memory_budget_bytes, sw_impl=sw_impl,
            chunk=chunk, fused_impl=fused_impl, fused_tuning=fused_tuning,
            design_cols=k, draw=("strata" if k is None
                                 and design.strata is not None
                                 else "labels"))

    pl = _plan()
    if autotune and pl.materialize in ("dense", "stream") \
            and dist_impl == "auto":
        # the reference measures stage 1 only on a design's dense and
        # stream bridges
        dist_impl = _planner.autotune_stage1(x, metric)
        pl = _plan()
    dspec = _registry.get(pl.dist_impl)
    prepare, rows_fn, dense_fn = dspec.bound(
        **{**pl.dist_tuning, **(dist_tuning or {})})
    labels = dict(seed=seed, index_perms=index_perms)
    if not dense_mode:
        labels.update(perms=perms)
    # the fused sweeps draw in sub-blocks sized to the label budget
    sweep_labels = dict(labels, draw_budget=memory_budget_bytes)

    ordn = xprep = None
    if pl.materialize in ("dense", "stream"):
        run_kw = dict(n_perms=n_perms, impl=sw_impl,
                      memory_budget_bytes=memory_budget_bytes, chunk=chunk,
                      device=dev, **labels)
        stage1 = _obs.span(f"stage1.{metric}", _stage1_attrs(
            pl, dspec, n, d, pl.materialize, dev.type))
        if pl.materialize == "dense":
            with stage1:
                dm = _obs.maybe_block(dense_fn(x))
            res = engine.run_design(dm, design, **run_kw)
            if ordination is not None:
                with _obs.span("pipeline.pcoa"):
                    ordn = _ordination.pcoa_eigh(dm * dm, ordination)
        else:
            with stage1:
                mat2, gower = _streaming.build_mat2_streaming(
                    prepare(x), rows_fn, block=pl.row_block)
            res = engine.run_design(mat2, design, squared=True,
                                    s_t=gower.s_t, **run_kw)
            if ordination is not None:
                # no span here: the reference has none at this site
                ordn = _ordination.pcoa_subspace(mat2, ordination,
                                                 stats=gower)
    elif pl.materialize == "fused":
        xprep = prepare(x)
        fused_span = _obs.span("bridge.fused", _fused_attrs(
            pl, n, d, n_groups_plan, n_total, backend=dev.type))
        if dense_mode:
            with fused_span:
                s_cols, _, stats = _streaming.fused_sw_design(
                    xprep, rows_fn, design, n_total,
                    row_block=pl.row_block, chunk=pl.sw.chunk,
                    **sweep_labels)
                _obs.maybe_block(s_cols)
            res = engine.design_result(
                s_cols.to(torch.float32), design, n_objects=n,
                n_perms=n_perms, method="pipeline-design[fused]",
                plan=(f"rows={stats.row_block}x{stats.n_row_blocks} "
                      f"chunks={stats.n_chunks} cols={k}"))
        else:
            inv_gs = permutations.inv_group_sizes(design.grouping,
                                                  design.n_groups)
            with fused_span:
                s_w, s_t, stats = _streaming.fused_sw(
                    xprep, rows_fn, design.grouping, inv_gs, n_total,
                    row_block=pl.row_block, chunk=pl.sw.chunk,
                    strata=design.strata, **sweep_labels)
                _obs.maybe_block(s_w)
            res = engine.label_design_result(
                s_w.to(torch.float32), s_t.to(torch.float32), design,
                n_objects=n, n_perms=n_perms,
                method="pipeline[fused+strata]",
                plan=(f"rows={stats.row_block}x{stats.n_row_blocks} "
                      f"chunks={stats.n_chunks} strata"))
    else:   # fused-kernel (the planner validates the mode)
        fspec = _registry.get_fused(pl.fused_impl)
        xprep = prepare(x)
        kw = dict(impl=fspec.kind, kernel_metric=fspec.kernel_metric,
                  row_block=pl.row_block, chunk=pl.sw.chunk,
                  tuning=pl.fused_tuning)
        sweep_labels.update(draw_budget=_draw_budget(pl,
                                                     memory_budget_bytes))
        kernel_span = _obs.span("bridge.fused-kernel", _fused_attrs(
            pl, n, d, n_groups_plan, n_total, fspec=fspec,
            backend=dev.type, n_cols=k))
        if dense_mode:
            with kernel_span:
                s_cols, _, stats = _streaming.fused_kernel_sw_design(
                    xprep, rows_fn, design, n_total, **kw, **sweep_labels)
                _obs.maybe_block(s_cols)
            _obs.record_device_memory()
            res = engine.design_result(
                s_cols.to(torch.float32), design, n_objects=n,
                n_perms=n_perms,
                method=f"pipeline-design[fused-kernel:{stats.impl}]",
                plan=f"{_kernel_ran(stats)} cols={k}")
        else:
            inv_gs = permutations.inv_group_sizes(design.grouping,
                                                  design.n_groups)
            with kernel_span:
                s_w, s_t, stats = _streaming.fused_kernel_sw(
                    xprep, rows_fn, design.grouping, inv_gs, n_total,
                    strata=design.strata, **kw, **sweep_labels)
                _obs.maybe_block(s_w)
            _obs.record_device_memory()
            res = engine.label_design_result(
                s_w.to(torch.float32), s_t.to(torch.float32), design,
                n_objects=n, n_perms=n_perms,
                method=f"pipeline[fused-kernel:{stats.impl}+strata]",
                plan=f"{_kernel_ran(stats)} strata")
    if xprep is not None:
        ordn = _features_ordination(pl, xprep, rows_fn, ordination)
    return dataclasses.replace(
        res, plan=(f"{pl.describe_stage1()} | {pl.reason} :: {res.plan} "
                   f"({design.describe()})"), ordination=ordn)


# ---------------------------------------------------------------------------
# Many-study pipeline: a stack of studies' features.
# ---------------------------------------------------------------------------

def pipeline_many(xs, groupings, *, n_groups: int,
                  metric: str = "braycurtis", n_perms: int = 999,
                  seed: int = 0, perms: Optional[torch.Tensor] = None,
                  index_perms: Optional[torch.Tensor] = None,
                  dist_impl: str = "auto", sw_impl: str = "auto",
                  materialize: str = "auto",
                  row_block: Optional[int] = None,
                  chunk: Optional[int] = None,
                  memory_budget_bytes: Optional[float] = None,
                  matrix_budget_bytes: Optional[float] = None,
                  fused_impl: str = "auto",
                  fused_tuning: Optional[Dict[str, int]] = None,
                  mesh=None, covariates=None, strata=None, weights=None,
                  ordination: Optional[int] = None,
                  device="cuda") -> engine.PermanovaManyResult:
    """Stacked studies' features -> F and p, study by study under one plan.

    xs:          (S, n, d) abundance tables; groupings (S, n) labels in
                 [0, n_groups).
    materialize: 'auto' | 'dense' | 'fused-kernel'. The dense bridge
                 builds each study's (n, n) distances (the (S, n, n) stack
                 must fit the matrix budget) and runs engine.permanova_many;
                 the fused-kernel bridge runs each study's single-pass
                 sweep (on the card the fused kernels, each study's workset
                 and draws held to the label budget), nothing (n, n)-shaped
                 ever resident. 'auto' picks fused-kernel exactly when the
                 stack would exceed the matrix budget.
    seed:        study s draws from core.permutations.study_seed(seed, s):
                 its F and p equal pipeline(xs[s], groupings[s],
                 seed=study_seed(seed, s)) at the same bridge and budget,
                 bit for bit, on every path.
    perms / index_perms: explicit (S, n_perms + 1, n) per-study draws.
    covariates / strata / weights: stacked per-study design columns ((S,
                 n, c) / (S, n)); the batch then runs the dense-design
                 forms (every study one dense structure, as the
                 reference's batch), per-term statistics in `.terms`.
    device:      'cuda' (default; raises without a card) or 'cpu'.

    ordination:  k: each study's top-k PCoA axes, stacked (S, n, k) in
                 `result.ordination`: from the distance stack on the
                 dense bridge (engine.permanova_many), from each study's
                 feature-streamed slabs on the fused-kernel bridge
                 (nothing (n, n) added).

    mesh:        a DeviceMesh with a 'data' axis shards the STUDY axis of
                 the fused-kernel bridge (materialize 'auto' picks it; any
                 other raises ValueError): every rank passes the same
                 batch, runs its block of studies (engine.api.
                 put_study_sharded; S wrap-padded to a multiple of 'data'),
                 each exactly as its serial run, and returns the whole
                 batch, all-gathered. The plan ends [studies@data[k]
                 (+padN)].

    The studies run one after another. A 'cuda' plan gives each study the
    whole label budget (the reference splits it S ways because its vmap
    holds every study live); a 'cpu' plan keeps the reference's 1/S.
    """
    if mesh is not None and materialize not in ("auto", "fused-kernel"):
        raise ValueError("mesh execution of pipeline_many is fused-kernel "
                         "only; use materialize='auto'/'fused-kernel'")
    dev = engine.api._many_device(mesh, device)
    xs = torch.as_tensor(xs)        # each study moves to dev as it runs
    if xs.dim() != 3:
        raise ValueError(f"stacked features must be (S, n, d); got shape "
                         f"{tuple(xs.shape)}")
    groupings = torch.as_tensor(groupings).to(dev, torch.int32)
    s_count, n, d = (int(v) for v in xs.shape)
    if tuple(groupings.shape) != (s_count, n):
        raise ValueError(f"groupings must be (S, n) = {(s_count, n)}, got "
                         f"{tuple(groupings.shape)}")
    n_total = n_perms + 1
    stack_bytes = 4 * s_count * n * n
    matrix_budget = (_planner.DEFAULT_MATRIX_BUDGET_BYTES
                     if matrix_budget_bytes is None else matrix_budget_bytes)
    if materialize == "auto":
        materialize = ("fused-kernel"
                       if mesh is not None or stack_bytes > matrix_budget
                       else "dense")
    if materialize not in ("dense", "fused-kernel"):
        raise ValueError(
            f"pipeline_many supports materialize='dense'/'fused-kernel' "
            f"(got {materialize!r}); stream/fused are single-study bridges")
    designed = (covariates is not None or strata is not None
                or weights is not None)
    if materialize == "dense":
        pl = _planner.plan_pipeline(
            n, d, n_total, n_groups, backend=dev.type, metric=metric,
            dist_impl=dist_impl, row_block=row_block, materialize="dense",
            matrix_budget_bytes=matrix_budget_bytes,
            memory_budget_bytes=memory_budget_bytes,
            sw_impl=None if designed else sw_impl, chunk=chunk)
        if stack_bytes > matrix_budget:
            warnings.warn(
                f"pipeline_many materializes the full (S, n, n) stack "
                f"({stack_bytes / 2 ** 20:.0f}MiB), exceeding the matrix "
                f"budget ({matrix_budget / 2 ** 20:.0f}MiB); use "
                "materialize='fused-kernel' (never builds the stack) or "
                "split the studies", stacklevel=2)
        _, _, dense_fn = _registry.get(pl.dist_impl).bound(**pl.dist_tuning)
        dms = torch.stack([dense_fn(xs[s].to(dev, torch.float32))
                           for s in range(s_count)])
        res = engine.permanova_many(
            dms, groupings, n_groups=n_groups, n_perms=n_perms, seed=seed,
            perms=perms, index_perms=index_perms,
            impl="auto" if designed else sw_impl, chunk=chunk,
            memory_budget_bytes=memory_budget_bytes, covariates=covariates,
            strata=strata, weights=weights, ordination=ordination,
            device=dev)
        res.plan = f"{pl.dist_impl} -> dense(per study) -> {res.plan}"
        return res
    budget = engine.api._study_budgets(dev.type, memory_budget_bytes,
                                       s_count)
    designs = (engine.api._build_study_designs(
        groupings, covariates, strata, weights, n_groups=n_groups,
        s_count=s_count, sizes=[n] * s_count, device=dev)
        if designed else None)
    block = engine.api.put_study_sharded(mesh, s_count)
    results = []
    for s in block.studies:
        x = xs[s].to(dev, torch.float32)
        kw = dict(metric=metric, n_perms=n_perms,
                  seed=permutations.study_seed(seed, s),
                  index_perms=None if index_perms is None else index_perms[s],
                  dist_impl=dist_impl, sw_impl="auto",
                  materialize="fused-kernel", row_block=row_block,
                  chunk=chunk, memory_budget_bytes=budget,
                  matrix_budget_bytes=matrix_budget_bytes,
                  slab_budget_bytes=None, dist_tuning=None,
                  fused_impl=fused_impl, fused_tuning=fused_tuning,
                  ordination=ordination)
        if designed:
            kw.update(perms=None, dev=dev)
            results.append(_pipeline_design(x, designs[s], **kw))
        else:
            results.append(pipeline(
                x, groupings[s], n_groups=n_groups,
                perms=None if perms is None else perms[s], device=dev,
                **{k: v for k, v in kw.items() if k not in (
                    "slab_budget_bytes", "dist_tuning")}))
        del x
    engine.api._count_studies(block.n_own)
    local = _stack_results(results, n_objects=n, n_groups=n_groups,
                           n_perms=n_perms)
    return engine.api.gather_studies(
        mesh, local, s_count,
        f"{results[0].plan} studies={s_count} [{block.where}]")


def _stack_results(results, *, n_objects: int, n_groups: int,
                   n_perms: int) -> engine.PermanovaManyResult:
    """Stack per-study PermanovaResults (one plan) into the many-study
    result (its plan is the caller's)."""
    def stack(get):
        return torch.stack([get(r) for r in results])
    terms = ordn = None
    if results[0].ordination is not None:
        ordn = _ordination.PCoAResult(
            coords=stack(lambda r: r.ordination.coords),
            eigvals=stack(lambda r: r.ordination.eigvals),
            explained=stack(lambda r: r.ordination.explained),
            method=results[0].ordination.method,
            iterations=tuple(r.ordination.iterations for r in results))
    if results[0].terms is not None:
        terms = tuple(dataclasses.replace(
            t, ss=stack(lambda r, i=i: r.terms[i].ss),
            f_stat=stack(lambda r, i=i: r.terms[i].f_stat),
            p_value=stack(lambda r, i=i: r.terms[i].p_value),
            r2=stack(lambda r, i=i: r.terms[i].r2),
            f_perms=stack(lambda r, i=i: r.terms[i].f_perms))
            for i, t in enumerate(results[0].terms))
    return engine.PermanovaManyResult(
        f_stat=stack(lambda r: r.f_stat), p_value=stack(lambda r: r.p_value),
        s_t=stack(lambda r: r.s_t), s_w=stack(lambda r: r.s_w),
        f_perms=stack(lambda r: r.f_perms), n_objects=n_objects,
        n_groups=n_groups, n_perms=n_perms, terms=terms, ordination=ordn)
