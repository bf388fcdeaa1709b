"""Pipeline entry point: raw abundance table -> F statistic and p-value.

Twin of `repro/pipeline/api.py` for one study through the dense and
stream bridges: stage 1 and the bridge come from this package, stage 2
from engine.run. `core.permanova.permanova()` delegates here when handed
features instead of a matrix, and the launch CLI exposes it as
`--from-features`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from repro_torch import engine, hw
from repro_torch.core.permanova import PermanovaResult, _later
from repro_torch.pipeline import planner as _planner
from repro_torch.pipeline import registry as _registry
from repro_torch.pipeline import streaming as _streaming


def pipeline(x, grouping, *, metric: str = "braycurtis",
             n_perms: int = 999, seed: int = 0,
             perms: Optional[torch.Tensor] = None,
             n_groups: Optional[int] = None,
             dist_impl: str = "auto", sw_impl: str = "auto",
             materialize: str = "auto", row_block: Optional[int] = None,
             chunk: Optional[int] = None,
             memory_budget_bytes: Optional[float] = None,
             matrix_budget_bytes: Optional[float] = None,
             slab_budget_bytes: Optional[float] = None,
             dist_tuning: Optional[Dict[str, int]] = None,
             mesh=None, ordination: Optional[int] = None,
             covariates=None, strata=None, weights=None,
             autotune: bool = False, trace=None,
             device="cuda") -> PermanovaResult:
    """Full features->p-value PERMANOVA under one joint plan.

    x:           (n, d) abundance table (raw features, NOT distances).
    materialize: 'auto' | 'dense' | 'stream' — whether the (n, n) matrix
                 D is built outright (D and mat2 both resident), or its
                 squared row blocks are streamed into one mat2 buffer (D
                 never resident). 'fused' / 'fused-kernel', and an 'auto'
                 plan that resolves to them (not even one (n, n) buffer
                 fits matrix_budget_bytes), raise NotImplementedError.
    dist_impl:   'auto' or a registry name ('<metric>.cuda' — alias
                 '<metric>.pallas' — '.dense', '.blocked').
    dist_tuning: overrides of the impl's knobs, e.g. {'packed': 1} for
                 jaccard's popcount kernel.
    seed / perms: as engine.run — the port's labels from `seed`, or an
                 explicit (n_perms + 1, n) int32 label tensor.
    device:      'cuda' (default; raises without a card) or 'cpu'.

    Budgets split per stage: matrix/slab for distances,
    memory_budget_bytes for s_W labels. mesh, ordination, covariates,
    strata, weights, autotune, trace and out-of-core features (a slab
    cache or its path) raise NotImplementedError naming their slice.
    For the same labels both bridges give the same F and p-value (to f32
    accumulation order).
    """
    if isinstance(x, (str, os.PathLike)) or hasattr(x, "n_slabs"):
        raise _later("out-of-core features (a slab cache or its path)",
                     "out-of-core")
    if covariates is not None or strata is not None or weights is not None:
        raise _later("covariates/strata/weights (designs)", "designs")
    if mesh is not None:
        raise _later("mesh execution", "multi-device")
    if ordination is not None:
        raise _later("ordination (PCoA)", "ordination")
    if autotune:
        raise _later("autotune=True", "autotune")
    if trace:
        raise _later("trace=", "tracing (obs)")
    dev = hw.resolve_device(device)
    x = torch.as_tensor(x).to(dev, torch.float32)
    if x.dim() != 2:
        raise ValueError(f"features must be (n, d); got shape "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    grouping = torch.as_tensor(grouping).to(dev, torch.int32)
    if n_groups is None:
        n_groups = int(grouping.max()) + 1

    pl = _planner.plan_pipeline(
        n, d, n_perms + 1, n_groups, backend=dev.type, metric=metric,
        dist_impl=dist_impl, materialize=materialize, row_block=row_block,
        matrix_budget_bytes=matrix_budget_bytes,
        slab_budget_bytes=slab_budget_bytes,
        memory_budget_bytes=memory_budget_bytes, sw_impl=sw_impl,
        chunk=chunk)
    if pl.materialize in _planner.FUSED_MODES:
        raise _later(f"the {pl.materialize} bridge (planned: "
                     f"{pl.describe_stage1()}; pass materialize='dense'/"
                     "'stream' or a larger matrix_budget_bytes)",
                     "fused-kernel (slice 3)")
    # planner-resolved tuning (row block folded in) <- caller overrides
    prepare, rows_fn, dense_fn = _registry.get(pl.dist_impl).bound(
        **{**pl.dist_tuning, **(dist_tuning or {})})
    run_kw = dict(n_perms=n_perms, seed=seed, perms=perms,
                  n_groups=n_groups, impl=sw_impl,
                  memory_budget_bytes=memory_budget_bytes, chunk=chunk,
                  device=dev)
    if pl.materialize == "dense":
        res = engine.run(dense_fn(x), grouping, **run_kw)
    else:
        mat2, gower = _streaming.build_mat2_streaming(
            prepare(x), rows_fn, block=pl.row_block)
        res = engine.run(mat2, grouping, squared=True, s_t=gower.s_t,
                         **run_kw)

    # engine.run planned stage 2: report its record once
    executed_sw = res.method.split("[", 1)[1].rstrip("]")
    return dataclasses.replace(
        res,
        method=f"pipeline[{pl.dist_impl}->{pl.materialize}->{executed_sw}]",
        plan=f"{pl.describe_stage1()} | {pl.reason} :: {res.plan}")
