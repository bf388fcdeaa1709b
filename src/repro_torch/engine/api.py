"""Engine entry point: every PERMANOVA path of the port routes through here.

Twin of `repro/engine/api.py` for the plain-labels path: run() plans the
impl and the streaming chunk, runs the sweep through the scheduler and
assembles F and p.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import hw
from repro_torch.core import permutations
from repro_torch.core.permanova import (PermanovaResult, f_from_sw,
                                        p_value_from_null, s_total)
from repro_torch.engine import planner, registry, scheduler


def run(dm, grouping, *, n_perms: int = 999, seed: int = 0,
        perms: Optional[torch.Tensor] = None,
        n_groups: Optional[int] = None, impl: str = "auto",
        sw_fn: Optional[Callable] = None,
        memory_budget_bytes: Optional[float] = None,
        chunk: Optional[int] = None, squared: bool = False,
        s_t: Optional[float] = None,
        covariates=None, strata=None, weights=None,
        device="cuda") -> PermanovaResult:
    """Full PERMANOVA through the engine.

    dm:     (n, n) distance matrix with a zero diagonal (tensor or array).
    seed / perms: the port's counter-based labels from `seed`, or an
            explicit (n_perms + 1, n) int32 label tensor whose row 0 is the
            identity — the counterpart of the reference's `key=`.
    impl:   'auto' (planner) or a registry name (pallas_* aliases too).
    sw_fn:  bypass the registry with a custom batch callable.
    memory_budget_bytes / chunk: bound the live label tensor; sweeps
            larger than the chunk run through the streaming scheduler.
    squared: `dm` is already the element-squared matrix mat2 = D*D (the
            pipeline's stream bridge builds mat2 directly, so D is never
            resident beside it); it is not squared again.
    s_t:    precomputed total sum of squares (the stream bridge
            accumulates it as a Gower marginal); taken as given instead
            of one more full-matrix reduction.
    device: 'cuda' (default; raises without a card) or 'cpu'.
    """
    if covariates is not None or strata is not None or weights is not None:
        raise NotImplementedError(
            "covariates/strata/weights (designs) are not ported yet: they "
            "come with the designs slice of the port")
    dev = hw.resolve_device(device)
    dm = torch.as_tensor(dm).to(dev, torch.float32)
    grouping = torch.as_tensor(grouping).to(dev, torch.int32)
    n = dm.shape[0]
    if n_groups is None:
        n_groups = int(grouping.max()) + 1
    mat2 = dm if squared else dm * dm
    inv_gs = permutations.inv_group_sizes(grouping, n_groups)
    n_total = n_perms + 1

    # a custom sw_fn plans as matmul (the reference's stand-in), so the
    # plan string keeps the reference's form
    pinned = "matmul" if sw_fn is not None else (
        None if impl == "auto" else impl)
    pl = planner.plan(n, n_total, backend=dev.type, impl=pinned,
                      memory_budget_bytes=memory_budget_bytes, chunk=chunk)
    if sw_fn is None:
        fn = registry.get(pl.impl).bound(**pl.tuning)
    else:
        fn = sw_fn
        pl = dataclasses.replace(pl, impl="<custom sw_fn>", kernel=None,
                                 reason="caller-supplied sw_fn")

    if pl.streaming:
        s_w_all, stats = scheduler.sw_streaming(
            mat2, grouping, inv_gs, n_total, fn, chunk=pl.chunk, seed=seed,
            perms=perms)
    else:
        s_w_all, stats = scheduler.sw_batch(
            mat2, grouping, inv_gs, n_total, fn, seed=seed, perms=perms)

    s_t = s_total(mat2) if s_t is None else torch.tensor(
        s_t, dtype=torch.float32, device=dev)
    f_all = f_from_sw(s_w_all, s_t, n, n_groups)
    return PermanovaResult(
        f_stat=f_all[0],
        p_value=p_value_from_null(f_all),
        s_t=s_t,
        s_w=s_w_all[0],
        f_perms=f_all,
        n_objects=n,
        n_groups=n_groups,
        n_perms=n_perms,
        method=f"permanova[{pl.impl}]",
        plan=f"{pl.describe()} chunks={stats.n_chunks}",
    )
