"""Engine entry point: every PERMANOVA path of the port routes through here.

Twin of `repro/engine/api.py` for one study on one device: run() plans the
impl and the streaming chunk, runs the sweep through the scheduler and
assembles F and p. Every label argument routes through
`Design.from_labels`: a plain single-factor design is the label path
below, anything else (strata, covariates, weights) goes to run_design().
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import hw
from repro_torch.core import design as design_mod
from repro_torch.core import permutations
from repro_torch.core.permanova import (PermanovaResult, TermResult,
                                        f_from_sw, p_value_from_null, s_total)
from repro_torch.engine import planner, registry, scheduler


def run(dm, grouping, *, n_perms: int = 999, seed: int = 0,
        perms: Optional[torch.Tensor] = None,
        index_perms: Optional[torch.Tensor] = None,
        n_groups: Optional[int] = None, impl: str = "auto",
        sw_fn: Optional[Callable] = None,
        memory_budget_bytes: Optional[float] = None,
        chunk: Optional[int] = None, squared: bool = False,
        s_t: Optional[float] = None,
        covariates=None, strata=None, weights=None,
        device="cuda") -> PermanovaResult:
    """Full PERMANOVA through the engine.

    dm:     (n, n) distance matrix with a zero diagonal (tensor or array).
    grouping: (n,) labels, or a core.design.Design (then covariates /
            strata / weights stay None).
    covariates / strata / weights: build a design (core.design.build);
            the result then carries per-term statistics in `.terms`.
    seed / perms / index_perms: the port's counter-based draws from
            `seed`, an explicit (n_perms + 1, n) int32 label tensor
            (labels-mode designs only), or explicit (n_perms + 1, n)
            int32 index permutations; row 0 of either is the identity —
            the counterparts of the reference's `key=`.
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
    dev = hw.resolve_device(device)
    if covariates is not None or strata is not None or weights is not None:
        if isinstance(grouping, design_mod.Design):
            raise ValueError("pass covariates/strata/weights either to "
                             "run() or inside the Design, not both")
        design = design_mod.build(
            grouping=grouping, covariates=covariates, strata=strata,
            weights=weights, n_groups=n_groups, device=dev)
    else:
        design = design_mod.Design.from_labels(grouping, n_groups=n_groups,
                                               device=dev).to(dev)
    if not design.is_plain_labels:
        if sw_fn is not None:
            raise ValueError("sw_fn is not supported with strata/covariate/"
                             "weighted designs; use a registry impl")
        return run_design(dm, design, n_perms=n_perms, seed=seed,
                          perms=perms, index_perms=index_perms, impl=impl,
                          memory_budget_bytes=memory_budget_bytes,
                          chunk=chunk, squared=squared, s_t=s_t,
                          device=dev)
    dm = torch.as_tensor(dm).to(dev, torch.float32)
    grouping, n_groups = design.grouping, design.n_groups
    n = dm.shape[0]
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
    s_w_all, stats = _sweep(pl, mat2, grouping, inv_gs, n_total, fn,
                            seed=seed, perms=perms, index_perms=index_perms,
                            draw_budget=memory_budget_bytes)

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


def _sweep(pl, mat2, grouping, inv_gs, n_total, fn, **labels):
    """The label sweep of a plan: streamed in chunks or in one batch."""
    if pl.streaming:
        return scheduler.sw_streaming(mat2, grouping, inv_gs, n_total, fn,
                                      chunk=pl.chunk, **labels)
    return scheduler.sw_batch(mat2, grouping, inv_gs, n_total, fn, **labels)


# ---------------------------------------------------------------------------
# Design path: strata-restricted label sweeps and dense hat-matrix designs.
# ---------------------------------------------------------------------------

def design_result(s_cols: torch.Tensor, design: design_mod.Design, *,
                  n_objects: int, n_perms: int, method: str,
                  plan: str) -> PermanovaResult:
    """Assemble the per-term results from the per-column sweep.

    s_cols: (n_total, K) per-column quadratic forms (index 0 = observed).
    The headline f_stat / p_value are the LAST term's (the covariate-
    adjusted factor of interest); every non-intercept term lands in
    `.terms`.
    """
    ts = design_mod.term_stats(s_cols, design)
    terms = []
    for i, t in enumerate(design.terms[1:]):
        f_p = ts.f_terms[:, i]
        terms.append(TermResult(
            name=t.name, kind=t.kind, df=t.df, ss=ts.ss_terms[0, i],
            f_stat=f_p[0], p_value=p_value_from_null(f_p),
            r2=ts.ss_terms[0, i] / ts.s_t, f_perms=f_p))
    last = terms[-1]
    return PermanovaResult(
        f_stat=last.f_stat, p_value=last.p_value, s_t=ts.s_t,
        s_w=ts.ss_resid[0], f_perms=last.f_perms, n_objects=n_objects,
        n_groups=(design.n_groups if design.n_groups is not None
                  else design.rank),
        n_perms=n_perms, method=method, plan=plan, terms=tuple(terms))


def label_design_result(s_w_all: torch.Tensor, s_t: torch.Tensor,
                        design: design_mod.Design, *, n_objects: int,
                        n_perms: int, method: str,
                        plan: str) -> PermanovaResult:
    """Result assembly for LABELS-mode designs (one factor with strata):
    the classic F from s_W, with the factor reported as the one term."""
    n_groups = design.n_groups
    f_all = f_from_sw(s_w_all, s_t, n_objects, n_groups)
    factor = design.terms[-1]
    ss_a = s_t - s_w_all[0]
    p_val = p_value_from_null(f_all)
    terms = (TermResult(
        name=factor.name, kind=factor.kind, df=factor.df, ss=ss_a,
        f_stat=f_all[0], p_value=p_val, r2=ss_a / s_t, f_perms=f_all),)
    return PermanovaResult(
        f_stat=f_all[0], p_value=p_val, s_t=s_t, s_w=s_w_all[0],
        f_perms=f_all, n_objects=n_objects, n_groups=n_groups,
        n_perms=n_perms, method=method, plan=plan, terms=terms)


def run_design(dm, design: design_mod.Design, *, n_perms: int = 999,
               seed: int = 0, perms: Optional[torch.Tensor] = None,
               index_perms: Optional[torch.Tensor] = None,
               impl: str = "auto",
               memory_budget_bytes: Optional[float] = None,
               chunk: Optional[int] = None, squared: bool = False,
               s_t: Optional[float] = None,
               device="cuda") -> PermanovaResult:
    """Full PERMANOVA for a non-plain design (strata / covariates /
    weights / several factors) on a resident (squared) distance matrix.

    Labels-mode designs (one factor with strata) run the same registry
    impls as run(), kernels included, on strata-restricted labels. Dense
    designs run the per-column contraction of the permuted basis (a
    registry impl's `cols` companion), with the chunk sized for K columns.
    perms (explicit labels) applies to labels-mode designs only;
    index_perms (explicit index permutations) to both.
    """
    dev = hw.resolve_device(device)
    design = design.to(dev)
    dm = torch.as_tensor(dm).to(dev, torch.float32)
    n = dm.shape[0]
    if design.n != n:
        raise ValueError(f"design is for n={design.n}, matrix is {n}x{n}")
    mat2 = dm if squared else dm * dm
    n_total = n_perms + 1
    pinned = None if impl == "auto" else impl

    if design.mode == design_mod.MODE_LABELS:
        grouping, n_groups = design.grouping, design.n_groups
        inv_gs = permutations.inv_group_sizes(grouping, n_groups)
        pl = planner.plan(n, n_total, backend=dev.type, impl=pinned,
                          memory_budget_bytes=memory_budget_bytes,
                          chunk=chunk)
        fn = registry.get(pl.impl).bound(**pl.tuning)
        s_w_all, stats = _sweep(pl, mat2, grouping, inv_gs, n_total, fn,
                                seed=seed, perms=perms, strata=design.strata,
                                index_perms=index_perms,
                                draw_budget=memory_budget_bytes)
        s_t = s_total(mat2) if s_t is None else torch.tensor(
            s_t, dtype=torch.float32, device=dev)
        return label_design_result(
            s_w_all, s_t, design, n_objects=n, n_perms=n_perms,
            method=f"permanova[{pl.impl}+strata]",
            plan=f"{pl.describe()} chunks={stats.n_chunks} strata")

    if perms is not None:
        raise ValueError("perms= (explicit labels) applies to labels-mode "
                         "designs; a dense design takes index_perms=")
    k = design.k_cols
    pl = planner.plan(n, n_total, backend=dev.type, impl=pinned,
                      memory_budget_bytes=memory_budget_bytes, chunk=chunk,
                      n_cols=k)
    cols_fn = registry.bound_cols(pl.impl, **pl.tuning)
    strata = (design.strata if design.strata is not None
              else torch.zeros((n,), dtype=torch.int32, device=dev))
    s_cols, stats = scheduler.sw_cols_streaming(
        mat2, design.basis, strata, n_total, cols_fn, chunk=pl.chunk,
        seed=seed, index_perms=index_perms, draw_budget=memory_budget_bytes)
    return design_result(
        s_cols, design, n_objects=n, n_perms=n_perms,
        method=f"permanova-design[{pl.impl}]",
        plan=f"{pl.describe()} chunks={stats.n_chunks} cols={k}")
