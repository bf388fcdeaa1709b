"""Engine entry point: every PERMANOVA path of the port routes through here.

Twin of `repro/engine/api.py` on one device: run() plans the impl and the
streaming chunk, runs the sweep through the scheduler and assembles F and
p. Every label argument routes through `Design.from_labels`: a plain
single-factor design is the label path below, anything else (strata,
covariates, weights) goes to run_design(). permanova_many() runs a batch
of studies, stacked or ragged, one after another (over a DeviceMesh's
'data' axis each rank runs a block of them). While tracing (obs) the
call from outside is one `engine.run` span (attrs `seed`, `impl`, `n`,
`n_total`, `chunks`) holding an `engine.plan` span (every host step before
the sweep: the design, the matrix squared, the group sizes, the plan and
its impl; attrs `impl`, `reason`) and the sweep, an `engine.sw` span (a
batch of studies `engine.studies`) whose `predicted_bytes` is the traffic
model `_sw_traffic_bytes`; with metrics on, each run gauges the card's
peak memory and `engine.studies` counts the studies of a batch.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import hw
from repro_torch import obs as _obs
from repro_torch.core import design as design_mod
from repro_torch.core import permutations
from repro_torch.core.permanova import (PermanovaResult, TermResult,
                                        f_from_sw, p_value_from_null, s_total)
from repro_torch.engine import planner, registry, scheduler


def _sw_traffic_bytes(impl: str, n: int, n_total: int, chunk: int,
                      n_cols: int = 0, *, backend: str = "cpu",
                      n_groups: Optional[int] = None) -> float:
    """Predicted device traffic of the s_W sweep.

    On 'cpu', and for every path that runs no hand kernel (a dense
    design's per-column companion, a custom sw_fn), the reference's
    model number for number, per the paper's dataflow distinction:
    'brute' re-streams the full f32 mat2 once PER PERMUTATION, every
    other impl once per CHUNK, plus the (chunk, n) int32 labels of each
    chunk, (K + 1)-wide on the dense-design path. On 'cuda' a label
    sweep counts what the card's kernel moves, launch by launch
    (kernels.permanova_sw.ops.launch_bytes: brute stages each
    upper-triangle tile once per 128-permutation block, not once per
    permutation), plus the labels each chunk's draw writes."""
    n_chunks = -(-n_total // max(chunk, 1))
    kernel = None
    if backend == "cuda" and not n_cols and n_groups is not None:
        try:
            kernel = registry.get(impl).kernel
        except KeyError:      # a custom sw_fn
            kernel = None
    if kernel is None:
        mat2_passes = n_total if impl == "brute" else n_chunks
        label_bytes = 4 * chunk * n * (n_cols + 1)
        return (float(mat2_passes) * 4.0 * n * n
                + float(n_chunks) * label_bytes)
    from repro_torch.kernels.permanova_sw import ops as _swops
    total = 0.0
    for lo in range(0, n_total, chunk):
        p = min(chunk, n_total - lo)
        total += _swops.launch_bytes(kernel, n, p, n_groups) + 4.0 * p * n
    return total


def _sw_span_attrs(impl: str, n: int, n_total: int, chunk: int,
                   n_cols: int = 0, *, backend: str = "cpu",
                   n_groups: Optional[int] = None):
    """Span attrs for the s_W stage (None while tracing is off, so the
    disabled path allocates nothing)."""
    if not _obs.trace_enabled():
        return None
    return {"impl": impl, "chunk": chunk,
            "predicted_bytes": _sw_traffic_bytes(
                impl, n, n_total, chunk, n_cols, backend=backend,
                n_groups=n_groups)}


def run(dm, grouping, *, n_perms: int = 999, seed: int = 0,
        perms: Optional[torch.Tensor] = None,
        index_perms: Optional[torch.Tensor] = None,
        n_groups: Optional[int] = None, impl: str = "auto",
        sw_fn: Optional[Callable] = None,
        memory_budget_bytes: Optional[float] = None,
        chunk: Optional[int] = None, squared: bool = False,
        s_t: Optional[float] = None,
        covariates=None, strata=None, weights=None,
        autotune: bool = False, device="cuda") -> PermanovaResult:
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
    impl:   'auto' (planner; a persisted autotune winner for this device
            kind, n bucket and groups where one exists) or a registry name
            (pallas_* aliases too).
    autotune: with impl='auto', measure every registered impl on a sample
            of the actual permutations and run the fastest
            (planner.autotune; the winner persists for later plans). On
            the card every candidate is a hand kernel.
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

    def plan() -> _Planned:
        if (covariates is not None or strata is not None
                or weights is not None):
            if isinstance(grouping, design_mod.Design):
                raise ValueError("pass covariates/strata/weights either to "
                                 "run() or inside the Design, not both")
            design = design_mod.build(
                grouping=grouping, covariates=covariates, strata=strata,
                weights=weights, n_groups=n_groups, device=dev)
        else:
            design = design_mod.Design.from_labels(
                grouping, n_groups=n_groups, device=dev).to(dev)
        if not design.is_plain_labels:
            if sw_fn is not None:
                raise ValueError("sw_fn is not supported with strata/"
                                 "covariate/weighted designs; use a "
                                 "registry impl")
            return _plan_design(dm, design, n_perms=n_perms, seed=seed,
                                perms=perms, index_perms=index_perms,
                                impl=impl,
                                memory_budget_bytes=memory_budget_bytes,
                                chunk=chunk, squared=squared, s_t=s_t,
                                autotune=autotune, dev=dev)
        return _plan_labels(dm, design, n_perms=n_perms, seed=seed,
                            perms=perms, index_perms=index_perms, impl=impl,
                            sw_fn=sw_fn,
                            memory_budget_bytes=memory_budget_bytes,
                            chunk=chunk, squared=squared, s_t=s_t,
                            autotune=autotune, dev=dev)
    return _traced_run(seed, plan)


class _Planned(NamedTuple):
    """A call planned: what its spans record, and the rest of the call
    (the sweep and the result) as finish() -> (result, chunks)."""
    impl: str
    reason: str
    n: int
    n_total: int
    finish: Callable


def _traced_run(seed: int, plan: Callable[[], _Planned]) -> PermanovaResult:
    """A call from outside: one `engine.run` span around plan() (inside an
    `engine.plan` span: every host step before the sweep) and the planned
    finish(). Their attrs are dicts only while tracing, read at exit."""
    run_attrs = {"seed": seed} if _obs.trace_enabled() else None
    plan_attrs = None if run_attrs is None else {}
    with _obs.span("engine.run", run_attrs):
        with _obs.span("engine.plan", plan_attrs):
            planned = plan()
            if plan_attrs is not None:
                plan_attrs.update(impl=planned.impl, reason=planned.reason)
        result, chunks = planned.finish()
        if run_attrs is not None:
            run_attrs.update(impl=planned.impl, n=planned.n,
                             n_total=planned.n_total, chunks=chunks)
    return result


def _plan_labels(dm, design, *, n_perms, seed, perms, index_perms, impl,
                 sw_fn, memory_budget_bytes, chunk, squared, s_t, autotune,
                 dev) -> _Planned:
    """run()'s plain single-factor path up to the sweep: the matrix
    squared, the group sizes, the plan and its impl."""
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
    tuned = sw_fn is None and _autotuned(autotune, impl)
    if tuned:
        pinned = planner.autotune(mat2, grouping, inv_gs, seed=seed)
    pl = planner.plan(n, n_total, backend=dev.type, impl=pinned,
                      memory_budget_bytes=memory_budget_bytes, chunk=chunk,
                      n_groups=n_groups)
    if tuned:
        pl = dataclasses.replace(pl, reason=_TUNED)
    if sw_fn is None:
        fn = registry.get(pl.impl).bound(**pl.tuning)
    else:
        fn = sw_fn
        pl = dataclasses.replace(pl, impl="<custom sw_fn>", kernel=None,
                                 reason="caller-supplied sw_fn")

    def finish():
        s_w_all, stats = _sweep(pl, mat2, grouping, inv_gs, n_total, fn,
                                n_groups, seed=seed, perms=perms,
                                index_perms=index_perms,
                                draw_budget=memory_budget_bytes)
        s_tot = s_total(mat2) if s_t is None else torch.tensor(
            s_t, dtype=torch.float32, device=dev)
        f_all = f_from_sw(s_w_all, s_tot, n, n_groups)
        return PermanovaResult(
            f_stat=f_all[0],
            p_value=p_value_from_null(f_all),
            s_t=s_tot,
            s_w=s_w_all[0],
            f_perms=f_all,
            n_objects=n,
            n_groups=n_groups,
            n_perms=n_perms,
            method=f"permanova[{pl.impl}]",
            plan=f"{pl.describe()} chunks={stats.n_chunks}",
        ), stats.n_chunks
    return _Planned(pl.impl, pl.reason, n, n_total, finish)


_TUNED = "empirical autotune winner (measured on operands)"


def _autotuned(autotune: bool, impl: str) -> bool:
    """Whether a run measures its impl: autotune=True with impl='auto'
    (a pinned impl wins, with a warning, as in the reference; the warning
    names the caller of run() or run_design(), five frames up)."""
    if autotune and impl != "auto":
        warnings.warn(
            f"autotune=True ignored: impl is pinned to {impl!r} (use "
            "impl='auto' to let measurements pick)", stacklevel=6)
    return autotune and impl == "auto"


def _sweep(pl, mat2, grouping, inv_gs, n_total, fn, n_groups, *,
           span: bool = True, **labels):
    """The label sweep of a plan: streamed in chunks or in one batch,
    inside an `engine.sw` span while tracing, then the card's peak memory
    (obs); span=False for a study of a batch, inside the batch's span."""
    if not span:
        return _run_sweep(pl, mat2, grouping, inv_gs, n_total, fn, **labels)
    ch = pl.chunk if pl.streaming else n_total
    with _obs.span("engine.sw", _sw_span_attrs(
            pl.impl, int(mat2.shape[0]), n_total, ch,
            backend=mat2.device.type, n_groups=n_groups)):
        out = _run_sweep(pl, mat2, grouping, inv_gs, n_total, fn, **labels)
    _obs.record_device_memory()
    return out


def _run_sweep(pl, mat2, grouping, inv_gs, n_total, fn, **labels):
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
               s_t: Optional[float] = None, autotune: bool = False,
               device="cuda") -> PermanovaResult:
    """Full PERMANOVA for a non-plain design (strata / covariates /
    weights / several factors) on a resident (squared) distance matrix.

    Labels-mode designs (one factor with strata) run the same registry
    impls as run(), kernels included, on strata-restricted labels. Dense
    designs run the per-column contraction of the permuted basis (a
    registry impl's `cols` companion), with the chunk sized for K columns.
    perms (explicit labels) applies to labels-mode designs only;
    index_perms (explicit index permutations) to both. autotune applies
    to labels-mode designs (as in run()); a dense design warns and plans
    as without it, as the reference does.
    """
    dev = hw.resolve_device(device)
    return _traced_run(seed, lambda: _plan_design(
        dm, design, n_perms=n_perms, seed=seed, perms=perms,
        index_perms=index_perms, impl=impl,
        memory_budget_bytes=memory_budget_bytes, chunk=chunk,
        squared=squared, s_t=s_t, autotune=autotune, dev=dev))


def _plan_design(dm, design, *, n_perms, seed, perms, index_perms, impl,
                 memory_budget_bytes, chunk, squared, s_t, autotune,
                 dev) -> _Planned:
    """run_design() up to the sweep: the design and the matrix on the
    device, the plan and its impl (a labels-mode design's, or the dense
    design's per-column companion)."""
    design = design.to(dev)
    dm = torch.as_tensor(dm).to(dev, torch.float32)
    n = dm.shape[0]
    if design.n != n:
        raise ValueError(f"design is for n={design.n}, matrix is {n}x{n}")
    mat2 = dm if squared else dm * dm
    n_total = n_perms + 1
    pinned = None if impl == "auto" else impl

    def total():
        return s_total(mat2) if s_t is None else torch.tensor(
            s_t, dtype=torch.float32, device=dev)

    if design.mode == design_mod.MODE_LABELS:
        grouping, n_groups = design.grouping, design.n_groups
        inv_gs = permutations.inv_group_sizes(grouping, n_groups)
        tuned = _autotuned(autotune, impl)
        if tuned:
            pinned = planner.autotune(mat2, grouping, inv_gs, seed=seed)
        pl = planner.plan(n, n_total, backend=dev.type, impl=pinned,
                          memory_budget_bytes=memory_budget_bytes,
                          chunk=chunk, n_groups=n_groups)
        if tuned:
            pl = dataclasses.replace(pl, reason=_TUNED)
        fn = registry.get(pl.impl).bound(**pl.tuning)

        def finish_labels():
            s_w_all, stats = _sweep(pl, mat2, grouping, inv_gs, n_total, fn,
                                    n_groups, seed=seed, perms=perms,
                                    strata=design.strata,
                                    index_perms=index_perms,
                                    draw_budget=memory_budget_bytes)
            return label_design_result(
                s_w_all, total(), design, n_objects=n, n_perms=n_perms,
                method=f"permanova[{pl.impl}+strata]",
                plan=f"{pl.describe()} chunks={stats.n_chunks} strata"
            ), stats.n_chunks
        return _Planned(pl.impl, pl.reason, n, n_total, finish_labels)

    if perms is not None:
        raise ValueError("perms= (explicit labels) applies to labels-mode "
                         "designs; a dense design takes index_perms=")
    if autotune:     # named at the caller of run() / run_design()
        warnings.warn(
            "autotune=True ignored for dense designs: the contraction is "
            "the per-column companion on every device", stacklevel=5)
    k = design.k_cols
    pl = planner.plan(n, n_total, backend=dev.type, impl=pinned,
                      memory_budget_bytes=memory_budget_bytes, chunk=chunk,
                      n_cols=k)
    cols_fn = registry.bound_cols(pl.impl, **pl.tuning)
    strata = (design.strata if design.strata is not None
              else torch.zeros((n,), dtype=torch.int32, device=dev))

    def finish_dense():
        with _obs.span("engine.sw", _sw_span_attrs(
                pl.impl, n, n_total, pl.chunk, n_cols=k,
                backend=dev.type)):
            s_cols, stats = scheduler.sw_cols_streaming(
                mat2, design.basis, strata, n_total, cols_fn,
                chunk=pl.chunk, seed=seed, index_perms=index_perms,
                draw_budget=memory_budget_bytes)
        _obs.record_device_memory()
        return design_result(
            s_cols, design, n_objects=n, n_perms=n_perms,
            method=f"permanova-design[{pl.impl}]",
            plan=f"{pl.describe()} chunks={stats.n_chunks} cols={k}"
        ), stats.n_chunks
    return _Planned(pl.impl, pl.reason, n, n_total, finish_dense)


# ---------------------------------------------------------------------------
# Many-study runs: a batch of studies, stacked or ragged.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PermanovaManyResult:
    """Stacked results over S studies (leading axis S on every tensor):
    the result of engine.permanova_many and pipeline.pipeline_many."""
    f_stat: torch.Tensor      # (S,)
    p_value: torch.Tensor     # (S,)
    s_t: torch.Tensor         # (S,)
    s_w: torch.Tensor         # (S,)
    f_perms: torch.Tensor     # (S, n_perms + 1)
    n_objects: int            # common study size n (ragged: n_pad or the
                              # largest study)
    n_groups: int
    n_perms: int
    plan: str = ""
    n_valid: Optional[torch.Tensor] = None   # (S,) sample counts of a
                                             # ragged batch
    terms: Optional[tuple] = None   # design path: TermResults with
                                    # (S,)-leading tensors
    ordination: object = None       # pipeline.ordination.PCoAResult with
                                    # a leading study axis (ordination=k)

    @property
    def r2(self) -> torch.Tensor:
        """(S,) effect sizes R^2 = 1 - s_W / s_T."""
        return 1.0 - self.s_w / self.s_t

    def __len__(self):
        return int(self.f_stat.shape[0])

    def study(self, s: int) -> PermanovaResult:
        """Study s as a single-study PermanovaResult."""
        n_obj = (self.n_objects if self.n_valid is None
                 else int(self.n_valid[s]))
        terms_s = None
        if self.terms is not None:
            terms_s = tuple(dataclasses.replace(
                t, ss=t.ss[s], f_stat=t.f_stat[s], p_value=t.p_value[s],
                r2=t.r2[s], f_perms=t.f_perms[s]) for t in self.terms)
        return PermanovaResult(
            f_stat=self.f_stat[s], p_value=self.p_value[s],
            s_t=self.s_t[s], s_w=self.s_w[s], f_perms=self.f_perms[s],
            n_objects=n_obj, n_groups=self.n_groups, n_perms=self.n_perms,
            method="permanova_many", plan=self.plan, terms=terms_s,
            ordination=(None if self.ordination is None
                        else self.ordination.study(s)))


def _ragged_studies(dms, groupings, n_pad=None, device="cpu"):
    """Check a ragged study list and move its labels to `device`. Nothing
    is padded: each study keeps its own (n_s, n_s) matrix and (n_s,)
    int32 labels and runs on them alone, so a study's statistic is its
    unpadded run's by construction (the reference pads to one stack
    because its vmap needs one shape). The matrices stay where they are
    given; a study's goes to the device when it runs (_study_matrix). n
    is `n_pad` (a fixed bucket width, at least the largest study) or the
    largest n_s: the batch's recorded width and the width of explicit
    per-study draws. Returns (dms, groupings, n_valid (S,) int32, n)."""
    if len(dms) != len(groupings):
        raise ValueError(f"ragged input: {len(dms)} matrices vs "
                         f"{len(groupings)} groupings")
    dev = hw.resolve_device(device)
    dms = [torch.as_tensor(d) for d in dms]
    groupings = [torch.as_tensor(g).to(dev, torch.int32) for g in groupings]
    for i, (d, g) in enumerate(zip(dms, groupings)):
        m = int(d.shape[0])
        if tuple(d.shape) != (m, m) or tuple(g.shape) != (m,):
            raise ValueError(f"study {i}: expected a square matrix and its "
                             f"labels, got {tuple(d.shape)} and "
                             f"{tuple(g.shape)}")
    sizes = [int(d.shape[0]) for d in dms]
    n = max(sizes)
    if n_pad is not None:
        if int(n_pad) < n:
            raise ValueError(f"n_pad={n_pad} is smaller than the largest "
                             f"study (n={n})")
        n = int(n_pad)
    return (dms, groupings, torch.tensor(sizes, dtype=torch.int32,
                                         device=dev), n)


def _study_matrix(dms, s: int, dev) -> torch.Tensor:
    """Study s's (n_s, n_s) f32 matrix on `dev`, moved when the study
    runs: a rank holds the matrices of its own studies only, one at a
    time."""
    return dms[s].to(dev, torch.float32)


def _study_draws(perms, s: int, n_valid: int):
    """Study s's explicit (n_total, n) draws cut to its first n_valid
    columns (a ragged study's valid prefix), or None."""
    return None if perms is None else perms[s][:, :n_valid].contiguous()


def _study_budgets(backend: str, memory_budget_bytes, s_count: int):
    """The label budget each study's plan gets: on 'cuda' the whole budget,
    since the studies run one after another; on 'cpu' the reference's
    1/S (its vmap holds every study live), so the plans match its own."""
    if backend == "cuda":
        return memory_budget_bytes
    total = (planner.DEFAULT_STREAM_BUDGET_BYTES
             if memory_budget_bytes is None else memory_budget_bytes)
    return total / s_count


def _many_plan(backend: str, n: int, n_valid: int, n_total: int, *, impl,
               budget, chunk, n_cols=None, n_groups=None, plans=()):
    """A study's plan: on 'cuda' at its own n_valid, as its single-study
    run plans; on 'cpu' at the batch's n, the reference's one plan, made
    once (the batch's first, `plans[0]`). A labels plan takes n_groups,
    so it reads a persisted autotune winner as run() does."""
    if backend != "cuda" and plans:
        return plans[0]
    return planner.plan(n_valid if backend == "cuda" else n, n_total,
                        backend=backend,
                        impl=None if impl == "auto" else impl,
                        memory_budget_bytes=budget, chunk=chunk,
                        n_cols=n_cols, n_groups=n_groups)


def _many_plan_string(plans, s_count: int, ragged: bool, n_total: int,
                      where: str = "in turn") -> str:
    """The batch's plan record: each distinct study plan once, the chunks
    per study, where the studies ran."""
    seen = list(dict.fromkeys(p.describe() for p in plans))
    chunks = [-(-n_total // p.chunk) for p in plans]
    counts = list(dict.fromkeys(chunks))
    per = (str(counts[0]) if len(counts) == 1
           else ",".join(str(c) for c in chunks))
    return (f"{' / '.join(seen)} studies={s_count}"
            f"{' ragged' if ragged else ''} chunks={per} [{where}]")


def study_axis_padding(mesh, s_count: int):
    """(data_ways, s_pad, wrap_idx) for sharding a study axis over 'data'.

    Study counts that do not divide the axis are wrap-padded (any S works,
    even S < data_ways); callers slice results back to S. Shared by
    permanova_many and pipeline_many, so the two keep one contract."""
    from repro_torch.launch import mesh as _mesh   # deferred: a leaf
    data_ways = _mesh.axis_size(mesh, "data") if mesh is not None else 0
    if data_ways <= 1:
        return data_ways, 0, None
    s_pad = (-s_count) % data_ways
    idx = torch.arange(s_count + s_pad) % s_count if s_pad else None
    return data_ways, s_pad, idx


class StudyBlock(NamedTuple):
    """The studies a rank runs (put_study_sharded)."""
    studies: list       # global study indices, a padded slot's its source
    where: str          # where the batch runs, for the plan record
    n_own: int          # the block's studies that are not padding


def put_study_sharded(mesh, s_count: int,
                      rank: Optional[int] = None) -> StudyBlock:
    """The studies this rank (or world rank `rank`) runs, and where the
    batch runs for the plan record. The (wrap-padded) study axis is split
    into data_ways contiguous blocks and a rank takes the block at its
    'data' index (the port's counterpart of the reference's device_put
    over 'data': a rank moves only its block's matrices to its device;
    ranks that differ only in other axes run the same block). A padded
    slot replays its source study. Without a 'data' axis to shard: every
    study, 'in turn'."""
    data_ways, s_pad, idx = study_axis_padding(mesh, s_count)
    if data_ways <= 1:
        return StudyBlock(list(range(s_count)), "in turn", s_count)
    from repro_torch.core import distributed as _distrib
    lay = _distrib.layout(mesh)
    slots = (idx.tolist() if idx is not None else list(range(s_count)))
    per = len(slots) // data_ways
    d = lay.data_index[lay.rank if rank is None else rank]
    lo, hi = d * per, (d + 1) * per
    return StudyBlock(
        slots[lo:hi],
        f"studies@data[{data_ways}]" + (f"+pad{s_pad}" if s_pad else ""),
        max(0, min(hi, s_count) - lo))


def _many_device(mesh, device) -> torch.device:
    """A batch's device: the mesh's for this rank, else `device`."""
    if mesh is None:
        return hw.resolve_device(device)
    from repro_torch.launch import mesh as _mesh
    return _mesh.mesh_device(mesh)


def _many_tensors(res) -> dict:
    """Every study-leading tensor of a PermanovaManyResult, by name."""
    out = {k: getattr(res, k)
           for k in ("f_stat", "p_value", "s_t", "s_w", "f_perms")}
    for i, t in enumerate(res.terms or ()):
        for k in ("ss", "f_stat", "p_value", "r2", "f_perms"):
            out[f"terms.{i}.{k}"] = getattr(t, k)
    ordn = res.ordination
    if ordn is not None:
        for k in ("coords", "eigvals", "explained"):
            out[f"ordination.{k}"] = getattr(ordn, k)
        if isinstance(ordn.iterations, tuple):
            out["ordination.iterations"] = torch.tensor(
                ordn.iterations, device=res.f_stat.device)
    return out


def gather_studies(mesh, res, s_count: int, plan: str):
    """The whole batch from each rank's block (put_study_sharded): every
    study-leading tensor all-gathered, the blocks taken in 'data' order
    and cut back to the S studies (a padded slot's copy is dropped).
    Without a 'data' axis every rank ran every study: res as it is."""
    if study_axis_padding(mesh, s_count)[0] <= 1:
        return dataclasses.replace(res, plan=plan)
    from repro_torch.core import distributed as _distrib
    lay = _distrib.layout(mesh)
    full = {}
    for k, t in _many_tensors(res).items():
        parts = _distrib.all_gather(t, lay)
        full[k] = torch.cat([parts[lay.first_rank(data=d)]
                             for d in range(lay.data_ways)])[:s_count]
    terms = ordn = None
    if res.terms is not None:
        terms = tuple(dataclasses.replace(
            t, **{k: full[f"terms.{i}.{k}"] for k in (
                "ss", "f_stat", "p_value", "r2", "f_perms")})
            for i, t in enumerate(res.terms))
    if res.ordination is not None:
        its = res.ordination.iterations
        if "ordination.iterations" in full:
            its = tuple(int(v) for v in full["ordination.iterations"])
        ordn = dataclasses.replace(
            res.ordination, coords=full["ordination.coords"],
            eigvals=full["ordination.eigvals"],
            explained=full["ordination.explained"], iterations=its)
    return dataclasses.replace(
        res, **{k: full[k] for k in ("f_stat", "p_value", "s_t", "s_w",
                                     "f_perms")},
        terms=terms, ordination=ordn, plan=plan)


def _check_study_perms(perms, s_count, n_total, n, name):
    if perms is not None and tuple(perms.shape) != (s_count, n_total, n):
        raise ValueError(f"{name} must be (S, n_perms + 1, n) = "
                         f"{(s_count, n_total, n)}, got "
                         f"{tuple(perms.shape)}")


def _stacked(dms, groupings, dev):
    """Check a stacked batch and move its labels to `dev`; the matrices
    stay where they are given (_study_matrix moves each as it runs)."""
    dms = torch.as_tensor(dms)
    groupings = torch.as_tensor(groupings).to(dev, torch.int32)
    if dms.dim() != 3 or groupings.dim() != 2 \
            or tuple(dms.shape[:2]) != tuple(groupings.shape) \
            or dms.shape[1] != dms.shape[2]:
        raise ValueError(f"stacked studies must be (S, n, n) and (S, n); "
                         f"got {tuple(dms.shape)} and "
                         f"{tuple(groupings.shape)}")
    return dms, groupings


def permanova_many(dms, groupings, *, n_groups: int, n_perms: int = 999,
                   seed: int = 0, perms: Optional[torch.Tensor] = None,
                   index_perms: Optional[torch.Tensor] = None,
                   impl: str = "auto", chunk: Optional[int] = None,
                   memory_budget_bytes: Optional[float] = None, mesh=None,
                   covariates=None, strata=None, weights=None,
                   ordination: Optional[int] = None,
                   n_pad: Optional[int] = None,
                   device="cuda") -> PermanovaManyResult:
    """PERMANOVA over a batch of studies.

    dms:        (S, n, n) distance matrices, or a RAGGED list of (n_s, n_s)
                matrices (each study runs on its own matrix, unpadded;
                the n_s are recorded in `n_valid`).
    groupings:  (S, n) labels in [0, n_groups) (a list for ragged input).
    n_pad:      the reference's bucket width for ragged input (at least
                the largest study): recorded as `n_objects` and the width
                of explicit per-study draws, of which each study reads
                its first n_s columns. Nothing is padded.
    seed:       study s draws as a single-study run with
                seed=core.permutations.study_seed(seed, s), on every path:
                stacked study s equals engine.run(dms[s], groupings[s],
                seed=study_seed(seed, s)) bit for bit (at the same plan),
                and so does a ragged study.
    perms / index_perms: explicit (S, n_perms + 1, n) int32 labels, or a
                design's index permutations, per study (the reference's
                draws, for parity tests).
    covariates / strata / weights: per-study design columns, stacked (S,
                n, c) / (S, n) or ragged lists; any of them routes the
                batch through the dense-design path (every study compiles
                to one design structure; per-term statistics in `.terms`).
    ordination: k: each study's top-k PCoA axes (pipeline.ordination.
                pcoa_many: the implicit centered operator on the study's
                own matrix) in `result.ordination`, stacked (S, n, k),
                a ragged study's rows past its n_s exactly zero.
    mesh:       a DeviceMesh (launch.mesh) with a 'data' axis shards the
                STUDY axis: every rank passes the same batch, runs its
                block of studies (put_study_sharded; S wrap-padded to a
                multiple of 'data') on the mesh's device, and returns the
                whole batch, all-gathered: each study's bits are its
                serial run's. The plan ends [studies@data[k](+padN)].
    device:     'cuda' (default; raises without a card) or 'cpu'.

    The studies run one after another on the existing kernels (brute and
    its kin on each study's resident matrix). A 'cuda' plan gives each
    study the whole label budget and plans it at its own n_valid; a 'cpu'
    plan keeps the reference's: one plan at n with 1/S of the budget.
    """
    dev = _many_device(mesh, device)
    if covariates is not None or strata is not None or weights is not None:
        if perms is not None:
            raise ValueError("perms= (explicit labels) applies to the labels "
                             "path; a design batch takes index_perms=")
        return _permanova_many_design(
            dms, groupings, covariates=covariates, strata=strata,
            weights=weights, n_groups=n_groups, n_perms=n_perms, seed=seed,
            index_perms=index_perms, impl=impl, chunk=chunk,
            memory_budget_bytes=memory_budget_bytes, n_pad=n_pad,
            ordination=ordination, dev=dev, mesh=mesh)
    if index_perms is not None:
        raise ValueError("index_perms= applies to design batches; the "
                         "labels path takes perms=")
    ragged = isinstance(dms, (list, tuple))
    if ragged:
        dms, groupings, n_valid, n = _ragged_studies(dms, groupings, n_pad,
                                                     dev)
    else:
        dms, groupings = _stacked(dms, groupings, dev)
        n_valid, n = None, int(groupings.shape[1])
    s_count = len(dms)
    n_total = n_perms + 1
    _check_study_perms(perms, s_count, n_total, n, "perms")
    budget = _study_budgets(dev.type, memory_budget_bytes, s_count)
    block = put_study_sharded(mesh, s_count)
    plans = []
    for s in range(s_count):        # every study's plan, on every rank
        plans.append(_many_plan(dev.type, n, int(groupings[s].shape[0]),
                                n_total, impl=impl, budget=budget,
                                chunk=chunk, n_groups=n_groups, plans=plans))
    f_rows, s_ts, s_ws, p_vals = [], [], [], []
    attrs = _studies_attrs(len(block.studies), block.where)
    with _obs.span("engine.studies", attrs):
        for s in block.studies:
            nv = int(groupings[s].shape[0])
            pl = plans[s]
            fn = registry.get(pl.impl).bound(**pl.tuning)
            d = _study_matrix(dms, s, dev)
            mat2 = d * d
            del d
            inv_gs = permutations.inv_group_sizes(groupings[s], n_groups)
            s_w_all, stats = _sweep(
                pl, mat2, groupings[s], inv_gs, n_total, fn, n_groups,
                span=False, seed=permutations.study_seed(seed, s),
                perms=_study_draws(perms, s, nv), draw_budget=budget)
            s_t = s_total(mat2)
            f_all = f_from_sw(s_w_all, s_t, nv, n_groups)
            f_rows.append(f_all)
            s_ts.append(s_t)
            s_ws.append(s_w_all[0])
            p_vals.append(p_value_from_null(f_all))
            del mat2    # freed before the next study's matrix moves
        for s in block.studies:
            _add_study_traffic(attrs, plans[s], n if dev.type == "cpu"
                               else int(groupings[s].shape[0]), n_total,
                               dev.type, n_groups)
        _obs.maybe_block(f_rows)
    _count_studies(block.n_own)
    f_perms = torch.stack(f_rows)
    local = PermanovaManyResult(
        f_stat=f_perms[:, 0], p_value=torch.stack(p_vals),
        s_t=torch.stack(s_ts), s_w=torch.stack(s_ws), f_perms=f_perms,
        n_objects=n, n_groups=n_groups, n_perms=n_perms, n_valid=n_valid,
        ordination=_many_ordination(dms, block.studies, ordination, n, dev))
    return gather_studies(mesh, local, s_count, _many_plan_string(
        plans, s_count, ragged, n_total, block.where))


def _studies_attrs(s_count: int, where: str = "in turn"):
    """The `engine.studies` span's attrs, filled study by study
    (_add_study_traffic): s_count is the studies this rank runs (under a
    mesh its block, a padded slot's replay included, since its traffic
    is the rank's). None while tracing is off."""
    if not _obs.trace_enabled():
        return None
    return {"studies": s_count, "where": where, "predicted_bytes": 0.0}


def _add_study_traffic(attrs, pl, n: int, n_total: int, backend: str,
                       n_groups: int, n_cols: int = 0) -> None:
    """Add one study's sweep to the batch span's attrs: its impl and its
    traffic (_sw_traffic_bytes at the chunk of its plan, at the width it
    was planned at: the batch's n on 'cpu', as the reference's one plan,
    its own n_valid on 'cuda')."""
    if attrs is None:
        return
    attrs["impl"] = pl.impl
    attrs["predicted_bytes"] += _sw_traffic_bytes(
        pl.impl, n, n_total, pl.chunk, n_cols, backend=backend,
        n_groups=n_groups)


def _count_studies(s_count: int) -> None:
    """A finished batch: `engine.studies` (the rank's studies that are
    not padding, so the ranks of one 'data' column sum to S) and the
    card's peak memory."""
    _obs.metrics.inc("engine.studies", s_count)
    _obs.record_device_memory()


def _many_ordination(dms, studies, ordination, n: int, dev):
    """The PCoA (pipeline.ordination.pcoa_many) at width n of each study
    in `studies`, their matrices moved to `dev`, or None without
    ordination=."""
    if ordination is None:
        return None
    from repro_torch.pipeline import ordination as _ord   # deferred: cycle
    return _ord.pcoa_many([_study_matrix(dms, s, dev) for s in studies],
                          int(ordination), n_pad=n)


def design_many_result(s_cols, designs, *, n_objects: int, n_groups: int,
                       n_perms: int, n_valid=None, plan: str = "",
                       ordination=None) -> PermanovaManyResult:
    """Many-study result assembly from stacked (S, n_total, K) per-column
    sweeps and each study's design (one term structure; each study's
    residual dof its own), term by term as design_result assembles one
    study (shared by permanova_many and pipeline_many)."""
    per = [design_result(s_cols[s], d, n_objects=d.n, n_perms=n_perms,
                         method="", plan="")
           for s, d in enumerate(designs)]
    terms = tuple(dataclasses.replace(
        t, ss=torch.stack([r.terms[i].ss for r in per]),
        f_stat=torch.stack([r.terms[i].f_stat for r in per]),
        p_value=torch.stack([r.terms[i].p_value for r in per]),
        r2=torch.stack([r.terms[i].r2 for r in per]),
        f_perms=torch.stack([r.terms[i].f_perms for r in per]))
        for i, t in enumerate(per[0].terms))
    last = terms[-1]
    return PermanovaManyResult(
        f_stat=last.f_stat, p_value=last.p_value,
        s_t=torch.stack([r.s_t for r in per]),
        s_w=torch.stack([r.s_w for r in per]), f_perms=last.f_perms,
        n_objects=n_objects, n_groups=n_groups, n_perms=n_perms,
        n_valid=n_valid, terms=terms, plan=plan, ordination=ordination)


def _build_study_designs(groupings, covariates, strata, weights, *,
                         n_groups: int, s_count: int, sizes, device):
    """Each study's dense design on its own n_s rows (force_dense, as the
    reference's batch: strata-only studies too), checked for one shared
    term structure, or ValueError."""
    def pick(what, x, s, m):
        if x is None:
            return None
        arr = x[s]
        arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        if arr.shape[0] != m:
            raise ValueError(
                f"study {s}: {what} has {arr.shape[0]} rows, expected {m} "
                "(per-study design columns must be UNPADDED, aligned with "
                "that study's samples)")
        return arr

    designs = []
    for s in range(s_count):
        m = int(sizes[s])
        cov = pick("covariates", covariates, s, m)
        designs.append(design_mod.build(
            grouping=pick("groupings", groupings, s, m),
            covariates=None if cov is None else cov.astype(np.float64),
            strata=pick("strata", strata, s, m),
            weights=(None if weights is None
                     else pick("weights", weights, s, m).astype(np.float64)),
            n_groups=n_groups, force_dense=True, device=device))
    spans = [tuple((t.name, t.kind, t.df, t.lo, t.hi) for t in d.terms)
             for d in designs]
    if any(sp != spans[0] for sp in spans[1:]):
        raise ValueError(
            "the studies compiled to different design structures (per-study "
            "term ranks differ, e.g. a covariate collinear in one study "
            f"only); run such studies one at a time: {sorted(set(spans))}")
    return designs


def _permanova_many_design(dms, groupings, *, covariates, strata, weights,
                           n_groups: int, n_perms: int, seed: int,
                           index_perms, impl: str, chunk,
                           memory_budget_bytes, n_pad, ordination, dev,
                           mesh=None) -> PermanovaManyResult:
    """The many-study dense-design path: every study's design (strata-only
    ones too) as one dense structure, each study's per-column sweep run
    in turn on its own operands from study_seed(seed, s), then per-term F
    and p per study."""
    ragged = isinstance(dms, (list, tuple))
    if ragged:
        dms, _, n_valid, n = _ragged_studies(dms, groupings, n_pad, dev)
    else:
        dms = torch.as_tensor(dms)
        n_valid, n = None, int(dms.shape[1])
    s_count = len(dms)
    designs = _build_study_designs(
        groupings, covariates, strata, weights, n_groups=n_groups,
        s_count=s_count, sizes=[int(d.shape[0]) for d in dms], device=dev)
    k = designs[0].k_cols
    n_total = n_perms + 1
    _check_study_perms(index_perms, s_count, n_total, n, "index_perms")
    budget = _study_budgets(dev.type, memory_budget_bytes, s_count)
    block = put_study_sharded(mesh, s_count)
    plans = []
    for d in designs:               # every study's plan, on every rank
        plans.append(_many_plan(dev.type, n, d.n, n_total, impl=impl,
                                budget=budget, chunk=chunk, n_cols=k,
                                plans=plans))
    s_cols = []
    attrs = _studies_attrs(len(block.studies), block.where)
    with _obs.span("engine.studies", attrs):
        for s in block.studies:
            d = designs[s]
            nv = d.n
            st = (d.strata if d.strata is not None
                  else torch.zeros((nv,), dtype=torch.int32, device=dev))
            pl = plans[s]
            cols_fn = registry.bound_cols(pl.impl, **pl.tuning)
            m = _study_matrix(dms, s, dev)
            mat2 = m * m
            del m
            sc, stats = scheduler.sw_cols_streaming(
                mat2, d.basis, st, n_total, cols_fn,
                chunk=pl.chunk, seed=permutations.study_seed(seed, s),
                index_perms=_study_draws(index_perms, s, nv),
                draw_budget=budget)
            s_cols.append(sc)
            del mat2    # freed before the next study's matrix moves
        for s in block.studies:
            _add_study_traffic(attrs, plans[s], n if dev.type == "cpu"
                               else designs[s].n, n_total, dev.type,
                               n_groups, n_cols=k)
        _obs.maybe_block(s_cols)
    _count_studies(block.n_own)
    local = design_many_result(
        torch.stack(s_cols), [designs[s] for s in block.studies],
        n_objects=n, n_groups=n_groups, n_perms=n_perms, n_valid=n_valid,
        ordination=_many_ordination(dms, block.studies, ordination, n, dev))
    return gather_studies(mesh, local, s_count, (
        f"{_many_plan_string(plans, s_count, ragged, n_total, block.where)} "
        f"cols={k} ({designs[0].describe()})"))
