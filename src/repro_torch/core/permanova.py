"""Full PERMANOVA test (Anderson 2001) around the s_W statistic.

Twin of `repro/core/permanova.py`:

  s_T    = sum_{i<j} d_ij^2 / N                       (constant per matrix)
  s_W[p] = sum_{i<j, same perm-group} d_ij^2 / n_g     (the paper's kernel)
  s_A[p] = s_T - s_W[p]
  F[p]   = (s_A[p] / (a - 1)) / (s_W[p] / (N - a))
  p-val  = (#{F[p] >= F[0], p >= 1} + 1) / (n_perms + 1)

with N objects, a groups, permutation 0 = observed labels. permanova()
takes a distance matrix or a feature table (through pipeline), and a
design (covariates, strata, weights; core.design), whose per-term
statistics land in `PermanovaResult.terms`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class TermResult:
    """Per-term statistics of a multi-term (design) PERMANOVA: one entry
    per non-intercept term, in sequential (adonis2) order, each term's SS
    adjusted for everything before it."""
    name: str
    kind: str                  # 'factor' | 'covariate'
    df: int
    ss: torch.Tensor           # observed explained SS (sequential)
    f_stat: torch.Tensor       # observed partial pseudo-F
    p_value: torch.Tensor
    r2: torch.Tensor           # ss / s_T (variance explained by the term)
    f_perms: torch.Tensor      # (n_perms + 1,) null incl. observed at 0

    def __repr__(self):  # pragma: no cover - cosmetic
        return (f"TermResult({self.name}: df={self.df}, "
                f"F={float(self.f_stat):.6g}, p={float(self.p_value):.6g}, "
                f"R2={float(self.r2):.4g})")


@dataclasses.dataclass
class PermanovaResult:
    f_stat: torch.Tensor       # observed pseudo-F (0-d)
    p_value: torch.Tensor
    s_t: torch.Tensor
    s_w: torch.Tensor          # observed s_W
    f_perms: torch.Tensor      # (n_perms + 1,) null incl. observed at 0
    n_objects: int
    n_groups: int
    n_perms: int
    method: str = "permanova"
    plan: str = ""             # engine execution plan (impl, chunking)
    terms: Optional[tuple] = None  # tuple of TermResult on the design path
                                   # (strata / covariates / weights); the
                                   # headline F and p are the LAST term's;
                                   # None on the plain single-factor path
    ordination: object = None  # pipeline.ordination.PCoAResult when the
                               # caller asked for ordination=k
    ooc_stats: object = None   # pipeline.streaming.OocStats of a sweep
                               # run out of core (slab-cache features)

    @property
    def r2(self) -> torch.Tensor:
        """Effect size R^2 = 1 - s_W / s_T."""
        return 1.0 - self.s_w / self.s_t

    def __repr__(self):  # pragma: no cover - cosmetic
        return (f"PermanovaResult(F={float(self.f_stat):.6g}, "
                f"p={float(self.p_value):.6g}, R2={float(self.r2):.4g}, "
                f"n={self.n_objects}, a={self.n_groups}, "
                f"perms={self.n_perms})")


def s_total(mat2: torch.Tensor) -> torch.Tensor:
    """s_T = sum_{i<j} d^2 / N, from the full sum by symmetry."""
    n = mat2.shape[0]
    return mat2.sum(dtype=torch.float32) / 2.0 / n


def f_from_sw(s_w: torch.Tensor, s_t: torch.Tensor, n_objects: int,
              n_groups: int) -> torch.Tensor:
    """pseudo-F from the partial statistic (broadcasts over perms)."""
    s_a = s_t - s_w
    return (s_a / (n_groups - 1)) / (s_w / (n_objects - n_groups))


def p_value_from_null(f_perms: torch.Tensor) -> torch.Tensor:
    """(#{perm F >= observed F} + 1) / (n_perms + 1); index 0 = observed."""
    n_perms = f_perms.shape[0] - 1
    greater = (f_perms[1:] >= f_perms[0]).sum()
    return (greater + 1.0) / (n_perms + 1.0)


def permanova(dm, grouping=None, *, n_perms: int = 999, seed: int = 0,
              perms: Optional[torch.Tensor] = None,
              index_perms: Optional[torch.Tensor] = None,
              n_groups: Optional[int] = None, sw_impl: str = "auto",
              sw_fn: Optional[Callable] = None,
              memory_budget_bytes: Optional[float] = None,
              chunk: Optional[int] = None, metric: Optional[str] = None,
              covariates=None, strata=None, weights=None,
              autotune: bool = False, device="cuda") -> PermanovaResult:
    """Run the full PERMANOVA test on a distance matrix (thin engine
    wrapper).

    dm:        (n, n) symmetric distance matrix with a zero diagonal, or
               an (n, d) feature table (non-square, or `metric=` given),
               which routes to pipeline.pipeline: distances by `metric`
               (default 'braycurtis'), then the same test.
    grouping:  (n,) int labels in [0, n_groups), or a compiled
               core.design.Design (then covariates / strata / weights
               stay None: the Design carries them).
    covariates: continuous columns to adjust for (dict name -> (n,), list
               of (name, values), or an (n, c) array). Terms are
               sequential (adonis2): covariates first, the grouping
               factor LAST, so the headline F is the adjusted factor's;
               every term's statistics land in `result.terms`.
    strata:    (n,) int blocks: permutations stay WITHIN them (vegan's
               strata=).
    weights:   (n,) non-negative sample weights (weighted PERMANOVA).
    seed / perms / index_perms: the permutation source — the port's
               counter-based generator from `seed`, an explicit
               (n_perms + 1, n) int32 label tensor (labels-mode only), or
               explicit (n_perms + 1, n) int32 index permutations; row 0
               of either is the identity (they take the place of the
               reference's `key=`).
    sw_impl:   'auto' (planner) or a registry name: 'brute' | 'tiled' |
               'matmul' (or their 'pallas_*' aliases).
    autotune:  measure the candidates on the real operands instead of
               trusting the heuristics (engine.planner.autotune).
    device:    'cuda' (default; raises without a card) or 'cpu'.
    """
    from repro_torch import engine   # deferred: engine imports this module
    from repro_torch.core import design as _design
    if isinstance(grouping, _design.Design):
        if covariates is not None or strata is not None \
                or weights is not None:
            raise ValueError("pass covariates/strata/weights either to "
                             "permanova() or inside the Design, not both")
    elif grouping is None and covariates is None:
        raise ValueError("permanova needs grouping labels, covariates, or "
                         "a Design")
    design_kw = dict(covariates=covariates, strata=strata, weights=weights)
    arr = torch.as_tensor(dm)
    if metric is not None or (arr.dim() == 2
                              and arr.shape[0] != arr.shape[1]):
        if sw_fn is not None:
            raise ValueError("sw_fn is not supported on the features path; "
                             "precompute the distance matrix instead")
        from repro_torch import pipeline   # deferred: it imports engine
        return pipeline.pipeline(
            arr, grouping, metric=metric or "braycurtis", n_perms=n_perms,
            seed=seed, perms=perms, index_perms=index_perms,
            n_groups=n_groups, sw_impl=sw_impl,
            memory_budget_bytes=memory_budget_bytes, chunk=chunk,
            autotune=autotune, device=device, **design_kw)
    if arr.dim() != 2:
        raise ValueError(f"permanova takes an (n, n) distance matrix or an "
                         f"(n, d) feature table, got shape "
                         f"{tuple(arr.shape)}")
    if arr.shape[0] >= 2:
        # An (n, n) feature table would silently take this path; a sampled
        # O(n) structural check catches it without an (n, n) transient.
        n = arr.shape[0]
        rows = torch.tensor([0, n // 2, n - 1], device=arr.device)
        diag_err = float(arr[rows, rows].abs().max())
        sym_err = float((arr[rows, :] - arr[:, rows].T).abs().max())
        if diag_err > 1e-5 or sym_err > 1e-4:
            warnings.warn(
                f"square input does not look like a distance matrix "
                f"(sampled diag max {diag_err:.3g}, asymmetry max "
                f"{sym_err:.3g})", stacklevel=2)
    return engine.run(arr, grouping, n_perms=n_perms, seed=seed, perms=perms,
                      index_perms=index_perms, n_groups=n_groups,
                      impl=sw_impl, sw_fn=sw_fn,
                      memory_budget_bytes=memory_budget_bytes, chunk=chunk,
                      autotune=autotune, device=device, **design_kw)
