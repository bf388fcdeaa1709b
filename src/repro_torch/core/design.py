"""Design-matrix subsystem: the one-hot label path generalized.

Twin of `repro/core/design.py`. The one-hot factor E of the matmul form
(E[i, g] = sqrt(1/n_g) 1[g_i == g]) is one orthonormal basis Q of a
model's column space; for ANY model whose hat matrix is H = Q Q'
(intercept included) the residual sum of squares of Anderson's
partitioning is a contraction against the squared distance matrix
(McArdle & Anderson 2001):

    SS_resid(H) = 1/2 <mat2, H> = 1/2 sum_k q_k' mat2 q_k

Sequential (adonis2-style) terms: X = [1 | X_term1 | X_term2 ...], each
term block orthonormalized against everything before it (fp64 SVD per
block, rank-revealing), so per-term partial SS telescope per COLUMN:

    SS explained by term t = -1/2 sum_{k in term t} q_k' mat2 q_k
    F_t[p] = (SS_t[p] / df_t) / (SS_resid_full[p] / dof_resid)

with permutation p acting by row-permuting Q (vegan's "permute the
observations"). Sample weights fold in as W^(1/2) in the basis.

Two modes:

  'labels'  single categorical factor, no weights: the operands are the
            labels and inv_group_sizes, so every label impl and kernel
            consumes them unchanged; without strata this IS the plain
            label path (`is_plain_labels`).
  'dense'   anything else (covariates, several factors, weights): the
            operand is the (n, K) orthonormal basis plus per-term column
            spans; permutations gather basis rows and the contraction is
            per column (fstat.sw_cols_*, the fused_sw_cols kernel).

The fp64 host arithmetic is numpy, copied from the reference line for
line, so `basis64` is the reference's on the same host; `basis`,
`grouping` and `strata` are torch tensors on the caller's device.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import hw

MODE_LABELS = "labels"
MODE_DENSE = "dense"

# Rank tolerance for the fp64 per-term orthogonalization: singular values
# below RANK_TOL * s_max * sqrt(n) are treated as collinear with earlier
# terms and dropped (their df is absorbed by the terms before them).
RANK_TOL = 1e-10


def _numpy(a, dtype=None) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array-like."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a, dtype)


def _int32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


@dataclasses.dataclass(frozen=True)
class Term:
    """One model term: a contiguous span of orthonormal basis columns.

    df is the RANK INCREMENT the term contributes beyond everything before
    it (a g-level factor after the intercept has df g-1; a covariate
    collinear with earlier terms has df 0). lo/hi index the dense basis
    columns; in labels mode they are 0/0."""
    name: str
    kind: str          # 'intercept' | 'factor' | 'covariate'
    df: int
    lo: int = 0
    hi: int = 0


class DesignOperands(NamedTuple):
    """What the s_W implementations consume: labels mode the (n,) int32
    labels and (G,) f32 inverse group sizes; dense mode the (n, K) f32
    basis and each term's column span."""
    mode: str
    grouping: Optional[torch.Tensor]
    inv_group_sizes: Optional[torch.Tensor]
    n_groups: Optional[int]
    basis: Optional[torch.Tensor]
    term_cols: Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class Design:
    """A compiled PERMANOVA design: terms, permutation scheme, operands."""
    n: int
    mode: str                       # MODE_LABELS | MODE_DENSE
    terms: Tuple[Term, ...]         # term 0 is always the intercept
    dof_resid: int
    # labels mode (dense mode keeps the last factor's labels here too)
    grouping: Optional[torch.Tensor] = None
    n_groups: Optional[int] = None
    # dense mode: basis64 is the fp64 master (tests, oracles); basis the
    # f32 operand with any W^(1/2) factor folded in
    basis: Optional[torch.Tensor] = None
    basis64: Optional[np.ndarray] = None
    # shared
    strata: Optional[torch.Tensor] = None   # (n,) int32, None = free
    weights: Optional[np.ndarray] = None

    @property
    def rank(self) -> int:
        """Total model rank, intercept included (== dense basis width)."""
        return sum(t.df for t in self.terms)

    @property
    def k_cols(self) -> int:
        return 0 if self.basis is None else int(self.basis.shape[1])

    @property
    def is_plain_labels(self) -> bool:
        """True when this design IS the plain label path: one categorical
        factor, free permutations."""
        return self.mode == MODE_LABELS and self.strata is None

    @property
    def operands(self) -> DesignOperands:
        if self.mode == MODE_LABELS:
            from repro_torch.core import permutations
            return DesignOperands(
                mode=MODE_LABELS, grouping=self.grouping,
                inv_group_sizes=permutations.inv_group_sizes(
                    self.grouping, self.n_groups),
                n_groups=self.n_groups, basis=None, term_cols=())
        return DesignOperands(
            mode=MODE_DENSE, grouping=None, inv_group_sizes=None,
            n_groups=self.n_groups, basis=self.basis,
            term_cols=tuple((t.lo, t.hi) for t in self.terms))

    def describe(self) -> str:
        ts = "+".join(f"{t.name}({t.df})" for t in self.terms[1:])
        extra = []
        if self.strata is not None:
            extra.append("strata")
        if self.weights is not None:
            extra.append("weighted")
        tail = f" [{','.join(extra)}]" if extra else ""
        return f"design[{self.mode}] ~ {ts or '1'}{tail}"

    def to(self, device) -> "Design":
        """This design with its tensors on `device`."""
        def mv(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(self, grouping=mv(self.grouping),
                                   basis=mv(self.basis),
                                   strata=mv(self.strata))

    # -- constructors -----------------------------------------------------

    @staticmethod
    def from_labels(grouping, *, n_groups: Optional[int] = None,
                    strata=None, weights=None, name: str = "grouping",
                    device="cuda") -> "Design":
        """A single categorical factor. Without weights this compiles to
        labels mode (the operands are the labels themselves); weights
        force dense mode (the one-hot factor is no longer orthonormal
        under W). device: 'cuda' (default; raises without a card) or
        'cpu'."""
        if isinstance(grouping, Design):
            return grouping
        device = hw.resolve_device(device)
        grouping = _int32(grouping, device)
        n = int(grouping.shape[0])
        if n_groups is None:
            n_groups = int(grouping.max()) + 1
        if weights is not None:
            return build(grouping=grouping, n_groups=n_groups,
                         strata=strata, weights=weights, factor_name=name,
                         device=device)
        strata_t = None if strata is None else _int32(strata, device)
        terms = (Term("intercept", "intercept", 1),
                 Term(name, "factor", n_groups - 1))
        return Design(n=n, mode=MODE_LABELS, terms=terms,
                      dof_resid=n - n_groups, grouping=grouping,
                      n_groups=n_groups, strata=strata_t)


# ---------------------------------------------------------------------------
# Dense-basis construction (fp64 host arithmetic).
# ---------------------------------------------------------------------------

def _orth_block(q_prev: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Orthonormal basis of cols' component orthogonal to span(q_prev):
    two projection passes (classical Gram-Schmidt re-orthogonalization)
    then a rank-revealing SVD; fp64 throughout."""
    x = np.asarray(cols, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    for _ in range(2):
        if q_prev.shape[1]:
            x = x - q_prev @ (q_prev.T @ x)
    u, s, _ = np.linalg.svd(x, full_matrices=False)
    if s.size == 0:
        return u[:, :0]
    thresh = RANK_TOL * max(1.0, float(s[0])) * np.sqrt(x.shape[0])
    r = int(np.sum(s > thresh))
    return u[:, :r]


def _one_hot_np(labels: np.ndarray, n_groups: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], n_groups), np.float64)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def _normalize_covariates(covariates, n: int) -> List[Tuple[str, np.ndarray]]:
    """Accepts a dict name->(n,), a list of (name, values), or a plain
    (n,)/(n, c) array (auto-named cov0..)."""
    if covariates is None:
        return []
    if isinstance(covariates, dict):
        items = list(covariates.items())
    elif isinstance(covariates, (list, tuple)) and covariates and \
            isinstance(covariates[0], (list, tuple)) and \
            len(covariates[0]) == 2 and isinstance(covariates[0][0], str):
        items = list(covariates)
    else:
        arr = _numpy(covariates, np.float64)
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2 or arr.shape[0] != n:
            raise ValueError(f"covariates must be (n, c) with n={n}; "
                             f"got shape {arr.shape}")
        items = [(f"cov{j}", arr[:, j]) for j in range(arr.shape[1])]
    out = []
    for name, v in items:
        v = _numpy(v, np.float64).reshape(-1)
        if v.shape[0] != n:
            raise ValueError(f"covariate {name!r} has {v.shape[0]} values, "
                             f"expected {n}")
        out.append((str(name), v))
    return out


def _normalize_factors(factors, grouping, n_groups, factor_name):
    """Ordered (name, labels int64 (n,), n_levels) triples."""
    items = []
    if factors is not None:
        it = factors.items() if isinstance(factors, dict) else factors
        for name, labels in it:
            items.append((str(name), _numpy(labels, np.int64)))
    if grouping is not None:
        items.append((str(factor_name), _numpy(grouping, np.int64)))
    out = []
    for name, labels in items:
        levels = int(labels.max()) + 1 if labels.size else 0
        out.append((name, labels, levels))
    if grouping is not None and n_groups is not None:
        name, labels, _ = out[-1]
        out[-1] = (name, labels, int(n_groups))
    return out


def build(*, grouping=None, covariates=None, factors=None, strata=None,
          weights=None, n_groups: Optional[int] = None,
          n: Optional[int] = None, factor_name: str = "grouping",
          force_dense: bool = False, device="cuda") -> Design:
    """Compile a PERMANOVA design.

    Model term order is adonis2-sequential: covariates first, extra
    factors next, the primary `grouping` factor LAST, so its partial F is
    adjusted for every covariate. A single factor with no covariates or
    weights compiles to labels mode unless force_dense=True. The tensors
    of the result (labels, basis, strata) live on `device`: 'cuda'
    (default; raises without a card) or 'cpu'.
    """
    device = hw.resolve_device(device)
    covs = _normalize_covariates(covariates, _infer_n(grouping, covariates,
                                                      n))
    n = _infer_n(grouping, covariates, n)
    facs = _normalize_factors(factors, grouping, n_groups, factor_name)
    if not facs and not covs:
        raise ValueError("design needs at least one factor or covariate")
    single_factor = (len(facs) == 1 and not covs and weights is None
                     and not force_dense)
    if single_factor:
        return Design.from_labels(facs[0][1].astype(np.int32),
                                  n_groups=facs[0][2], strata=strata,
                                  name=facs[0][0], device=device)

    w = None
    if weights is not None:
        w = _numpy(weights, np.float64).reshape(-1)
        if w.shape[0] != n:
            raise ValueError(f"weights must be (n,); got {w.shape}")
        if np.any(w < 0) or not np.any(w > 0):
            raise ValueError("weights must be non-negative with at least "
                             "one positive entry")
    sw = np.sqrt(w) if w is not None else np.ones((n,), np.float64)

    # intercept first, then covariates, then factors (grouping last)
    blocks: List[Tuple[str, str, np.ndarray]] = [
        ("intercept", "intercept", np.ones((n, 1), np.float64))]
    for name, v in covs:
        blocks.append((name, "covariate", v[:, None]))
    for name, labels, levels in facs:
        blocks.append((name, "factor", _one_hot_np(labels, levels)))

    q = np.zeros((n, 0), np.float64)
    terms: List[Term] = []
    for name, kind, cols in blocks:
        qb = _orth_block(q, sw[:, None] * cols)
        lo = q.shape[1]
        q = np.concatenate([q, qb], axis=1)
        terms.append(Term(name, kind, qb.shape[1], lo, q.shape[1]))
    if terms[0].df != 1:  # pragma: no cover - sw has a positive entry
        raise ValueError("degenerate design: empty intercept")
    k = q.shape[1]
    dof_resid = n - k
    if dof_resid <= 0:
        raise ValueError(f"design is saturated: rank {k} >= n={n} leaves "
                         "no residual degrees of freedom")
    basis64 = sw[:, None] * q          # W^(1/2) folded into the operand
    strata_t = None if strata is None else _int32(strata, device)
    ngrp = facs[-1][2] if facs else None
    grp = _int32(facs[-1][1], device) if facs else None
    return Design(n=n, mode=MODE_DENSE, terms=tuple(terms),
                  dof_resid=dof_resid, grouping=grp, n_groups=ngrp,
                  basis=torch.from_numpy(basis64.astype(np.float32)).to(
                      device),
                  basis64=basis64, strata=strata_t, weights=w)


def _infer_n(grouping, covariates, n):
    if n is not None:
        return int(n)
    if grouping is not None:
        return int(grouping.shape[0] if isinstance(grouping, torch.Tensor)
                   else np.asarray(grouping).shape[0])
    if covariates is None:
        raise ValueError("cannot infer n: pass grouping, covariates, or n=")
    if isinstance(covariates, dict):
        return int(_numpy(next(iter(covariates.values()))).shape[0])
    if isinstance(covariates, (list, tuple)) and covariates and \
            isinstance(covariates[0], (list, tuple)):
        return int(_numpy(covariates[0][1]).shape[0])
    return int(_numpy(covariates).shape[0])


def pad_design(design: Design, n_pad: int) -> Design:
    """Zero-pad a dense design to n_pad rows (ragged multi-study batching).

    Pad rows get EXACTLY-ZERO basis rows, so against a zero-padded mat2
    every padded contraction term contributes +0.0; dof bookkeeping keeps
    the true n. (Its callers, the multi-study runs, come with a later
    slice of the port.)"""
    if design.mode != MODE_DENSE:
        raise ValueError("pad_design applies to dense-mode designs")
    if n_pad < design.n:
        raise ValueError(f"n_pad={n_pad} < design.n={design.n}")
    pad = n_pad - design.n
    if pad == 0:
        return design
    basis64 = np.pad(design.basis64, ((0, pad), (0, 0)))
    dev = design.basis.device

    def pad_int(t):
        return None if t is None else torch.nn.functional.pad(t, (0, pad))
    return dataclasses.replace(
        design, basis=torch.from_numpy(basis64.astype(np.float32)).to(dev),
        basis64=basis64, strata=pad_int(design.strata),
        grouping=pad_int(design.grouping))


# ---------------------------------------------------------------------------
# Per-term statistic assembly from the per-column contraction output.
# ---------------------------------------------------------------------------

class TermStats(NamedTuple):
    """Per-term statistics over the permutation sweep (leading axes free:
    (..., P))."""
    ss_resid: torch.Tensor     # (..., P) full-model residual SS
    s_t: torch.Tensor          # (...,)   observed total SS (intercept)
    ss_terms: torch.Tensor     # (..., P, T) explained SS per term
    f_terms: torch.Tensor      # (..., P, T) pseudo-F per term


def term_stats(s_cols: torch.Tensor, design: Design,
               dof_resid=None) -> TermStats:
    """Assemble per-term F from the per-column quadratic forms.

    s_cols: (..., P, K) output of the sw_cols contraction, column order =
            design.basis columns (intercept at [lo, hi) of term 0).
    dof_resid: scalar or (...,) residual dof; defaults to
            design.dof_resid.
    """
    s_cols = torch.as_tensor(s_cols)
    icpt = design.terms[0]
    ss_resid = s_cols.sum(dim=-1)
    s_t = s_cols[..., 0, icpt.lo:icpt.hi].sum(dim=-1)
    if dof_resid is None:
        dof_resid = design.dof_resid
    dof_resid = torch.as_tensor(dof_resid, dtype=s_cols.dtype,
                                device=s_cols.device)
    denom = ss_resid / dof_resid[..., None]
    ss_list, f_list = [], []
    for t in design.terms[1:]:
        ss_t = -s_cols[..., t.lo:t.hi].sum(dim=-1)
        # df 0 (a collinear term): F is defined as 0
        f_t = (ss_t / t.df) / denom if t.df > 0 else torch.zeros_like(ss_t)
        ss_list.append(ss_t)
        f_list.append(f_t)
    return TermStats(ss_resid=ss_resid, s_t=s_t,
                     ss_terms=torch.stack(ss_list, dim=-1),
                     f_terms=torch.stack(f_list, dim=-1))


def observed_scols_fp64(mat2, design: Design) -> np.ndarray:
    """fp64 reference of the observed per-column contraction (tests)."""
    b = design.basis64
    return 0.5 * np.einsum("ik,ij,jk->k", b, _numpy(mat2, np.float64), b)
