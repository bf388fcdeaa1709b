"""The PERMANOVA test in plain PyTorch, the benchmark's yardstick.

Everything goes through one form (McArdle & Anderson 2001): for an
orthonormal basis Q of a model's column space, each column k gives the
quadratic form c_k = 1/2 q_k' D2 q_k against the squared distances D2,
and a permutation pi acts by gathering basis rows, Q_pi = Q[pi]. Then

  one factor of G levels (q_g = 1[g] / sqrt(n_g)):
      s_W = sum_g c_g,  s_T = sum(D2) / 2n,
      F = ((s_T - s_W) / (G - 1)) / (s_W / (n - G));
  sequential terms (intercept, covariates, the factor last):
      SS_t = -sum_{k in t} c_k,  SS_resid = sum_k c_k,
      F_t = (SS_t / df_t) / (SS_resid / (n - K));

  p = (#{F_p >= F_0, p >= 1} + 1) / (P + 1), permutation 0 observed.

`precision` is 'f64' (the reference) or 'tf32' (the control: float32
with every matrix-product operand rounded to TF32, as the tensor cores
read it). Products run over blocks of permutations so that the working
set stays a few GiB at the EMP shape.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import draws

PRECISIONS = ("f64", "tf32")


class TermNull(NamedTuple):
    """One term's null: F of every permutation (index 0 observed), its p,
    and the term's degrees of freedom and the residual's."""
    name: str
    f: torch.Tensor          # (P,) float64 on the host
    p: float
    df: int
    dof_resid: int


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "f64" else torch.float32


@contextlib.contextmanager
def _tf32(precision: str):
    """Let CUDA products run on the TF32 tensor cores for the control."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    return to_tf32(x) if precision == "tf32" else x.to(torch.float64)


def squared_from_matrix(dm: torch.Tensor, precision: str = "f64"
                        ) -> torch.Tensor:
    """D2 = D * D in the precision's type."""
    d = dm.to(_dtype(precision))
    return d * d


def squared_braycurtis(x: torch.Tensor, precision: str = "f64",
                       block: int = 1024) -> torch.Tensor:
    """D2 of Bray-Curtis, sum|x_i - x_j| / sum(x_i + x_j), from the
    (n, d) table, computed in row blocks in the precision's type."""
    xt = x.to(_dtype(precision))
    n = xt.shape[0]
    r = xt.sum(dim=1)
    out = torch.empty((n, n), dtype=xt.dtype, device=xt.device)
    for a in range(0, n, block):
        b = min(a + block, n)
        num = torch.cdist(xt[a:b], xt, p=1)
        d = num / (r[a:b, None] + r[None, :])
        out[a:b] = d * d
    out.fill_diagonal_(0.0)
    return out


def _col_forms(d2: torch.Tensor, q: torch.Tensor, perms: torch.Tensor,
               precision: str) -> torch.Tensor:
    """(B, K) forms 1/2 q_k' D2 q_k of the basis gathered by each of the
    (B, n) index permutations."""
    b, n = perms.shape
    k = q.shape[1]
    v = q[perms.reshape(-1)].view(b, n, k).permute(1, 0, 2).reshape(n, b * k)
    v = _operand(v, precision)
    m = d2 @ v
    return 0.5 * (m * v).sum(dim=0).view(b, k)


def _forms(d2: torch.Tensor, q: torch.Tensor, n_total: int, *, seed: int,
           strata: Optional[torch.Tensor], precision: str,
           perm_block: int) -> torch.Tensor:
    """(n_total, K) column forms over the permutations drawn from seed."""
    n = d2.shape[0]
    d2 = to_tf32(d2) if precision == "tf32" else d2
    out = []
    with _tf32(precision):
        for lo in range(0, n_total, perm_block):
            hi = min(lo + perm_block, n_total)
            perms = draws.index_perms(seed, lo, hi, n, d2.device, strata)
            out.append(_col_forms(d2, q, perms, precision))
    return torch.cat(out)


def p_value(f: torch.Tensor) -> float:
    return float(((f[1:] >= f[0]).sum() + 1).item()) / f.shape[0]


def factor_basis(grouping: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(n, G) float64 orthonormal basis of a factor: 1[g] / sqrt(n_g)."""
    g = grouping.to(torch.int64)
    sizes = torch.bincount(g, minlength=n_groups).to(torch.float64)
    q = torch.zeros((g.shape[0], n_groups), dtype=torch.float64,
                    device=g.device)
    q[torch.arange(g.shape[0], device=g.device), g] = 1.0
    return q / sizes.clamp(min=1.0).sqrt()


def label_test(d2: torch.Tensor, grouping: torch.Tensor, n_groups: int, *,
               n_perms: int, seed: int, strata: Optional[torch.Tensor] = None,
               precision: str = "f64", perm_block: int = 256
               ) -> List[TermNull]:
    """One factor, permutations free or within strata: the factor's null.

    A permutation of the labels is a permutation of the basis rows, so
    the factor's basis goes through the same gather as a design's."""
    n = d2.shape[0]
    q = factor_basis(grouping, n_groups)
    c = _forms(d2, q, n_perms + 1, seed=seed, strata=strata,
               precision=precision, perm_block=perm_block)
    s_w = c.sum(dim=1)
    s_t = d2.sum() / (2.0 * n)
    f = ((s_t - s_w) / (n_groups - 1)) / (s_w / (n - n_groups))
    f = f.to(torch.float64).cpu()
    return [TermNull("factor", f, p_value(f), n_groups - 1, n - n_groups)]


def _orth_against(prev: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Orthonormal basis of cols' part orthogonal to span(prev)."""
    x = cols
    for _ in range(2):          # a second pass re-orthogonalizes
        x = x - prev @ (prev.T @ x)
    q, _ = np.linalg.qr(x)
    return q


def design_basis(grouping: np.ndarray, n_groups: int,
                 covariates: Sequence[np.ndarray]):
    """(Q (n, K) float64, [(name, lo, hi)]) of the sequential design
    [1 | covariates | the factor]: each block orthonormalized against the
    blocks before it. The factor's G indicator columns lose the one that
    the intercept already spans."""
    n = grouping.shape[0]
    blocks = [("intercept", np.ones((n, 1)))]
    blocks += [(f"cov{i}", np.asarray(c, np.float64).reshape(n, 1))
               for i, c in enumerate(covariates)]
    onehot = np.zeros((n, n_groups))
    onehot[np.arange(n), grouping.astype(np.int64)] = 1.0
    blocks.append(("factor", onehot[:, 1:]))
    q = np.zeros((n, 0))
    spans = []
    for name, cols in blocks:
        qb = _orth_against(q, cols)
        spans.append((name, q.shape[1], q.shape[1] + qb.shape[1]))
        q = np.concatenate([q, qb], axis=1)
    return q, spans


def design_test(d2: torch.Tensor, grouping: torch.Tensor, n_groups: int,
                covariates: Sequence[torch.Tensor], *, n_perms: int,
                seed: int, precision: str = "f64", perm_block: int = 128
                ) -> List[TermNull]:
    """Covariates first, the factor last (sequential terms), free index
    permutations of the observations: each term's null."""
    n = d2.shape[0]
    q, spans = design_basis(grouping.cpu().numpy(), n_groups,
                            [c.double().cpu().numpy() for c in covariates])
    k = q.shape[1]
    qt = torch.from_numpy(q).to(d2.device)
    c = _forms(d2, qt, n_perms + 1, seed=seed, strata=None,
               precision=precision, perm_block=perm_block)
    ss_resid = c.sum(dim=1)
    out = []
    for name, lo, hi in spans[1:]:
        ss = -c[:, lo:hi].sum(dim=1)
        f = ((ss / (hi - lo)) / (ss_resid / (n - k))).to(torch.float64).cpu()
        out.append(TermNull(name, f, p_value(f), hi - lo, n - k))
    return out
