"""PCoA ordination — the consumer of the pipeline's Gower marginals.

Twin of `repro/pipeline/ordination.py`. Principal Coordinates Analysis
(classical MDS) embeds the samples of a distance matrix in k dimensions:
eigendecompose the Gower-centered matrix G = -1/2 J (D*D) J (J the
centering projector) and scale the top eigenvectors by sqrt(eigenvalue).
PERMANOVA and PCoA share their expensive inputs, mat2 = D*D and its Gower
marginals (row sums, grand sum), so ordination rides the pipeline's
dataflow:

  pcoa_eigh       dense eigendecomposition of G, built outright: for the
                  dense bridge, where an extra (n, n) transient is within
                  budget.
  pcoa_subspace   subspace (block-power) iteration against the IMPLICIT
                  centered operator: G @ V from mat2 @ V plus rank-1
                  corrections from the marginals, so G never exists (the
                  stream bridge: mat2 stays its one (n, n) array).
  pcoa_features   the same iteration with mat2 @ V itself streamed: every
                  matvec rebuilds the (row_block, n) squared-distance
                  slabs from the feature table (the fused bridges: on the
                  card through the distance kernel's slab route; nothing
                  (n, n) is held).
  pcoa_many       pcoa_subspace per study of a batch, each on its own
                  matrix, stacked; a ragged study's rows past its n_s
                  come out exactly zero.

G is indefinite for semi-metrics (Bray-Curtis, Jaccard), and plain power
iteration converges to the largest |lambda|, possibly a negative one. The
subspace paths therefore estimate the spectral radius rho by a short
power iteration and iterate on G + 1.05 rho I (every eigenvalue > 0,
order kept), then take the eigenvalues by Rayleigh-Ritz against G itself.
The loop stops once the shifted Rayleigh quotients stagnate (one host
sync an iteration for that test); `PCoAResult.iterations` records how
many it took. The start block and the probe come from an explicit
torch.Generator(seed) on the CPU, so a seed gives the same draws on every
device; `v0=` (n, p) and `probe=` (n, 1) take explicit ones (the parity
tests feed the reference's jax.random draws). torch.linalg.eigh / qr and
the mat2 @ V products are library calls in f32 (TF32 off), as the
reference computes them outside any Pallas kernel.

Conventions (every path): eigenvalues descending; coords[:, i] = v_i *
sqrt(max(lambda_i, 0)); explained[i] = lambda_i / trace(G), and trace(G)
== s_T, the PERMANOVA total sum of squares.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch.pipeline.streaming import (GowerStats, gower_center,
                                            mat2_row_blocks)

DEFAULT_ITERS = 96
DEFAULT_OVERSAMPLE = 8
RADIUS_ITERS = 16


@dataclasses.dataclass
class PCoAResult:
    """Top-k principal coordinates. Tensors may carry a leading study axis
    (the stacked permanova_many / pipeline_many results)."""
    coords: torch.Tensor       # (..., n, k) sample coordinates
    eigvals: torch.Tensor      # (..., k) descending eigenvalues of G
    explained: torch.Tensor    # (..., k) eigval / trace(G) == eigval / s_T
    method: str                # 'eigh' | 'subspace' | 'subspace-stream'
    iterations: Union[int, tuple, None] = None
    # subspace iterations taken (a tuple, one a study, when stacked);
    # None for eigh

    @property
    def k(self) -> int:
        return int(self.coords.shape[-1])

    def study(self, s: int) -> "PCoAResult":
        """View one study of a stacked result."""
        its = self.iterations
        return PCoAResult(coords=self.coords[s], eigvals=self.eigvals[s],
                          explained=self.explained[s], method=self.method,
                          iterations=its[s] if isinstance(its, tuple)
                          else its)


# ---------------------------------------------------------------------------
# Implicit centered operator: G @ V from mat2 @ V + Gower marginals.
# ---------------------------------------------------------------------------

def centered_matvec(matvec: Callable[[torch.Tensor], torch.Tensor],
                    row_sums: torch.Tensor, total, n: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap V -> mat2 @ V into V -> G @ V without materializing G:

      G @ V = -1/2 (M @ V - (r/n) colsum(V) - 1 (r^T V)/n
                    + (t/n^2) 1 colsum(V))

    with r, t the Gower marginals (row sums, grand sum) of mat2 M."""
    r = row_sums.to(torch.float32)
    t = torch.as_tensor(total, dtype=torch.float32, device=r.device)

    def gv(v: torch.Tensor) -> torch.Tensor:
        cs = v.sum(dim=0)                              # (k,) column sums
        rv = r @ v                                     # (k,)
        return -0.5 * (matvec(v) - r[:, None] * (cs[None, :] / n)
                       - rv[None, :] / n + (t / (n * n)) * cs[None, :])

    return gv


def _spectral_radius(gv: Callable, probe: torch.Tensor,
                     iters: int = RADIUS_ITERS) -> torch.Tensor:
    """Power-iteration estimate of ||G||_2 (the largest |eigenvalue|)
    from the (n, 1) probe; no host sync."""
    v = probe / probe.norm().clamp(min=1e-30)
    rho = torch.zeros((), dtype=torch.float32, device=probe.device)
    for _ in range(iters):
        w = gv(v)
        rho = w.norm()
        v = w / rho.clamp(min=1e-30)
    return rho


def start_block(n: int, p: int, seed: int = 0):
    """The port's own (v0 (n, p), probe (n, 1)) f32 draws from
    torch.Generator(seed) on the CPU: the same on every device."""
    gen = torch.Generator().manual_seed(int(seed))
    v0 = torch.randn((n, p), generator=gen, dtype=torch.float32)
    probe = torch.randn((n, 1), generator=gen, dtype=torch.float32)
    return v0, probe


def subspace_eigs(gv: Callable[[torch.Tensor], torch.Tensor], n: int,
                  k: int, *, iters: int = DEFAULT_ITERS,
                  oversample: int = DEFAULT_OVERSAMPLE, seed: int = 0,
                  v0: Optional[torch.Tensor] = None,
                  probe: Optional[torch.Tensor] = None,
                  tol: float = 1e-8, device=None):
    """Top-k (eigenvalues desc, eigenvectors (n, k), iterations taken) of
    the implicit symmetric operator `gv`, by shifted orthogonal iteration
    from a (n, p = min(n, k + oversample)) start block.

    Stops once the shifted Rayleigh quotients change by at most tol of
    their largest magnitude (one host sync an iteration), or after
    `iters`. v0 / probe: explicit (n, p) start block and (n, 1) radius
    probe; by default start_block(n, p, seed)."""
    p = int(min(n, k + oversample))
    if v0 is None or probe is None:
        d_v0, d_probe = start_block(n, p, seed)
        v0 = d_v0 if v0 is None else v0
        probe = d_probe if probe is None else probe
    if tuple(v0.shape) != (n, p) or tuple(probe.shape) != (n, 1):
        raise ValueError(f"v0 must be (n, p) = {(n, p)} and probe (n, 1), "
                         f"got {tuple(v0.shape)} and {tuple(probe.shape)}")
    v0 = torch.as_tensor(v0).to(device, torch.float32)
    probe = torch.as_tensor(probe).to(device, torch.float32)
    rho = _spectral_radius(gv, probe)
    shift = rho * 1.05 + 1e-12      # strictly dominate any negative tail

    def gv_shifted(v):
        return gv(v) + shift * v

    v, _ = torch.linalg.qr(gv_shifted(v0))
    rq_prev = torch.full((v.shape[1],), float("inf"), dtype=torch.float32,
                         device=v.device)
    taken = 0
    while taken < iters:
        w = gv_shifted(v)
        rq = (v * w).sum(dim=0)            # shifted Rayleigh quotients
        v, _ = torch.linalg.qr(w)
        scale = rq.abs().max().clamp(min=1e-30)
        done = (rq - rq_prev).abs().max() <= tol * scale
        rq_prev = rq
        taken += 1
        if bool(done):
            break
    # Rayleigh-Ritz against the UNSHIFTED operator: the eigenvalues come
    # out directly, with no shift (and no rho error) in them
    b = v.T @ gv(v)
    b = 0.5 * (b + b.T)
    evals, evecs = torch.linalg.eigh(b)                # ascending
    order = torch.argsort(-evals)[:k]
    return evals[order], v @ evecs[:, order], taken


def _coords_from_eigs(evals: torch.Tensor, evecs: torch.Tensor, s_t,
                      method: str, iterations=None) -> PCoAResult:
    coords = evecs * evals.clamp(min=0.0).sqrt()[None, :]
    return PCoAResult(coords=coords, eigvals=evals, explained=evals / s_t,
                      method=method, iterations=iterations)


# ---------------------------------------------------------------------------
# Execution paths.
# ---------------------------------------------------------------------------

def pcoa_eigh(mat2: torch.Tensor, k: int, *,
              stats: Optional[GowerStats] = None) -> PCoAResult:
    """Dense path: materialize G and eigendecompose it outright (one extra
    (n, n) transient, the dense bridge's; also the oracle the subspace
    paths are tested against)."""
    mat2 = mat2.to(torch.float32)
    n = int(mat2.shape[0])
    g = gower_center(mat2, stats)
    s_t = torch.trace(g)                               # == s_T exactly
    evals, evecs = torch.linalg.eigh(g)                # ascending
    del g
    order = torch.argsort(-evals)[:int(min(k, n))]
    return _coords_from_eigs(evals[order], evecs[:, order], s_t, "eigh")


def _marginals(mat2: torch.Tensor, stats: Optional[GowerStats]):
    """(row sums, grand sum) in f32: the streamed ones, or mat2's own."""
    if stats is None:
        rs = mat2.sum(dim=1)
        return rs, rs.sum()
    return stats.row_sums.to(mat2.device, torch.float32), float(stats.total)


def pcoa_subspace(mat2: torch.Tensor, k: int, *,
                  stats: Optional[GowerStats] = None,
                  iters: int = DEFAULT_ITERS,
                  oversample: int = DEFAULT_OVERSAMPLE, seed: int = 0,
                  v0: Optional[torch.Tensor] = None,
                  probe: Optional[torch.Tensor] = None) -> PCoAResult:
    """Implicit path on a RESIDENT mat2: G is never materialized (the
    stream bridge keeps its one (n, n) array)."""
    mat2 = mat2.to(torch.float32)
    n = int(mat2.shape[0])
    rs, total = _marginals(mat2, stats)
    gv = centered_matvec(lambda v: mat2 @ v, rs, total, n)
    evals, evecs, taken = subspace_eigs(
        gv, n, int(min(k, n)), iters=iters, oversample=oversample,
        seed=seed, v0=v0, probe=probe, device=mat2.device)
    return _coords_from_eigs(evals, evecs, total / 2.0 / n, "subspace",
                             taken)


def _streamed_matvec(xprep: torch.Tensor, rows_fn: Callable, block: int):
    """V -> mat2 @ V with mat2's (block, n) row slabs rebuilt from the
    features on every call (pipeline.streaming.mat2_row_blocks): one slab
    live at a time."""
    n = int(xprep.shape[0])

    def mv(v: torch.Tensor) -> torch.Tensor:
        out = torch.empty((n, v.shape[1]), dtype=torch.float32,
                          device=v.device)
        for lo, slab in mat2_row_blocks(xprep, rows_fn, block=block):
            out[lo:lo + slab.shape[0]] = slab @ v
        return out

    return mv


def pcoa_features(xprep: torch.Tensor, rows_fn: Callable, k: int, *,
                  row_block: int, stats: Optional[GowerStats] = None,
                  iters: int = DEFAULT_ITERS,
                  oversample: int = DEFAULT_OVERSAMPLE, seed: int = 0,
                  v0: Optional[torch.Tensor] = None,
                  probe: Optional[torch.Tensor] = None) -> PCoAResult:
    """Fully streamed path for the fused bridges: every matvec rebuilds
    the squared-distance row slabs from the prepared feature table (on
    the card through the distance kernel), so the peak residency is one
    (row_block, n) slab, never an (n, n) array. Without `stats` the
    Gower marginals come from one more slab sweep first (the fused
    bridges keep only s_T)."""
    n = int(xprep.shape[0])
    block = int(min(row_block, n))
    mv = _streamed_matvec(xprep, rows_fn, block)
    if stats is None:
        rs = torch.empty((n,), dtype=torch.float32, device=xprep.device)
        for lo, slab in mat2_row_blocks(xprep, rows_fn, block=block):
            rs[lo:lo + slab.shape[0]] = slab.sum(dim=1)
        total = rs.sum()
    else:
        rs = stats.row_sums.to(xprep.device, torch.float32)
        total = float(stats.total)
    gv = centered_matvec(mv, rs, total, n)
    evals, evecs, taken = subspace_eigs(
        gv, n, int(min(k, n)), iters=iters, oversample=oversample,
        seed=seed, v0=v0, probe=probe, device=xprep.device)
    return _coords_from_eigs(evals, evecs, total / 2.0 / n,
                             "subspace-stream", taken)


def pcoa_many(dms: Union[torch.Tensor, Sequence[torch.Tensor]], k: int, *,
              n_pad: Optional[int] = None, iters: int = DEFAULT_ITERS,
              oversample: int = DEFAULT_OVERSAMPLE, seed: int = 0,
              v0: Optional[torch.Tensor] = None,
              probe: Optional[torch.Tensor] = None) -> PCoAResult:
    """Per-study PCoA of an (S, n, n) distance stack or a ragged list of
    (n_s, n_s) matrices, stacked to (S, n, k) at width n (n_pad, or the
    largest study). Each study runs pcoa_subspace's iteration on its own
    matrix at its own n_s, from the first n_s rows of one (n, p) start
    block and (n, 1) probe shared by the batch (start_block(n, p, seed),
    or v0 / probe), as the reference's masked batch does; a ragged
    study's rows past n_s are exactly zero."""
    studies = list(dms)
    sizes = [int(d.shape[0]) for d in studies]
    n = max(sizes) if n_pad is None else int(n_pad)
    k = int(min(k, n))
    if k > min(sizes):
        raise ValueError(f"ordination k={k} exceeds the smallest study "
                         f"(n={min(sizes)})")
    p = int(min(n, k + oversample))
    d_v0, d_probe = start_block(n, p, seed)
    v0 = d_v0 if v0 is None else v0
    probe = d_probe if probe is None else probe
    dev = studies[0].device
    coords = torch.zeros((len(studies), n, k), dtype=torch.float32,
                         device=dev)
    evals_all, s_ts, taken = [], [], []
    for s, dm in enumerate(studies):
        m = sizes[s]
        mat2 = dm.to(torch.float32) * dm.to(torch.float32)
        rs, total = _marginals(mat2, None)
        gv = centered_matvec(lambda v, mat2=mat2: mat2 @ v, rs, total, m)
        evals, evecs, its = subspace_eigs(
            gv, m, k, iters=iters, oversample=oversample,
            v0=v0[:m, :min(m, p)], probe=probe[:m], device=dev)
        coords[s, :m] = evecs * evals.clamp(min=0.0).sqrt()[None, :]
        evals_all.append(evals)
        s_ts.append(total / 2.0 / m)
        taken.append(its)
    evals = torch.stack(evals_all)
    return PCoAResult(coords=coords, eigvals=evals,
                      explained=evals / torch.stack(s_ts)[:, None],
                      method="subspace", iterations=tuple(taken))
