"""Synthetic microbiome-style abundance tables (numpy).

A copy of the reference's generators (`repro/data/microbiome.py`), so the
two packages draw the same study from the same `seed`: compositional
abundance tables with a planted group effect (effect_size=0 is the exact
null; effect_size >> 0 gives p ~ 1/(n_perms+1)), design columns
(covariates, strata, weights) to go with them, and an EMP-scale sparse
count table written straight into a slab cache (data.slabcache).
"""

from __future__ import annotations

import numpy as np


def synthetic_abundance(n_samples: int, n_features: int, *, seed: int = 0,
                        sparsity: float = 0.7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.gamma(0.7, 1.0, size=(n_samples, n_features))
    mask = rng.random((n_samples, n_features)) < sparsity
    x[mask] = 0.0
    return x.astype(np.float32)


def synthetic_study(n_samples: int, n_features: int, n_groups: int, *,
                    effect_size: float = 0.0, seed: int = 0,
                    sparsity: float = 0.7):
    """(abundance (n, d) f32, grouping (n,) int32) with a planted effect:
    each group's mean abundance is shifted on a random tenth of the
    features; effect_size=0.0 keeps labels independent of the data."""
    rng = np.random.default_rng(seed)
    x = synthetic_abundance(n_samples, n_features, seed=seed + 1,
                            sparsity=sparsity)
    grouping = rng.integers(0, n_groups, size=n_samples).astype(np.int32)
    if effect_size > 0:
        for g in range(n_groups):
            feat = rng.choice(n_features, size=max(n_features // 10, 1),
                              replace=False)
            bump = rng.gamma(effect_size, 1.0,
                             size=(int((grouping == g).sum()), len(feat)))
            x[np.ix_(grouping == g, feat)] += bump.astype(np.float32)
    return x, grouping


def synthetic_sparse_counts(n_samples: int, n_features: int, *,
                            density: float = 0.1, seed: int = 0,
                            cache_dir=None, slab_rows: int = 1024,
                            fmt: str = "dense", n_groups: int = 8):
    """An EMP-scale sparse count table written straight into a slab cache.

    Generates one row slab at a time from np.random.default_rng((seed,
    slab)), so any slab is reproducible on its own, and appends it to a
    SlabCacheWriter: the (n, d) table never exists in memory. fmt='csr'
    stores the presence structure only (jaccard's diet). The table and
    the grouping equal the reference's for the same arguments. Returns
    (SlabCache, grouping (n,) int32)."""
    from repro_torch.data import slabcache as _slabcache
    if cache_dir is None:
        raise ValueError("synthetic_sparse_counts writes a slab cache; "
                         "pass cache_dir=")
    slab_rows = max(1, min(int(slab_rows), n_samples))
    writer = _slabcache.SlabCacheWriter(cache_dir, d=n_features,
                                        slab_rows=slab_rows, fmt=fmt)
    for slab_idx, lo in enumerate(range(0, n_samples, slab_rows)):
        rows = min(slab_rows, n_samples - lo)
        rng = np.random.default_rng((seed, slab_idx))
        x = rng.gamma(0.7, 1.0, size=(rows, n_features)).astype(np.float32)
        x[rng.random((rows, n_features)) >= density] = 0.0
        writer.append(x)
    cache = writer.finalize()
    grng = np.random.default_rng((seed, 0x6772))   # a label stream of its own
    grouping = grng.integers(0, n_groups, size=n_samples).astype(np.int32)
    grouping[:n_groups] = np.arange(n_groups)   # every group non-empty
    return cache, grouping


def synthetic_design(n_samples: int, *, covariate_names=("age", "depth"),
                     n_strata: int = 0, weighted: bool = False,
                     seed: int = 0):
    """Synthetic design columns to pair with `synthetic_study`.

    Returns (covariates dict name -> (n,) f64 | None, strata (n,) int32 |
    None, weights (n,) f64 | None), the operands of the covariate /
    strata / weighted path (core.design). Covariates are standard normals
    (independent of the abundance table); strata are blocks with every
    one non-empty; weights are positive gammas. The same draws as the
    reference's per seed.
    """
    rng = np.random.default_rng(seed + 17)
    covariates = None
    if covariate_names:
        covariates = {str(name): rng.normal(size=n_samples)
                      for name in covariate_names}
    strata = None
    if n_strata and n_strata > 1:
        strata = rng.integers(0, n_strata, size=n_samples).astype(np.int32)
        strata[:n_strata] = np.arange(n_strata)     # every block non-empty
    weights = None
    if weighted:
        weights = rng.gamma(4.0, 0.25, size=n_samples)
    return covariates, strata, weights
