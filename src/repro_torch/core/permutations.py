"""Permutation source for the PERMANOVA permutation test.

Group sizes are invariant under label permutation, so `inv_group_sizes`
is computed once from the observed grouping. Permutation 0 is always the
identity (the observed grouping), which joins the null distribution's
denominator as in scikit-bio.

The reference draws labels with `jax.random` and folds the key by global
permutation index; torch cannot reproduce that stream. The port's source
is counter-based instead: permutation p of sample i gets a 63-bit key
built from two 32-bit integer mixes of (seed, p, i), and a stable argsort
of each key row is the permutation. So

  * the labels are a pure function of (seed, grouping, global index):
    any chunking of [0, n_perms) gives the same rows, on CPU or CUDA;
  * integer arithmetic only, so CPU and CUDA agree bit for bit;
  * two 32-bit mixes keep key ties (which the stable sort would break by
    sample order) negligible at n = 25k, where one 32-bit key would not.

Every value is kept in [0, 2^32) inside int64 tensors: torch's `>>` on
int64 is arithmetic, so each mix masks back to 32 bits, and the 32-bit
multiply is split in 16-bit halves so no int64 product overflows.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_SALTS = (0x9E3779B9, 0x85EBCA6B)


def group_sizes(grouping: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(n_groups,) counts of each label value in the observed grouping."""
    return torch.bincount(grouping.long(), minlength=n_groups)[:n_groups]


def inv_group_sizes(grouping: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(n_groups,) f32 1/n_g, and 0 for an empty group."""
    sizes = group_sizes(grouping, n_groups).to(torch.float32)
    return torch.where(sizes > 0, 1.0 / sizes.clamp(min=1.0),
                       torch.zeros_like(sizes))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xor-shift / multiply, "lowbias32")."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def permutation_keys(seed: int, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(len(idx), n) int64 sort keys in [0, 2^63) for global permutation
    indices `idx` (on the device the keys are wanted on)."""
    dev = idx.device
    seed = int(seed)
    s = torch.tensor([(seed & _M32) ^ ((seed >> 32) & _M32)],
                     dtype=torch.int64, device=dev)
    idx = idx.to(torch.int64) & _M32
    col = torch.arange(n, dtype=torch.int64, device=dev)
    halves = []
    for salt in _SALTS:
        row = _mix32(_mix32(s ^ salt) ^ idx)                  # (P,)
        halves.append(_mix32(row[:, None] ^ _mix32(col ^ salt)[None, :]))
    return ((halves[0] >> 1) << 32) | halves[1]


def permutation_batch(grouping: torch.Tensor, lo: int, hi: int, *,
                      seed: int = 0) -> torch.Tensor:
    """(hi - lo, n) int32 permuted labels for global indices [lo, hi),
    on grouping's device. Index 0 is the identity (the observed labels)."""
    n = grouping.shape[0]
    idx = torch.arange(lo, hi, dtype=torch.int64, device=grouping.device)
    order = torch.argsort(permutation_keys(seed, idx, n), dim=1,
                          stable=True)
    labels = grouping.to(torch.int32)[order]
    if lo == 0 and hi > 0:
        labels[0] = grouping
    return labels


# ---------------------------------------------------------------------------
# Strata-restricted permutations (designs).
#
# Restricted permutation tests (vegan's `strata=`) shuffle samples only
# WITHIN blocks: sites, batches, repeated-measure subjects. These draw from
# the same counter keys as the free generator above, so they too are a
# pure function of (seed, strata, global index): any chunking gives the
# same rows, on CPU or CUDA.
# ---------------------------------------------------------------------------

def strata_permutation_batch(strata: torch.Tensor, lo: int, hi: int, *,
                             seed: int = 0) -> torch.Tensor:
    """(hi - lo, n) int32 INDEX permutations restricted within strata
    blocks, for global indices [lo, hi), on strata's device: perm[i] has
    the stratum of i. Index 0 is the identity.

    The reference's construction: two stable argsorts group positions by
    stratum, once in the random order of the row's keys and once in the
    original order, and matching them up block by block gives a uniform
    within-block bijection. With a constant strata vector the draw is the
    free generator's argsort(keys)."""
    n = strata.shape[0]
    dev = strata.device
    idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    s = strata.to(torch.int64)
    a = torch.argsort(permutation_keys(seed, idx, n), dim=1,
                      stable=True)                    # random position order
    a = torch.gather(a, 1, torch.argsort(s[a], dim=1,
                                         stable=True))  # by stratum
    b = torch.argsort(s, stable=True)                 # by stratum, in order
    perms = torch.empty_like(a)
    perms[:, b] = a
    perms = perms.to(torch.int32)
    if lo == 0 and hi > 0:
        perms[0] = torch.arange(n, dtype=torch.int32, device=dev)
    return perms


def strata_label_batch(grouping: torch.Tensor, strata: torch.Tensor,
                       lo: int, hi: int, *, seed: int = 0) -> torch.Tensor:
    """Permuted LABELS under strata restriction, (hi - lo, n) int32: the
    grouping composed with the index permutations, so every label impl
    and kernel consumes them unchanged."""
    perms = strata_permutation_batch(strata, lo, hi, seed=seed)
    return grouping.to(torch.int32)[perms.long()]


def masked_strata(strata: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Move the pad suffix [n_valid, n) into its own sentinel stratum,
    max(strata) + 1, so padded ragged studies permute pads only among
    themselves. (Its callers, the multi-study runs, come with a later
    slice of the port.)"""
    n = strata.shape[0]
    pos = torch.arange(n, device=strata.device)
    return torch.where(pos < int(n_valid), strata,
                       strata.max() + 1).to(strata.dtype)
