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

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_SALTS = (0x9E3779B9, 0x85EBCA6B)
# The draws' memory: the peak bytes of one sub-block's int64 transients
# per (row, sample), the output not counted, by kind of draw. "labels"
# (permutation_batch): the two hash halves and a _mix32's temporaries,
# the keys, argsort's output and its workspace, the gather. "strata"
# (strata_label_batch): the index draw below, its int32 rows, their
# int64 copy and the gathered labels. "index" (strata_permutation_batch,
# the design sweeps' draw, free or within strata): the keys, two argsorts
# and their workspace, the gather and the scatter. The card's peaks per
# element at n = 25,145 and 1 to 107 rows reach 64.4, 80.4 and 76.4
# (chip_smoke.py phase 4). Beside the bytes, the caching allocator may
# hand each request of more than 1 MiB a cached block up to
# ALLOC_EXCESS_BYTES larger than it asked for, one for each of the
# (bytes / 8) int64 arrays live at the peak. Phase 4 holds each kind
# under this model, and phase 17 the fused-kernel bridge's whole peak.
# The draws go in sub-blocks of rows whose transients fit the budget they
# are given (draw_rows).
DRAW_BYTES_PER_ELEMENT = {"labels": 65, "strata": 84, "index": 80}
ALLOC_EXCESS_BYTES = 1024 ** 2


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


def _draw_arrays(kind: str) -> int:
    """The int64 (row, sample) arrays a draw of this kind holds at its
    peak, rounded up."""
    return -(-DRAW_BYTES_PER_ELEMENT[kind] // 8)


def draw_rows(n: int, budget_bytes: float, kind: str = "labels") -> int:
    """Rows of a draw's sub-block: the most whose transients
    (draw_transient_bytes for this kind of draw) fit the budget, at least
    one. A pure function of (n, budget, kind), so the rows drawn do not
    depend on the device."""
    n = int(n)
    per_row = DRAW_BYTES_PER_ELEMENT[kind] * n
    small = min(int(budget_bytes // per_row),
                ALLOC_EXCESS_BYTES // (8 * n))      # arrays of <= 1 MiB
    large = int((budget_bytes - _draw_arrays(kind) * ALLOC_EXCESS_BYTES)
                // per_row)
    return max(1, small, large)


def draw_transient_bytes(rows: int, n: int, kind: str = "labels") -> int:
    """Modelled peak bytes of the transients of one sub-block of `rows`
    permutations of n samples (the output not counted); kind is
    'labels', 'strata' or 'index' (DRAW_BYTES_PER_ELEMENT, and
    ALLOC_EXCESS_BYTES for each array of more than 1 MiB)."""
    rows, n = int(rows), int(n)
    excess = (_draw_arrays(kind) * ALLOC_EXCESS_BYTES
              if 8 * rows * n > ALLOC_EXCESS_BYTES else 0)
    return DRAW_BYTES_PER_ELEMENT[kind] * rows * n + excess


def _sub_blocks(lo: int, hi: int, n: int, block_rows: Optional[int]):
    """[a, b) sub-blocks of [lo, hi), block_rows global indices each
    (None: the whole range in one)."""
    step = max(hi - lo, 1) if block_rows is None else int(block_rows)
    if step < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    return [(a, min(a + step, hi)) for a in range(lo, hi, step)]


def permutation_batch(grouping: torch.Tensor, lo: int, hi: int, *,
                      seed: int = 0, block_rows: Optional[int] = None
                      ) -> torch.Tensor:
    """(hi - lo, n) int32 permuted labels for global indices [lo, hi),
    on grouping's device. Index 0 is the identity (the observed labels).
    The keys and their argsort are made block_rows rows at a time
    (draw_rows(n, budget) keeps them within a label budget; None: all at
    once); row p depends on (seed, p) alone, so every block size gives
    the same labels."""
    n = grouping.shape[0]
    g32 = grouping.to(torch.int32)
    labels = torch.empty((max(hi - lo, 0), n), dtype=torch.int32,
                         device=grouping.device)
    for a, b in _sub_blocks(lo, hi, n, block_rows):
        idx = torch.arange(a, b, dtype=torch.int64, device=grouping.device)
        order = torch.argsort(permutation_keys(seed, idx, n), dim=1,
                              stable=True)
        labels[a - lo:b - lo] = g32[order]
        del order       # freed before the next sub-block's keys exist
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
                             seed: int = 0, block_rows: Optional[int] = None
                             ) -> torch.Tensor:
    """(hi - lo, n) int32 INDEX permutations restricted within strata
    blocks, for global indices [lo, hi), on strata's device: perm[i] has
    the stratum of i. Index 0 is the identity.

    The reference's construction: two stable argsorts group positions by
    stratum, once in the random order of the row's keys and once in the
    original order, and matching them up block by block gives a uniform
    within-block bijection. With a constant strata vector the draw is the
    free generator's argsort(keys). Drawn block_rows rows at a time
    (None: all at once), with the same rows for every block size."""
    n = strata.shape[0]
    dev = strata.device
    s = strata.to(torch.int64)
    b = torch.argsort(s, stable=True)                 # by stratum, in order
    perms = torch.empty((max(hi - lo, 0), n), dtype=torch.int32, device=dev)
    for r0, r1 in _sub_blocks(lo, hi, n, block_rows):
        idx = torch.arange(r0, r1, dtype=torch.int64, device=dev)
        a = torch.argsort(permutation_keys(seed, idx, n), dim=1,
                          stable=True)                # random position order
        a = torch.gather(a, 1, torch.argsort(s[a], dim=1,
                                             stable=True))  # by stratum
        block = torch.empty_like(a)
        block[:, b] = a
        perms[r0 - lo:r1 - lo] = block
        del a, block
    if lo == 0 and hi > 0:
        perms[0] = torch.arange(n, dtype=torch.int32, device=dev)
    return perms


def strata_label_batch(grouping: torch.Tensor, strata: torch.Tensor,
                       lo: int, hi: int, *, seed: int = 0,
                       block_rows: Optional[int] = None) -> torch.Tensor:
    """Permuted LABELS under strata restriction, (hi - lo, n) int32: the
    grouping composed with the index permutations, so every label impl
    and kernel consumes them unchanged. Drawn and gathered block_rows
    rows at a time (None: all at once)."""
    n = strata.shape[0]
    g32 = grouping.to(torch.int32)
    labels = torch.empty((max(hi - lo, 0), n), dtype=torch.int32,
                         device=grouping.device)
    for a, b in _sub_blocks(lo, hi, n, block_rows):
        perms = strata_permutation_batch(strata, a, b, seed=seed,
                                         block_rows=b - a)
        labels[a - lo:b - lo] = g32[perms.long()]
        del perms
    return labels


def masked_strata(strata: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Move the pad suffix [n_valid, n) into its own sentinel stratum,
    max(strata) + 1, so padded ragged studies permute pads only among
    themselves. Every key is a function of (seed, index, sample), so the
    valid prefix of a masked strata draw is the unpadded study's draw."""
    n = strata.shape[0]
    pos = torch.arange(n, device=strata.device)
    return torch.where(pos < int(n_valid), strata,
                       strata.max() + 1).to(strata.dtype)


# ---------------------------------------------------------------------------
# Many-study batches: per-study seeds and ragged studies padded to a common
# length.
# ---------------------------------------------------------------------------

_STUDY_SALT = 0x27D4EB2F


def _mix32_int(x: int) -> int:
    """_mix32 on one Python int in [0, 2^32)."""
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def study_seed(seed: int, s: int) -> int:
    """The seed study s of a batch draws from: a counter hash of (seed,
    s) in [0, 2^32), the port's fold_in(key, s). Study s of a many-study
    run draws exactly as a single-study run with seed=study_seed(seed,
    s), and no two studies share a stream."""
    seed, s = int(seed), int(s)
    folded = (seed & _M32) ^ ((seed >> 32) & _M32)
    return _mix32_int(_mix32_int(folded ^ _STUDY_SALT) ^ (s & _M32))


def masked_permute_grouping(grouping: torch.Tensor, n_valid: int, index: int,
                            *, seed: int = 0) -> torch.Tensor:
    """One relabeling (n,) of the VALID PREFIX [0, n_valid) only, for
    global permutation index `index` (no identity at 0): the prefix gets
    the stable argsort of permutation_keys(seed, index, n_valid), the pad
    suffix (a sentinel group) stays in place. The keys are the unpadded
    study's, so the prefix is the unpadded draw bit for bit (the
    reference's masked draw is a stream of its own)."""
    nv = int(n_valid)
    idx = torch.tensor([int(index)], dtype=torch.int64,
                       device=grouping.device)
    order = torch.argsort(permutation_keys(seed, idx, nv)[0], stable=True)
    out = grouping.to(torch.int32).clone()
    out[:nv] = grouping[:nv].to(torch.int32)[order]
    return out


def masked_permutation_batch(grouping: torch.Tensor, n_valid: int, lo: int,
                             hi: int, *, seed: int = 0,
                             block_rows: Optional[int] = None
                             ) -> torch.Tensor:
    """permutation_batch for a padded ragged study, (hi - lo, n) int32:
    each row permutes the valid prefix [0, n_valid) as the unpadded
    study's permutation_batch(grouping[:n_valid], ...) does (index 0 the
    identity; the same keys, so padded == unpadded bit for bit) and keeps
    the pad suffix in place."""
    nv = int(n_valid)
    n = grouping.shape[0]
    g32 = grouping.to(torch.int32)
    if nv == n:
        return permutation_batch(g32, lo, hi, seed=seed,
                                 block_rows=block_rows)
    labels = g32[None, :].repeat(max(hi - lo, 0), 1)
    labels[:, :nv] = permutation_batch(g32[:nv], lo, hi, seed=seed,
                                       block_rows=block_rows)
    return labels
