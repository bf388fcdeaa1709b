"""A frozen copy of the port's permutation arithmetic.

The program draws permutation p of sample i from a counter hash of
(seed, p, i) and takes the stable argsort of each row of keys; strata
draws match a random and an ordered stable sort of positions block by
block. This copy re-derives the same labels and index permutations from
the seed, so the reference tests the very permutations the program was
asked to draw. It is a copy on purpose: a change to the program's draws
has to keep these rows, or the benchmark reads it as wrong.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_SALTS = (0x9E3779B9, 0x85EBCA6B)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keys(seed: int, lo: int, hi: int, n: int, device) -> torch.Tensor:
    """(hi - lo, n) int64 sort keys of global permutation indices [lo, hi)."""
    seed = int(seed)
    s = torch.tensor([(seed & _M32) ^ ((seed >> 32) & _M32)],
                     dtype=torch.int64, device=device)
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device) & _M32
    col = torch.arange(n, dtype=torch.int64, device=device)
    halves = []
    for salt in _SALTS:
        row = _mix32(_mix32(s ^ salt) ^ idx)
        halves.append(_mix32(row[:, None] ^ _mix32(col ^ salt)[None, :]))
    return ((halves[0] >> 1) << 32) | halves[1]


def index_perms(seed: int, lo: int, hi: int, n: int, device,
                strata: torch.Tensor = None) -> torch.Tensor:
    """(hi - lo, n) int64 index permutations (row 0 of the sweep is the
    identity), free or within strata blocks."""
    order = torch.argsort(keys(seed, lo, hi, n, device), dim=1, stable=True)
    if strata is not None:
        s = strata.to(device=device, dtype=torch.int64)
        by_stratum = torch.argsort(s, stable=True)
        order = torch.gather(order, 1, torch.argsort(s[order], dim=1,
                                                     stable=True))
        block = torch.empty_like(order)
        block[:, by_stratum] = order
        order = block
    if lo == 0 and hi > 0:
        order[0] = torch.arange(n, dtype=torch.int64, device=device)
    return order


def label_perms(grouping: torch.Tensor, seed: int, lo: int, hi: int,
                strata: torch.Tensor = None) -> torch.Tensor:
    """(hi - lo, n) int64 permuted labels: the grouping gathered through
    index_perms (row 0, at lo == 0, is the observed grouping)."""
    g = grouping.to(torch.int64)
    return g[index_perms(seed, lo, hi, g.shape[0], g.device, strata)]
