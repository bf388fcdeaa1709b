"""Inputs made from the seed, on the device, in a few large calls.

The laws are those of the port's `data/microbiome.py` (abundances are
Gamma(0.7, 1) with 70% of the entries zero), rewritten in torch so that
the table is drawn on the card and not on the host. A distance matrix is
Bray-Curtis of such a table, computed in row blocks. The sizes a law
fixes (group sizes, strata sizes) are the same for every seed; the seed
only decides which sample gets which label, so every seed asks for the
same work.
"""

from __future__ import annotations

from typing import List, Optional

import torch

_M64 = (1 << 64) - 1


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def mix(*parts) -> int:
    """A 64-bit hash of ints and strings: the seed of one stream."""
    h = 0
    for p in parts:
        if isinstance(p, str):
            p = int.from_bytes(p.encode(), "little")
        h = _splitmix(h ^ (int(p) & _M64))
    return h


def generator(device, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(*parts))
    return g


def law_sizes(n: int, count: int, law: dict) -> List[int]:
    """Sizes of `count` blocks summing to n, by a fixed law: 'geometric'
    (w_k = ratio^k) or 'zipf' (w_k = (k + 1)^-exponent), largest
    remainders first, each block at least `min` (default 2)."""
    kind = law["kind"]
    if kind == "geometric":
        w = [float(law["ratio"]) ** k for k in range(count)]
    elif kind == "zipf":
        w = [(k + 1.0) ** -float(law["exponent"]) for k in range(count)]
    else:
        raise ValueError(f"unknown size law {kind!r}")
    least = int(law.get("min", 2))
    free = n - least * count
    if free < 0:
        raise ValueError(f"{count} blocks of at least {least} exceed n={n}")
    total = sum(w)
    exact = [free * x / total for x in w]
    sizes = [int(e) for e in exact]
    order = sorted(range(count), key=lambda k: sizes[k] - exact[k])
    for k in order[:free - sum(sizes)]:
        sizes[k] += 1
    return [s + least for s in sizes]


def assign(sizes: List[int], gen: torch.Generator, device) -> torch.Tensor:
    """(n,) int32 labels with the given block sizes at random positions."""
    n = sum(sizes)
    blocks = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32, device=device),
        torch.tensor(sizes, device=device))
    out = torch.empty(n, dtype=torch.int32, device=device)
    out[torch.randperm(n, generator=gen, device=device)] = blocks
    return out


def abundance(n: int, d: int, seed: int, law: dict, device) -> torch.Tensor:
    """(n, d) float32 table: Gamma(shape) abundances, a share zeroed."""
    gen = generator(device, seed, "table")
    shape = torch.full((n, d), float(law["gamma_shape"]), device=device)
    x = torch._standard_gamma(shape, generator=gen)
    zero = torch.rand((n, d), generator=gen, device=device) < float(
        law["sparsity"])
    return x.masked_fill_(zero, 0.0)


def braycurtis_matrix(x: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """(n, n) float32 Bray-Curtis of the table's rows, exactly symmetric
    with a zero diagonal: each block row of the upper triangle is computed
    once and written with its transpose."""
    n = x.shape[0]
    r = x.sum(dim=1)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for a in range(0, n, block):
        b = min(a + block, n)
        blk = torch.cdist(x[a:b], x[a:], p=1) / (r[a:b, None] + r[None, a:])
        diag = blk[:, :b - a]
        diag.copy_(0.5 * (diag + diag.T))
        out[a:b, a:] = blk
        out[a:, a:b] = blk.T
    return out.fill_diagonal_(0.0)


def covariates(n: int, count: int, gen: torch.Generator, device
               ) -> List[torch.Tensor]:
    """`count` standard normal (n,) float32 covariates."""
    return list(torch.randn((count, n), generator=gen, device=device))


def strata(n: int, spec: Optional[dict], seed: int, device
           ) -> Optional[torch.Tensor]:
    """The run's (n,) int32 strata by the mix's law, or None."""
    if not spec:
        return None
    sizes = law_sizes(n, int(spec["count"]), spec["law"])
    return assign(sizes, generator(device, seed, "strata"), device)
