"""Plain PyTorch versions the pairwise-distance kernels are held against.

Twin of `repro/kernels/distance/ref.py`: the four tile bodies of
`repro/kernels/distance/kernel.py` on the whole rectangle, rows `xr`
(nr, d) against rows `xc` (nc, d) -> (nr, nc) f32:

  braycurtis      sum|x - y| / max(sum(x + y), 1e-30)
  euclidean       sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))
  jaccard         on 0/1 floats: 1 - inter / max(union, 1),
                  union = |A| + |B| - inter
  jaccard_packed  the same on int32 presence words (core.distance.
                  pack_presence_bits), inter = popcount(AND)

The two jaccard forms run the same f32 finalize on counts that are exact
integers in f32, so they agree bit for bit. Broadcast forms run in row
blocks, so the plain versions also run on the card at the paper's n.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import distance

# Elements of the largest (block, nc, d) broadcast intermediate.
_MAX_ELEMS = 2 ** 30

_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int32)


def _by_rows(fn: Callable, xr: torch.Tensor, xc: torch.Tensor,
             per_row: int) -> torch.Tensor:
    """fn(xr, xc) in row blocks of at most _MAX_ELEMS // per_row rows."""
    nr, nc = xr.shape[0], xc.shape[0]
    block = max(1, _MAX_ELEMS // max(per_row, 1))
    if block >= nr:
        return fn(xr, xc)
    out = torch.empty((nr, nc), dtype=torch.float32, device=xr.device)
    for lo in range(0, nr, block):
        out[lo:lo + block] = fn(xr[lo:lo + block], xc)
    return out


def braycurtis_ref(xr: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    return _by_rows(distance.braycurtis_rows, xr, xc,
                    xc.shape[0] * xr.shape[1])


def euclidean_ref(xr: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    return distance.euclidean_rows(xr, xc)


def jaccard_ref(xr: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    return distance.jaccard_rows(xr, xc)


def popcount_sum(words: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of the popcounts of int32 words, by a byte
    lookup table (torch has no popcount)."""
    b = words.contiguous().view(torch.uint8).long()
    return _POPCOUNT8.to(words.device)[b].sum(dim=-1)


def _jaccard_packed_rows(wr: torch.Tensor, wc: torch.Tensor
                         ) -> torch.Tensor:
    inter = popcount_sum(wr[:, None, :] & wc[None, :, :]).to(torch.float32)
    card_r = popcount_sum(wr).to(torch.float32)[:, None]
    card_c = popcount_sum(wc).to(torch.float32)[None, :]
    union = card_r + card_c - inter
    return 1.0 - inter / union.clamp(min=1.0)


def jaccard_packed_ref(wr: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    # per row: the (nc, W) AND words and their 4 W bytes as int64 indices
    return _by_rows(_jaccard_packed_rows, wr, wc,
                    wc.shape[0] * wr.shape[1] * 8)


REFS = {
    "braycurtis": braycurtis_ref,
    "euclidean": euclidean_ref,
    "jaccard": jaccard_ref,
    "jaccard_packed": jaccard_packed_ref,
}
