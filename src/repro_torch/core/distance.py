"""Distance-matrix construction — the substrate feeding PERMANOVA.

Twin of `repro/core/distance.py`, in plain PyTorch (the reference computes
these in plain jnp too; the tiled kernels live in `kernels/distance` and
are reached through `pipeline.registry`). Each metric is factored as

  prepare(x)        one-off (n, d) feature transform (clr for Aitchison,
                    presence cast for Jaccard; identity otherwise)
  rows(xb, xprep)   distances for a block of rows against all samples

and the dense drivers assemble the (n, n) matrix from row blocks, so the
(block, n, d) intermediates of Bray-Curtis stay bounded.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# the fp8 cast, shared with the LM's caches; read here by the fused
# kernels' plain versions
from repro_torch.precision import (FP8_MAX, FP8_NAN_ABOVE,  # noqa: F401
                                   fp8_quantize)


def _identity_prepare(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def clr_prepare(x, *, pseudocount: float = 0.5) -> torch.Tensor:
    """Centered log-ratio transform (Aitchison geometry on compositions)."""
    logx = torch.log(torch.as_tensor(x, dtype=torch.float32) + pseudocount)
    return logx - logx.mean(dim=-1, keepdim=True)


def presence_prepare(x) -> torch.Tensor:
    """Presence/absence cast for binary metrics (kept float32)."""
    return (torch.as_tensor(x) > 0).to(torch.float32)


def clr_prepare_(x: torch.Tensor, *,
                 pseudocount: float = 0.5) -> torch.Tensor:
    """clr_prepare in place on a float32 tensor the caller owns: the same
    operations, so the same bits, and no copy of it."""
    x.add_(pseudocount).log_()
    return x.sub_(x.mean(dim=-1, keepdim=True))


def presence_prepare_(x: torch.Tensor) -> torch.Tensor:
    """presence_prepare in place on a float32 tensor the caller owns."""
    return x.gt_(0)


_INPLACE_PREPARE = {clr_prepare: clr_prepare_,
                    presence_prepare: presence_prepare_}


def inplace_prepare(prepare):
    """The in-place twin of a prepare that copies its input (clr,
    presence), else `prepare` itself: for a caller that owns each float32
    tensor it prepares, as the out-of-core sweep owns its fetched
    slabs."""
    return _INPLACE_PREPARE.get(prepare, prepare)


# Elements of the (rows, n, d) products a CPU Gram block multiplies at once.
_GRAM_BLOCK_ELEMS = 2 ** 22


def _cross_rows(xb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(block, n) dot products xb @ x.T. On the CPU each pair is a
    multiply-and-sum over its d features, in row blocks of bounded
    products: a CPU matmul picks its blocking by the call's width, so a
    pair's bits would depend on how many columns share the call (the
    out-of-core sweep builds a row slab from (slab, slab) tiles). On the
    card the matmul stays (its sums are held to float64 there); only a
    pinned '<metric>.blocked' / '.dense' impl reaches it, and cuBLAS may
    pick its split-k by shape, so their out-of-core run is not promised
    the in-memory bits (the '.cuda' kernels are)."""
    if x.device.type != "cpu":
        return xb @ x.T
    rows = max(1, _GRAM_BLOCK_ELEMS // max(x.shape[0] * x.shape[1], 1))
    out = torch.empty((xb.shape[0], x.shape[0]), dtype=torch.float32)
    for lo in range(0, xb.shape[0], rows):
        out[lo:lo + rows] = (xb[lo:lo + rows, None, :]
                             * x[None, :, :]).sum(dim=-1)
    return out


def euclidean_rows(xb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(block, n) Euclidean distances via the Gram trick; on the CPU each
    pair's bits do not depend on the call's shape (_cross_rows)."""
    sq_b = (xb * xb).sum(dim=-1)[:, None]
    sq = (x * x).sum(dim=-1)[None, :]
    d2 = sq_b + sq - 2.0 * _cross_rows(xb, x)
    return torch.sqrt(d2.clamp(min=0.0))


def braycurtis_rows(xb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(block, n) Bray-Curtis: sum|xi-xj| / sum(xi+xj)."""
    num = (xb[:, None, :] - x[None, :, :]).abs().sum(dim=-1)
    den = (xb[:, None, :] + x[None, :, :]).sum(dim=-1)
    return num / den.clamp(min=1e-30)


def jaccard_rows(xb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(block, n) binary Jaccard on presence/absence (float multiply is
    AND, so the intersection is a matmul)."""
    inter = xb @ x.T
    card_b = xb.sum(dim=-1)[:, None]
    card = x.sum(dim=-1)[None, :]
    union = card_b + card - inter
    return 1.0 - inter / union.clamp(min=1.0)


def pack_presence_bits(xprep) -> torch.Tensor:
    """Pack a presence/absence slab into 32-bit words along features.

    (n, d) -> (n, ceil(d/32)) int32 holding the reference's uint32 bits:
    bit k of word w is 1[x[:, 32*w + k] > 0], pad features are zero bits.
    torch has little uint32 support, so the words are int32 with the same
    bits: built in int64, then values >= 2^31 are folded down by 2^32
    before the cast (an out-of-range int64 -> int32 cast is not defined
    to wrap). The words are built one bit position at a time (features
    k, 32 + k, ...), so the transients are word-sized, not an int64 copy
    of the table."""
    x = torch.as_tensor(xprep)
    n, d = x.shape
    words = torch.zeros((n, -(-d // 32)), dtype=torch.int64, device=x.device)
    for k in range(min(32, d)):
        bits = x[:, k::32] > 0
        words[:, :bits.shape[1]] |= bits.to(torch.int64) << k
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


# ---------------------------------------------------------------------------
# Precision helpers: fp8 (e4m3) feature-slab quantization. They feed the
# fused kernels' feat_fp8 knob and the plain versions' round trips.
# ---------------------------------------------------------------------------

def fp8_scale(xprep) -> torch.Tensor:
    """Calibration scale so max|x| / scale hits the e4m3 range: a 0-d
    float32 tensor, at least 1e-12 (an all-zero table must not divide by
    zero). Computed once per study on the prepared table."""
    amax = torch.as_tensor(xprep, dtype=torch.float32).abs().max()
    return torch.clamp(amax / FP8_MAX, min=1e-12)


def fp8_metric_scale(xprep, metric: str) -> torch.Tensor:
    """Metric-aware calibration: presence tables (jaccard) are {0, 1},
    exact in e4m3 at scale 1; every other metric calibrates to the table's
    largest magnitude."""
    if metric == "jaccard":
        return torch.ones((), dtype=torch.float32,
                          device=torch.as_tensor(xprep).device)
    return fp8_scale(xprep)


def fp8_roundtrip(xprep, scale=None) -> torch.Tensor:
    """Quantize to float8_e4m3fn and back to float32: the values the fp8
    kernel computes with (scale down, cast, cast up, scale up). The scale
    defaults to fp8_scale(xprep)."""
    x = torch.as_tensor(xprep, dtype=torch.float32)
    s = fp8_scale(x) if scale is None else torch.as_tensor(
        scale, dtype=torch.float32, device=x.device)
    return fp8_quantize(x, s).to(torch.float32) * s


class MetricDef(NamedTuple):
    """Factored metric: one-off feature transform + row-block function."""
    prepare: Callable
    rows: Callable


ROW_METRICS: dict[str, MetricDef] = {
    "euclidean": MetricDef(_identity_prepare, euclidean_rows),
    "braycurtis": MetricDef(_identity_prepare, braycurtis_rows),
    "jaccard": MetricDef(presence_prepare, jaccard_rows),
    "aitchison": MetricDef(clr_prepare, euclidean_rows),
}


# ---------------------------------------------------------------------------
# Dense metrics (public API) — drivers over the row primitives.
# ---------------------------------------------------------------------------

def euclidean(x) -> torch.Tensor:
    """Pairwise Euclidean via the Gram trick (single full-matrix form)."""
    xp = _identity_prepare(x)
    return _zero_diag(euclidean_rows(xp, xp))


def braycurtis(x, *, block: int = 256) -> torch.Tensor:
    """Bray-Curtis dissimilarity, blocked over rows (bounds peak memory)."""
    xp = _identity_prepare(x)
    return _zero_diag(_blocked_rows(braycurtis_rows, xp, block))


def jaccard(x, *, block: int = 256) -> torch.Tensor:
    """Binary Jaccard distance on presence/absence (x > 0)."""
    xp = presence_prepare(x)
    return _zero_diag(_blocked_rows(jaccard_rows, xp, block))


def aitchison(x, *, pseudocount: float = 0.5) -> torch.Tensor:
    """Aitchison distance: Euclidean over clr-transformed compositions."""
    xp = clr_prepare(x, pseudocount=pseudocount)
    return _zero_diag(euclidean_rows(xp, xp))


METRICS: dict[str, Callable] = {
    "euclidean": euclidean,
    "braycurtis": braycurtis,
    "jaccard": jaccard,
    "aitchison": aitchison,
}


def distance_matrix(x, metric: str = "braycurtis", **kw) -> torch.Tensor:
    """(n, n) f32 distances on x's device (a numpy x lands on the CPU)."""
    return METRICS[metric](x, **kw)


def _zero_diag(d: torch.Tensor) -> torch.Tensor:
    """Zero the diagonal in place (the reference multiplies by 1 - eye,
    which would hold a second (n, n) array at the paper's n)."""
    return d.fill_diagonal_(0.0)


def _blocked_rows(row_fn: Callable, x: torch.Tensor, block: int
                  ) -> torch.Tensor:
    """Apply row_fn to row blocks, writing each into one (n, n) buffer."""
    n = x.shape[0]
    block = max(1, min(block, n))
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for lo in range(0, n, block):
        out[lo:lo + block] = row_fn(x[lo:lo + block], x)
    return out


def validate_distance_matrix(d: torch.Tensor, *, atol: float = 1e-5
                             ) -> dict:
    """Structural checks the PERMANOVA engine relies on."""
    sym = float((d - d.T).abs().max())
    diag = float(torch.diagonal(d).abs().max())
    neg = float(d.min())
    ok = sym <= atol and diag <= atol and neg >= -atol
    return {"symmetric_maxerr": sym, "diag_maxabs": diag,
            "min_value": neg, "ok": ok}
