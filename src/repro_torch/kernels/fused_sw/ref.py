"""Plain PyTorch version the fused distance -> s_W kernel is held against.

Twin of `repro/kernels/fused_sw/ref.py`, written the slow, obvious way:
build the distance slab from the core row primitives
(`core.distance.ROW_METRICS`), mask by global index, square, contract with
the one-hot factors (`fstat.onehot_perm_factors` / `sw_matmul_contract`).
The rows go in blocks of at most 256, so the (block, n, d) Bray-Curtis
intermediates stay bounded and the plain version also runs on the card at
the paper's n. Each block's f32 squared distances are contracted in
float64 and the blocks' partials summed in float64, so the plain version
is an oracle sharper than the kernels it checks at that n: an f32
contraction of a design's signed basis columns cancels to ~s_T / n and
kept ~6e-7 s_T of rounding at the EMP design chunk, 59% of the 1e-6 s_T
bar, where the kernel's own error is ~2e-9 s_T.

`fused_sw_cols_ref` is the plain version of the dense-design kernel: the
same masked D^2 slab contracted per basis column
(`fstat.sw_cols_contract`) instead of with one-hot labels.

Both take the kernels' precision knobs (feat_bf16 / feat_fp8 /
feat_packed / feat_scale) the reference's way: the prepared features are
round-tripped through the kernel's representation (bf16 or e4m3
quantize-dequantize; packed presence words are exactly the 0/1 floats),
then the unchanged f32 math runs on them. `resolve_precision` validates
the knobs and picks the fp8 scale, for the plain versions, the kernels'
wrappers and the sweeps alike.
"""

from __future__ import annotations

import torch

from repro_torch.core import distance, fstat

ROWS_FNS = {m: distance.ROW_METRICS[m].rows
            for m in ("euclidean", "braycurtis", "jaccard")}
# Elements of the largest (block, n[, d]) intermediate of the row primitive,
# and the most rows a block holds.
_MAX_ELEMS = 2 ** 30
_MAX_ROWS = 256
# aitchison is euclidean geometry over clr-prepared features
_BODY = {"aitchison": "euclidean"}


def feature_mode(metric, feat_bf16=0, feat_fp8=0, feat_packed=0) -> str:
    """The feature mode the precision knobs select: 'f32', 'bf16', 'fp8'
    or 'packed'. The knobs are mutually exclusive, and packed presence
    words need the jaccard body (ValueError otherwise)."""
    if int(bool(feat_bf16)) + int(bool(feat_fp8)) + int(bool(feat_packed)) \
            > 1:
        raise ValueError(
            "feat_bf16 / feat_fp8 / feat_packed are mutually exclusive")
    if feat_packed:
        if _BODY.get(metric, metric) != "jaccard":
            raise ValueError("feat_packed=1 requires the jaccard kernel "
                             f"body (got metric={metric!r})")
        return "packed"
    if feat_fp8:
        return "fp8"
    return "bf16" if feat_bf16 else "f32"


def resolve_precision(x, metric, feat_bf16=0, feat_fp8=0, feat_packed=0,
                      feat_scale=None):
    """(mode, scale): the feature mode the knobs select (feature_mode) and,
    for fp8, the scale as a 0-d float32 tensor on x's device: feat_scale
    when given, else the full table x's (core.distance.fp8_metric_scale),
    so every row slab of one study quantizes alike; None otherwise."""
    mode = feature_mode(metric, feat_bf16, feat_fp8, feat_packed)
    if mode != "fp8":
        return mode, None
    if feat_scale is None:
        return mode, distance.fp8_metric_scale(x, _BODY.get(metric, metric))
    return mode, torch.as_tensor(feat_scale, dtype=torch.float32,
                                 device=x.device).reshape(())


def roundtrip(x: torch.Tensor, mode: str, scale=None) -> torch.Tensor:
    """x as float32 values of the mode's representation: bf16 or e4m3 at
    `scale` quantized and cast back up, packed thresholded to presence
    (exact on the 0/1 floats jaccard prepares), f32 as it is."""
    x = x.to(torch.float32)
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if mode == "fp8":
        return distance.fp8_roundtrip(x, scale)
    if mode == "packed":
        return (x > 0).to(torch.float32)
    return x


def _masked_d2_blocks(x_rows, x, row_offset, metric, n_valid, precision):
    """Yield (lo, hi, m2) over the slab's rows in blocks: the squared
    distances of rows [lo, hi) against all samples, with pairs at or past
    n_valid and the global diagonal row_offset + r == c zeroed. The
    features are first round-tripped per `precision` (feat_* knobs); an
    fp8 scale defaults to the full table's."""
    rows_fn = ROWS_FNS[_BODY.get(metric, metric)]
    nr, n = x_rows.shape[0], x.shape[0]
    mode, scale = resolve_precision(x, metric, **precision)
    xr = roundtrip(x_rows, mode, scale)
    xc = roundtrip(x, mode, scale)
    per_row = n * x.shape[1] if metric == "braycurtis" else n
    block = max(1, min(_MAX_ROWS, _MAX_ELEMS // max(per_row, 1)))
    cols = torch.arange(n, device=x.device)[None, :]
    for lo in range(0, nr, block):
        hi = min(lo + block, nr)
        d = rows_fn(xr[lo:hi], xc)
        rows = row_offset + torch.arange(lo, hi, device=x.device)[:, None]
        valid = (rows < n_valid) & (cols < n_valid) & (rows != cols)
        yield lo, hi, torch.where(valid, d * d, 0.0)


def fused_sw_ref(x_rows: torch.Tensor, x: torch.Tensor,
                 g_rows: torch.Tensor, g_cols: torch.Tensor,
                 inv_gs: torch.Tensor, row_offset: int, *,
                 metric: str = "braycurtis", n_valid=None, feat_bf16=0,
                 feat_fp8=0, feat_packed=0, feat_scale=None):
    """(s_W (P,) f32, row_sums (nr,) f32) for one row slab.

    x_rows (nr, d) prepared features of the slab's rows, global rows
    row_offset + [0, nr); x (n, d) all samples; g_rows (P, nr) / g_cols
    (P, n) int32 permuted labels; inv_gs (G,) f32. Pairs with a row or a
    column at or past n_valid (default n) and the diagonal row_offset + r
    == c contribute nothing. The precision knobs round-trip the features
    through the kernel's representation first (feat_scale pins the fp8
    scale; default: the full table's)."""
    nr, n = x_rows.shape[0], x.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    # sqrt(w) rounded to f32 as the kernel's, the contraction in float64
    e = fstat.onehot_perm_factors(g_cols, inv_gs,
                                  torch.float32).double()     # (P, n, G)
    s_w = torch.zeros(g_cols.shape[0], dtype=torch.float64, device=x.device)
    row_sums = torch.empty(nr, dtype=torch.float32, device=x.device)
    precision = dict(feat_bf16=feat_bf16, feat_fp8=feat_fp8,
                     feat_packed=feat_packed, feat_scale=feat_scale)
    for lo, hi, m2 in _masked_d2_blocks(x_rows, x, row_offset, metric,
                                        n_valid, precision):
        e_rows = fstat.onehot_perm_factors(g_rows[:, lo:hi], inv_gs,
                                           torch.float32).double()
        s_w += fstat.sw_matmul_contract(m2.double(), e, e_rows)
        row_sums[lo:hi] = m2.sum(dim=1)
    return s_w.to(torch.float32), row_sums


def fused_sw_cols_ref(x_rows: torch.Tensor, x: torch.Tensor,
                      v_rows: torch.Tensor, v_cols: torch.Tensor,
                      row_offset: int, *, metric: str = "braycurtis",
                      n_valid=None, feat_bf16=0, feat_fp8=0, feat_packed=0,
                      feat_scale=None):
    """(s_cols (P, K) f32, row_sums (nr,) f32) for one row slab of a dense
    design: s[p, k] = 1/2 sum_{r,c} D2[r, c] v_rows[p, r, k] v_cols[p, c, k]
    over the masked squared distances (the mask of fused_sw_ref).

    v_rows (P, nr, K) f32 permuted basis at the slab's GLOBAL rows; v_cols
    (P, n, K) f32 permuted basis over all samples. The precision knobs as
    fused_sw_ref's."""
    nr, n = x_rows.shape[0], x.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    p, _, k = v_cols.shape
    vc = v_cols.to(torch.float32).double()
    s_cols = torch.zeros((p, k), dtype=torch.float64, device=x.device)
    row_sums = torch.empty(nr, dtype=torch.float32, device=x.device)
    precision = dict(feat_bf16=feat_bf16, feat_fp8=feat_fp8,
                     feat_packed=feat_packed, feat_scale=feat_scale)
    for lo, hi, m2 in _masked_d2_blocks(x_rows, x, row_offset, metric,
                                        n_valid, precision):
        s_cols += fstat.sw_cols_contract(
            m2.double(), vc, v_rows[:, lo:hi].to(torch.float32).double())
        row_sums[lo:hi] = m2.sum(dim=1)
    return s_cols.to(torch.float32), row_sums
