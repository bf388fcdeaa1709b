"""Plain PyTorch version the fused distance -> s_W kernel is held against.

Twin of `repro/kernels/fused_sw/ref.py`, written the slow, obvious way:
build the distance slab from the core row primitives
(`core.distance.ROW_METRICS`), mask by global index, square, contract with
the one-hot factors (`fstat.onehot_perm_factors` / `sw_matmul_contract`).
The rows go in blocks, so the (block, n, d) Bray-Curtis intermediates stay
bounded and the plain version also runs on the card at the paper's n.

`fused_sw_cols_ref` is the plain version of the dense-design kernel: the
same masked D^2 slab contracted per basis column
(`fstat.sw_cols_contract`) instead of with one-hot labels.

The reference's precision knobs (bf16 / fp8 / packed feature slabs) come
with the precision slice; a nonzero value raises NotImplementedError.
"""

from __future__ import annotations

import torch

from repro_torch.core import distance, fstat
from repro_torch.core.permanova import _later

ROWS_FNS = {m: distance.ROW_METRICS[m].rows
            for m in ("euclidean", "braycurtis", "jaccard")}
PRECISION_KEYS = ("feat_bf16", "feat_fp8", "feat_packed")
# Elements of the largest (block, n[, d]) intermediate of the row primitive.
_MAX_ELEMS = 2 ** 30


def reject_precision(tuning) -> None:
    """Raise NotImplementedError for any nonzero precision knob (or an fp8
    calibration scale) in `tuning`: the port's fused kernel is f32 only."""
    on = [k for k in PRECISION_KEYS if int((tuning or {}).get(k) or 0)]
    if (tuning or {}).get("feat_scale") is not None:
        on.append("feat_scale")
    if on:
        raise _later(f"the fused kernel's precision knobs "
                     f"({', '.join(f'{k}={tuning[k]}' for k in on)})",
                     "precision")


def _masked_d2_blocks(x_rows, x, row_offset, metric, n_valid):
    """Yield (lo, hi, m2) over the slab's rows in blocks: the squared
    distances of rows [lo, hi) against all samples, with pairs at or past
    n_valid and the global diagonal row_offset + r == c zeroed."""
    rows_fn = ROWS_FNS[{"aitchison": "euclidean"}.get(metric, metric)]
    nr, n = x_rows.shape[0], x.shape[0]
    xr = x_rows.to(torch.float32)
    xc = x.to(torch.float32)
    per_row = n * x.shape[1] if metric == "braycurtis" else n
    block = max(1, _MAX_ELEMS // max(per_row, 1))
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
    == c contribute nothing."""
    reject_precision(dict(feat_bf16=feat_bf16, feat_fp8=feat_fp8,
                          feat_packed=feat_packed, feat_scale=feat_scale))
    nr, n = x_rows.shape[0], x.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    e = fstat.onehot_perm_factors(g_cols, inv_gs, torch.float32)  # (P, n, G)
    s_w = torch.zeros(g_cols.shape[0], dtype=torch.float32, device=x.device)
    row_sums = torch.empty(nr, dtype=torch.float32, device=x.device)
    for lo, hi, m2 in _masked_d2_blocks(x_rows, x, row_offset, metric,
                                        n_valid):
        e_rows = fstat.onehot_perm_factors(g_rows[:, lo:hi], inv_gs,
                                           torch.float32)
        s_w = s_w + fstat.sw_matmul_contract(m2, e, e_rows)
        row_sums[lo:hi] = m2.sum(dim=1)
    return s_w, row_sums


def fused_sw_cols_ref(x_rows: torch.Tensor, x: torch.Tensor,
                      v_rows: torch.Tensor, v_cols: torch.Tensor,
                      row_offset: int, *, metric: str = "braycurtis",
                      n_valid=None):
    """(s_cols (P, K) f32, row_sums (nr,) f32) for one row slab of a dense
    design: s[p, k] = 1/2 sum_{r,c} D2[r, c] v_rows[p, r, k] v_cols[p, c, k]
    over the masked squared distances (the mask of fused_sw_ref).

    v_rows (P, nr, K) f32 permuted basis at the slab's GLOBAL rows; v_cols
    (P, n, K) f32 permuted basis over all samples."""
    nr, n = x_rows.shape[0], x.shape[0]
    n_valid = n if n_valid is None else int(n_valid)
    p, _, k = v_cols.shape
    vc = v_cols.to(torch.float32)
    s_cols = torch.zeros((p, k), dtype=torch.float32, device=x.device)
    row_sums = torch.empty(nr, dtype=torch.float32, device=x.device)
    for lo, hi, m2 in _masked_d2_blocks(x_rows, x, row_offset, metric,
                                        n_valid):
        s_cols = s_cols + fstat.sw_cols_contract(
            m2, vc, v_rows[:, lo:hi].to(torch.float32))
        row_sums[lo:hi] = m2.sum(dim=1)
    return s_cols, row_sums
