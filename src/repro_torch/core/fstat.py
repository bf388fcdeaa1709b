"""PERMANOVA partial statistic s_W in plain PyTorch forms.

    s_W[p] = sum_{row < col} mat2[row,col]
             * 1[g_p[row] == g_p[col]] * inv_group_sizes[g_p[row]]

Twin of `repro/core/fstat.py`. Forms:

  sw_algorithm1_numpy  literal numpy transcription of the paper's
                       Algorithm 1 — the oracle (a copy, not an import)
  sw_brute_one/_brute  vectorized strict-upper-triangle brute force
                       (paper Algorithm 3 dataflow)
  sw_tiled_one/_tiled  paper Algorithm 2: explicit TILE x TILE loop nest
                       over the upper triangle, sentinel-padded for
                       ragged (e.g. prime) n
  sw_matmul*           one-hot reformulation: s_W from mat2 @ E with
                       E in {0, sqrt(w_g)}^{n x (P*G)}
  sw_*rows_*           row-slab partials for row-sharded s_W
                       (core.distributed): brute bands, matmul, per-column

All take mat2 = D * D precomputed. These are the plain versions the CUDA
kernels are held against; on the card they are what `chip_smoke.py`
times as `plain_ms`. A label outside [0, G) weighs 0 in every form, as in
the kernels (`row_weight`): a study zero-padded to a shape bucket, its pad
rows carrying the sentinel label G, gives the unpadded study's s_W.
"""

from __future__ import annotations

import numpy as np
import torch


def sw_algorithm1_numpy(mat: np.ndarray, groupings: np.ndarray,
                        inv_group_sizes: np.ndarray) -> np.ndarray:
    """Literal transcription of the paper's ALGORITHM 1 (brute force).

    Takes the distance matrix `mat` (not mat2) and squares in the loop."""
    mat = np.asarray(mat, dtype=np.float32)
    groupings = np.asarray(groupings)
    inv_group_sizes = np.asarray(inv_group_sizes, dtype=np.float32)
    n_perms, n_dims = groupings.shape
    out = np.zeros((n_perms,), dtype=np.float32)
    for p in range(n_perms):
        grouping = groupings[p]
        s_w = np.float32(0.0)
        for row in range(n_dims - 1):          # no columns in last row
            group_idx = grouping[row]
            mat_row = mat[row]
            local = np.float32(0.0)
            for col in range(row + 1, n_dims):  # diagonal is always zero
                if grouping[col] == group_idx:
                    val = mat_row[col]
                    local += val * val
            s_w += local * inv_group_sizes[group_idx]
        out[p] = s_w
    return out


# ---------------------------------------------------------------------------
# Brute force (paper Algorithm 3 dataflow).
# ---------------------------------------------------------------------------

def label_weights(groupings: torch.Tensor, inv_gs: torch.Tensor
                  ) -> torch.Tensor:
    """w[g] for every label, and 0 for a label outside [0, G) (the
    sentinel G of a padded study's pad rows)."""
    g = groupings.long()
    n_groups = inv_gs.shape[0]
    ext = torch.cat([inv_gs, inv_gs.new_zeros(1)])
    return ext[torch.where((g >= 0) & (g < n_groups), g,
                           torch.full_like(g, n_groups))]


def _brute_block(mat2, gblock, inv_gs, triu):
    """(B,) s_W for a block of B label rows: every (row < col) pair adds
    mat2[row,col] * w[g[row]] iff g[col] == g[row]."""
    same = gblock[:, :, None] == gblock[:, None, :]          # (B, n, n)
    w_row = label_weights(gblock, inv_gs)[:, :, None]        # hoisted weight
    contrib = torch.where(same & triu, mat2 * w_row,
                          torch.zeros((), dtype=w_row.dtype,
                                      device=mat2.device))
    return contrib.sum(dim=(1, 2))


def _triu(n: int, device) -> torch.Tensor:
    return torch.ones((n, n), dtype=torch.bool, device=device).triu(1)


def sw_brute_one(mat2: torch.Tensor, grouping: torch.Tensor,
                 inv_group_sizes: torch.Tensor) -> torch.Tensor:
    """Vectorized brute force over the strict upper triangle, one perm."""
    triu = _triu(mat2.shape[0], mat2.device)
    return _brute_block(mat2, grouping[None], inv_group_sizes, triu)[0]


def sw_full_one(mat2: torch.Tensor, grouping: torch.Tensor,
                inv_group_sizes: torch.Tensor) -> torch.Tensor:
    """Full-matrix (i != j) form, one perm: sums every same-group pair of
    the symmetric matrix and halves (its zero diagonal needs no
    correction); a label outside [0, G) weighs 0."""
    same = (grouping[:, None] == grouping[None, :]).to(mat2.dtype)
    w_row = label_weights(grouping, inv_group_sizes)[:, None]
    return 0.5 * (mat2 * same * w_row).sum()


def sw_brute(mat2: torch.Tensor, groupings: torch.Tensor,
             inv_group_sizes: torch.Tensor, *, block: int = 32
             ) -> torch.Tensor:
    """Brute-force s_W for a batch of permutations, `block` label rows at
    a time (each block holds a few (block, n, n) temporaries). (P,) f32."""
    triu = _triu(mat2.shape[0], mat2.device)
    block = max(1, min(block, groupings.shape[0]))
    return torch.cat([_brute_block(mat2, gb, inv_group_sizes, triu)
                      for gb in torch.split(groupings, block)])


# ---------------------------------------------------------------------------
# Tiled (paper Algorithm 2 dataflow).
# ---------------------------------------------------------------------------

def _tiled_block(mat2, gblock, inv_gs, tile):
    """Algorithm 2 for a block of B label rows: an explicit loop over the
    TILE x TILE tiles with tj >= ti, the per-row weight hoisted.

    When n is not a multiple of `tile` (prime n), mat2 is zero-padded up
    to the tile and the pad carries a sentinel group (-1) with weight 0,
    so every pad pair adds exactly 0 — the tiled dataflow is kept rather
    than shrinking the tile."""
    n = mat2.shape[0]
    tile = min(tile, n)
    w = label_weights(gblock, inv_gs)                       # (B, n)
    g = gblock.long()
    pad = (-n) % tile
    if pad:
        mat2 = torch.nn.functional.pad(mat2, (0, pad, 0, pad))
        g = torch.nn.functional.pad(g, (0, pad), value=-1)
        w = torch.nn.functional.pad(w, (0, pad))
        n += pad
    ids = torch.arange(tile, device=mat2.device)
    s_w = torch.zeros(gblock.shape[0], dtype=mat2.dtype, device=mat2.device)
    for r0 in range(0, n, tile):
        g_row = g[:, r0:r0 + tile]
        w_row = w[:, r0:r0 + tile]
        for c0 in range(r0, n, tile):       # only tj >= ti hold pairs
            m_tile = mat2[r0:r0 + tile, c0:c0 + tile]
            g_col = g[:, c0:c0 + tile]
            tri = (c0 + ids[None, :]) > (r0 + ids[:, None])   # global coords
            mask = tri & (g_col[:, None, :] == g_row[:, :, None])
            local = torch.where(mask, m_tile, 0.0).sum(dim=2)  # per-row local
            s_w = s_w + (local * w_row).sum(dim=1)
    return s_w


def sw_tiled_one(mat2: torch.Tensor, grouping: torch.Tensor,
                 inv_group_sizes: torch.Tensor, *, tile: int = 64
                 ) -> torch.Tensor:
    """Structural transcription of the paper's ALGORITHM 2, one perm."""
    return _tiled_block(mat2, grouping[None], inv_group_sizes, tile)[0]


def sw_tiled(mat2: torch.Tensor, groupings: torch.Tensor,
             inv_group_sizes: torch.Tensor, *, tile: int = 64,
             block: int = 8) -> torch.Tensor:
    block = max(1, min(block, groupings.shape[0]))
    return torch.cat([_tiled_block(mat2, gb, inv_group_sizes, tile)
                      for gb in torch.split(groupings, block)])


# ---------------------------------------------------------------------------
# One-hot matmul formulation.
# ---------------------------------------------------------------------------

def rounded_sqrt(x: torch.Tensor, dtype) -> torch.Tensor:
    """sqrt(x) correctly rounded to `dtype`: computed in float64, rounded
    once (as IEEE, numpy and XLA round an f32 sqrt)."""
    return torch.sqrt(x.to(torch.float64)).to(dtype)


def onehot_perm_factors(groupings_block: torch.Tensor,
                        inv_group_sizes: torch.Tensor, dtype
                        ) -> torch.Tensor:
    """E[p,:,g] = sqrt(w_g) * 1[g_p[i] == g] — the (P, n, G) one-hot
    factor; a label outside [0, G) gets a zero row. sqrt(w) is rounded to
    `dtype`, as the reference does: taken in float64 and rounded once, so
    it is the correctly rounded f32 square root (torch's f32 sqrt is 1 ulp
    off on some CPUs)."""
    n_groups = inv_group_sizes.shape[0]
    sqrt_w = rounded_sqrt(inv_group_sizes, dtype)
    groups = torch.arange(n_groups, device=groupings_block.device)
    e = (groupings_block.long()[..., None] == groups).to(dtype)
    return e * sqrt_w[None, None, :]


def sw_matmul_contract(mat2_rows: torch.Tensor, e: torch.Tensor,
                       e_rows: torch.Tensor) -> torch.Tensor:
    """s[p] = 1/2 * sum_ig (M2_rows @ E[p])[i,g] * E_rows[p,i,g].

    e: (P, n, G) column factors over all samples; e_rows: (P, n_local, G)
    row factors aligned with mat2_rows. The zero diagonal makes the full
    i != j sum exactly twice the triangle sum."""
    p, n, g = e.shape
    n_local = mat2_rows.shape[0]
    e2d = e.permute(1, 0, 2).reshape(n, p * g)              # (n, P*G)
    y = mat2_rows @ e2d
    s = (y.reshape(n_local, p, g) * e_rows.permute(1, 0, 2)).sum(dim=(0, 2))
    return 0.5 * s


def sw_matmul_block(mat2: torch.Tensor, groupings_block: torch.Tensor,
                    inv_group_sizes: torch.Tensor) -> torch.Tensor:
    """s_W for a block of P permutations via one matmul."""
    e = onehot_perm_factors(groupings_block, inv_group_sizes, mat2.dtype)
    return sw_matmul_contract(mat2, e, e)


def sw_matmul(mat2: torch.Tensor, groupings: torch.Tensor,
              inv_group_sizes: torch.Tensor, *, perm_block: int = 64
              ) -> torch.Tensor:
    """One-hot formulation over all permutations, perm_block at a time.
    (P,) in mat2's dtype (f32 in, f32 out)."""
    perm_block = max(1, min(perm_block, groupings.shape[0]))
    return torch.cat([sw_matmul_block(mat2, gb, inv_group_sizes)
                      for gb in torch.split(groupings, perm_block)])


# ---------------------------------------------------------------------------
# Row-sharded partials (core.distributed): a slab of rows
# [row_offset, row_offset + n_local) against every column. Partials of
# disjoint slabs sum to the full statistic. On the CPU each row's value is
# summed per pair in a fixed order, so a row's contribution does not
# depend on how many rows share the slab (a CPU matmul picks its blocking
# by the call's shape).
# ---------------------------------------------------------------------------

BAND_ROWS = 64          # the brute kernel's band (kBruteRows)
_PAIR_BLOCK_ELEMS = 2 ** 24


def _rows_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, n) @ (n, c). On the CPU each entry is a multiply-and-sum over
    its n pairs, in row blocks of bounded products, so a row's bits do
    not depend on m; on the card the matmul stays."""
    if a.device.type != "cpu":
        return a @ b
    rows = max(1, _PAIR_BLOCK_ELEMS // max(b.numel(), 1))
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32)
    for lo in range(0, a.shape[0], rows):
        out[lo:lo + rows] = (a[lo:lo + rows, :, None] * b[None]).sum(dim=1)
    return out


def sw_rows_bands(mat2_rows: torch.Tensor, row_offset: int,
                  groupings: torch.Tensor, inv_group_sizes: torch.Tensor,
                  *, block: int = 32) -> torch.Tensor:
    """(P, ceil(n_local / 64)) band partials of a row slab: row i adds
    mat2[i, j] for the columns j > i (global) of its permuted group, in
    column order, weighted once by w[g[i]]; each band of 64 slab rows sums
    its rows in order. With row_offset a multiple of 64 the bands are the
    matrix's own (the brute kernel's partial columns), so the slabs'
    columns concatenated are the whole matrix's. groupings: the (P, n)
    labels of every sample."""
    n_local, n = mat2_rows.shape
    dev = mat2_rows.device
    gi = row_offset + torch.arange(n_local, device=dev)[:, None]
    upper = torch.arange(n, device=dev)[None, :] > gi      # (n_local, n)
    pad = (-n_local) % BAND_ROWS
    per = max(1, min(block, groupings.shape[0],
                     _PAIR_BLOCK_ELEMS // max(n_local * n, 1)))
    out = []
    for gb in torch.split(groupings, per):
        g_rows = gb[:, row_offset:row_offset + n_local]
        same = gb[:, None, :] == g_rows[:, :, None]         # (B, n_local, n)
        local = torch.where(same & upper, mat2_rows,
                            torch.zeros((), dtype=mat2_rows.dtype,
                                        device=dev)).sum(dim=2)
        rows = local * label_weights(g_rows, inv_group_sizes)
        rows = torch.nn.functional.pad(rows, (0, pad))
        out.append(rows.view(gb.shape[0], -1, BAND_ROWS).sum(dim=2))
    return torch.cat(out)


def sw_rows_partial(mat2_rows: torch.Tensor, row_offset: int,
                    groupings: torch.Tensor, inv_group_sizes: torch.Tensor,
                    *, block: int = 32) -> torch.Tensor:
    """(P,) partial s_W over the rows [row_offset, row_offset + n_local):
    pairs (i, j) with i in the slab and j > i (global). Summing the
    partials of disjoint slabs gives the full s_W. groupings is the FULL
    (P, n) label array."""
    return sw_rows_bands(mat2_rows, row_offset, groupings, inv_group_sizes,
                         block=block).sum(dim=1)


def sw_matmul_rows_partial(mat2_rows: torch.Tensor, row_offset: int,
                           groupings: torch.Tensor,
                           inv_group_sizes: torch.Tensor, *,
                           perm_block: int = 64) -> torch.Tensor:
    """(P,) row-slab partial of the one-hot formulation: 1/2 * sum over
    the slab's rows i of (M2[i, :] @ E) . E[i, :], the full i != j sum
    (zero diagonal), so the partials of disjoint slabs sum to s_W. On the
    card the product is one torch.matmul (sw_matmul_contract's); on the
    CPU each row's product is summed per pair (_rows_matmul)."""
    n_local, n = mat2_rows.shape
    perm_block = max(1, min(perm_block, groupings.shape[0]))
    out = []
    for gb in torch.split(groupings, perm_block):
        e = onehot_perm_factors(gb, inv_group_sizes, mat2_rows.dtype)
        p, _, g = e.shape
        y = _rows_matmul(mat2_rows, e.permute(1, 0, 2).reshape(n, p * g))
        e_rows = e[:, row_offset:row_offset + n_local]
        out.append(0.5 * (y.view(n_local, p, g)
                          * e_rows.permute(1, 0, 2)).sum(dim=(0, 2)))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Design-basis (hat-matrix) contraction: per-column quadratic forms.
#
# The design subsystem (core.design) generalizes the one-hot factor E to an
# orthonormal basis V of a model's column space: SS_resid = 1/2 <mat2, V V'>
# = sum_k 1/2 v_k' mat2 v_k, and per-term partial SS are (minus) sums of
# the same forms over each term's columns. The dataflow is sw_matmul's with
# the per-column sums kept apart. These are plain matrix products (outside
# any kernel in the reference too); on the card they run in full f32.
# ---------------------------------------------------------------------------

def basis_perm_factors(basis: torch.Tensor, perms: torch.Tensor
                       ) -> torch.Tensor:
    """V[p] = basis[perms[p], :], the (P, n, K) row-permuted basis that
    replaces the one-hot E (permuting basis rows is vegan's
    permute-the-observations convention). int32 indices gather as they
    are: no (P, n) int64 copy beside the basis."""
    p, n = perms.shape
    return basis.index_select(0, perms.reshape(-1)).view(p, n,
                                                         basis.shape[1])


def sw_cols_contract(mat2_rows: torch.Tensor, v: torch.Tensor,
                     v_rows: torch.Tensor) -> torch.Tensor:
    """Per-column quadratic forms over a block of mat2 rows, (P, K):

        s[p, k] = 1/2 * sum_i (M2_rows @ V[p])[i, k] * V_rows[p, i, k]

    v: (P, n, K) permuted basis over ALL samples; v_rows: (P, n_local, K)
    rows aligned with mat2_rows (v itself for the full matrix). Partials
    over disjoint row blocks sum to the full statistic. Each permutation's
    (n, K) block is contracted on its own: one (n_local, n P K) product's
    BLAS blocking changes with P, and with it a permutation's sums, so a
    chunk of 7 and one of 40 would not give the same null."""
    return torch.stack([0.5 * ((mat2_rows @ vp) * vr).sum(dim=0)
                        for vp, vr in zip(v, v_rows)])


def sw_cols_block(mat2: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(P, K) per-column statistic for one block of permuted bases."""
    return sw_cols_contract(mat2, v, v)


def sw_cols_matmul(mat2: torch.Tensor, vperms: torch.Tensor, *,
                   perm_block: int = 64) -> torch.Tensor:
    """Per-column statistic over all permutations, matmul form,
    perm_block permutations per product. (P, K)."""
    perm_block = max(1, min(perm_block, vperms.shape[0]))
    return torch.cat([sw_cols_block(mat2, vb)
                      for vb in torch.split(vperms, perm_block)])


def sw_cols_brute(mat2: torch.Tensor, vperms: torch.Tensor, *,
                  block: int = 16) -> torch.Tensor:
    """Per-column statistic, brute dataflow: every permutation streams
    mat2 again (1/2 v_k' mat2 v_k one permutation at a time; `block` is
    the reference's batching knob and leaves the result unchanged). The
    dense-design analogue of Algorithm 3. (P, K)."""
    del block
    return torch.stack([0.5 * ((mat2 @ v) * v).sum(dim=0) for v in vperms])


def sw_cols_rows_partial(mat2_rows: torch.Tensor, row_offset: int,
                         vperms: torch.Tensor) -> torch.Tensor:
    """(P, K) row-slab partial of the per-column contraction: each
    permutation's basis (n, K) against the slab's rows, the rows' own
    basis rows weighting; the partials of disjoint slabs sum to the full
    (P, K). Each product as _rows_matmul takes it."""
    n_local = mat2_rows.shape[0]
    return torch.stack([
        0.5 * (_rows_matmul(mat2_rows, v)
               * v[row_offset:row_offset + n_local]).sum(dim=0)
        for v in vperms])


# ---------------------------------------------------------------------------
# Block-sparse basis contraction: strata-indicator bases are block-sparse
# and strata-restricted permutations keep each row inside its stratum, so a
# column's row support is a host-side constant of the design: gather the
# supported rows once and skip the all-zero rest.
# ---------------------------------------------------------------------------

def sparse_col_groups(basis, strata):
    """Group basis columns by permutation-invariant row support.

    Returns ((cols, rows), ...): `cols` are column indices sharing one
    support set, `rows` the sorted sample indices whose stratum appears
    in any of those columns' nonzeros. The groups partition the columns.
    Host-side (numpy), once per design."""
    def host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))
    b = host(basis)
    s = host(strata)
    by_support: dict = {}
    for k in range(b.shape[1]):
        nz = np.flatnonzero(b[:, k] != 0)
        sup = frozenset(np.unique(s[nz]).tolist())
        by_support.setdefault(sup, []).append(k)
    groups = []
    for sup, cols in sorted(by_support.items(), key=lambda t: t[1][0]):
        rows = np.flatnonzero(np.isin(s, sorted(sup)))
        groups.append((tuple(cols), tuple(int(r) for r in rows)))
    return tuple(groups)


def sw_cols_contract_sparse(mat2_rows: torch.Tensor, v: torch.Tensor,
                            v_rows: torch.Tensor, groups) -> torch.Tensor:
    """Block-sparse sw_cols_contract: each column group is contracted
    against only its supported sample columns of mat2_rows. Every skipped
    term has v[p, j, k] == 0 exactly, so this equals the dense
    contraction up to the order of its sums; one group spanning all rows
    is the dense contraction."""
    p, n, k = v.shape
    if len(groups) == 1 and len(groups[0][1]) == n:
        return sw_cols_contract(mat2_rows, v, v_rows)
    out = torch.zeros((p, k), dtype=mat2_rows.dtype, device=mat2_rows.device)
    for cols, rows in groups:
        cols_t = torch.tensor(cols, dtype=torch.long, device=v.device)
        rows_t = torch.tensor(rows, dtype=torch.long, device=v.device)
        out[:, cols_t] = sw_cols_contract(mat2_rows[:, rows_t],
                                          v[:, rows_t][:, :, cols_t],
                                          v_rows[:, :, cols_t])
    return out
