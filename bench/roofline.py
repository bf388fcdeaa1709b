"""The least time one H100 needs for a test's permutation sweep.

Copied from the port's chip checks (`bound_ms`, `fused_bound_ms`,
`cols_bound_ms`) and counted for a whole sweep: every pair of samples
once, every input byte read once, the result the larger of the byte time
at the HBM rate and the operation time. The operations are those of the
function, not of a kernel's formulation, so a later kernel that computes
the same sweep is read by the same bound:

  s_W of P label permutations: a compare per (pair, permutation) and an
      add per pair that falls in one group, at the f32 CUDA-core rate
      (the one-hot product, 2 n^2 P G FLOP, needs more time at any
      tensor-core rate, so it is no bound);
  Bray-Curtis built in the sweep: 2 per (pair, feature) at the f32 rate;
  the per-column forms of a K-column design: 2 per (pair, permutation,
      column) at the dense TF32 rate, the rate of the tensor cores that
      already run that product.

Peaks are NVIDIA's H100 SXM datasheet values (dense) at the card's full
700 W; a share is reported beside the card's power limit.

The f32 rate counts an FMA as two operations, so a lone compare or add
counted at it runs at two a lane a clock. As instructions, an INT32
compare issues at 64 lanes a clock an SM and an FP32 add at 128: the
compare-and-add term is 2-4x below the floor of today's instruction mix,
and its shares read that much lower than against that floor. It stays at
the f32 rate so that it bounds any kernel of the same function, one that
packs several labels into an instruction among them.
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12


def pairs(n: int) -> float:
    return n * (n - 1) / 2.0


def matches(sizes: Sequence[int]) -> float:
    """Pairs within one group: fixed under label permutation."""
    return float(sum(s * (s - 1) / 2.0 for s in sizes))


def _bound(nbytes: float, f32_ops: float, tf32_ops: float = 0.0) -> float:
    t_ops = f32_ops / F32_FLOPS + tf32_ops / TF32_FLOPS
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def sw_labels_s(n: int, p: int, sizes: Sequence[int]) -> float:
    """s_W of p label permutations on a resident (n, n) f32 D^2: D^2, the
    (p, n) int32 labels, 1/n_g read once, p values written."""
    g = len(sizes)
    nbytes = 4.0 * (n * n + p * n + g + p)
    return _bound(nbytes, p * (pairs(n) + matches(sizes)))


def fused_labels_s(n: int, d: int, p: int, sizes: Sequence[int]) -> float:
    """s_W of p label permutations from the (n, d) f32 table, D^2 built in
    the sweep: the table, the labels, 1/n_g read once, p values written."""
    g = len(sizes)
    nbytes = 4.0 * (n * d + p * n + g + p)
    f32_ops = 2.0 * pairs(n) * d + p * (pairs(n) + matches(sizes))
    return _bound(nbytes, f32_ops)


def fused_cols_s(n: int, d: int, p: int, k: int) -> float:
    """The (p, k) per-column forms of a k-column basis from the (n, d)
    table: the table, the (p, n) int32 index permutations and the (n, k)
    basis read once, p k values written; the feature term at the f32 rate,
    the product at the TF32 rate."""
    nbytes = 4.0 * (n * d + p * n + n * k + p * k)
    return _bound(nbytes, 2.0 * pairs(n) * d, 2.0 * pairs(n) * p * k)
