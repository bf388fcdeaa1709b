"""Gradient compression for cross-pod data parallelism (twin of
`repro/optim/compression.py`).

int8 quantization with per-tensor scale and error-feedback residual
(Seide et al. / EF-SGD): the quantization error is fed back into the next
step's gradient, preserving convergence. An all-reduce of int8 gradients
moves 4x fewer bytes than fp32 (2x vs bf16).

`allreduce_compressed` takes a `torch.distributed` process group where
the reference takes a shard_map axis name: the integer sum is an int32
`all_reduce` (exact), the scales and the member count float32 sums, as
`psum` gives them. `torch.round` rounds half to even, as `jnp.round`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.utils.tree import flatten_up_to, tree_leaves, tree_map
from repro_torch.utils.tree import unflatten


class ErrorFeedbackState(NamedTuple):
    residual: dict    # tree of fp32 residuals, like grads


def compress_int8(x: torch.Tensor):
    """(int8 values, fp32 scale). Symmetric per-tensor quantization."""
    x32 = x.float()
    amax = torch.clamp(torch.max(torch.abs(x32)), min=1e-12)
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads))


def _per_leaf(one, grads, state: ErrorFeedbackState):
    results = [one(g, r) for g, r in zip(
        tree_leaves(grads), flatten_up_to(grads, state.residual))]
    return (unflatten(grads, [r[0] for r in results]),
            ErrorFeedbackState(residual=unflatten(
                grads, [r[1] for r in results])))


def error_feedback_compress(grads, state: ErrorFeedbackState):
    """Returns (quantized tree of (q, scale), new_state).

    decompress(quantized) + next-step residual == grads exactly in the
    infinite-step limit; per step the residual carries the rounding error.
    """
    def one(g, r):
        corrected = g.float() + r
        q, scale = compress_int8(corrected)
        back = decompress_int8(q, scale)
        return (q, scale), corrected - back

    return _per_leaf(one, grads, state)


def allreduce_compressed(grads, state: ErrorFeedbackState, group=None):
    """Compressed mean all-reduce over `group` (default: the world).

    Quantize -> int32 sum (exact) -> dequantize with the mean scale.
    Scales are sum-averaged; per-member scales with integer accumulation
    keep the sum exact in integer space. Every member calls it with the
    same tree.
    """
    def one(g, r):
        corrected = g.float() + r
        q, scale = compress_int8(corrected)
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        n = torch.ones((), dtype=torch.float32, device=g.device)
        dist.all_reduce(n, group=group)
        mean = total.float() * (scale_sum / n) / n
        back = decompress_int8(q, scale)
        return mean, corrected - back

    return _per_leaf(one, grads, state)
