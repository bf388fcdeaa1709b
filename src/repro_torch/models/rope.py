"""Rotary position embeddings (RoPE), with partial-rotary support (GLM4
applies RoPE to half the head dim) and configurable theta (twin of
`repro/models/rope.py`)."""

from __future__ import annotations

import torch


def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32,
                        device=device) / d_rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: broadcastable to (..., seq).

    cos and sin are cast to x's dtype before the products, as the
    reference does: a bf16 x rotates in bf16."""
    d_head = x.shape[-1]
    d_rot = int(d_head * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, device=x.device)       # (d_rot/2,)
    angles = positions[..., None, None].float() * freqs
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp], dim=-1)
