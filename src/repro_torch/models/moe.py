"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch (twin of
`repro/models/moe.py`).

Covers both MoE architectures of the registry:
  grok-1-314b     8 experts, top-2, no shared experts, experts looped
  qwen2-moe-a2.7b 60 routed experts top-4 + shared experts (always-on)

Dispatch: tokens are routed top-k; each (token, choice) takes a slot in
its expert's capacity buffer by its rank among the assignments to that
expert, in (token, choice) order. Assignments past capacity are dropped
(combine weight 0), the GShard/Switch convention. The (T, E, C) dispatch
tensor is never built: token vectors are scattered into the (E, C, D)
buffer with one `index_put` (a dropped assignment adds a zero source at
slot C-1, as the reference's `.at[].add(mode="drop")`), so memory is
O(E C D + T D).

At decode T is the batch, so capacity is tiny (qwen2-moe: int(1.25 x 4
x 4 / 60) + 1 = 1 at batch 4) and tokens that collide on an expert are
dropped. That is the reference's behaviour, kept here.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import mlp, nn
from repro_torch.sharding import gather_weight, shard_activation


def moe_spec(cfg, dtype):
    e, d, f = cfg.moe_n_experts, cfg.d_model, cfg.moe_d_ff
    spec = {
        "router": nn.dense_spec(d, e, "embed", None, dtype=torch.float32),
        "w_gate": nn.ParamSpec((e, d, f), ("expert", "embed", "mlp"),
                               init="fanin", dtype=dtype),
        "w_up": nn.ParamSpec((e, d, f), ("expert", "embed", "mlp"),
                             init="fanin", dtype=dtype),
        "w_down": nn.ParamSpec((e, f, d), ("expert", "mlp", "embed"),
                               init="fanin", dtype=dtype,
                               scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }
    if cfg.moe_n_shared > 0:
        spec["shared"] = mlp.swiglu_spec(
            d, cfg.moe_d_ff * cfg.moe_n_shared, cfg.n_layers, dtype)
        spec["shared_gate"] = nn.dense_spec(d, 1, "embed", None,
                                            dtype=torch.float32)
    return spec


def _route(router_params, x2d, n_experts: int, top_k: int):
    """Router: (weights (T,k) f32, expert ids (T,k) int64, aux loss)."""
    logits = nn.dense(router_params, x2d.float())
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1, sorted=True)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    # Switch-style load-balancing auxiliary loss
    density = F.one_hot(ids[:, 0], n_experts).float().mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = torch.sum(density * density_proxy) * (n_experts ** 2) / n_experts
    return weights, ids, aux


def _dispatch_indices(ids, n_experts: int, capacity: int):
    """Slot of each (token, choice) within its expert's capacity buffer:
    its rank among all assignments to the same expert, in (token, choice)
    order; ranks >= capacity are dropped. A stable sort ranks them in
    O(T k log) time and O(T k) memory (never a (T k, E) one-hot cumsum).
    Returns (pos (T,k) int64, keep (T,k) bool)."""
    t, k = ids.shape
    flat = ids.reshape(-1)
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)          # group by expert
    # counted by a scatter: torch.bincount on the card reads the largest
    # id back to the host, a sync a layer
    counts = flat.new_zeros(n_experts).scatter_add_(
        0, flat, torch.ones_like(flat))
    offsets = torch.cumsum(counts, dim=0) - counts
    rank_sorted = torch.arange(n, device=ids.device) - offsets[flat[order]]
    pos = torch.empty_like(flat).scatter_(0, order, rank_sorted)
    keep = pos < capacity
    return pos.reshape(t, k), keep.reshape(t, k)


def moe_ffn(params, cfg, x: torch.Tensor):
    """(B, S, D) -> ((B, S, D), the load-balance aux loss).

    cfg.moe_token_chunks > 1 runs the whole dispatch + FFN per sequence
    chunk (a Python loop where the reference scans), when S divides: each
    chunk gets its own capacity, so chunking is exact up to where the
    drops fall.
    """
    nc = max(getattr(cfg, "moe_token_chunks", 1), 1)
    b, s, d = x.shape
    if nc > 1 and s % nc == 0:
        per = s // nc
        ys, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(nc):
            yc, a = _moe_ffn_flat(params, cfg, x[:, i * per:(i + 1) * per])
            ys.append(yc)
            aux = aux + a
        return torch.cat(ys, dim=1), aux / nc
    return _moe_ffn_flat(params, cfg, x)


def _one_expert(wg, wu, wd, be):
    ge = shard_activation(be @ wg, ("moe_capacity", "mlp"))
    ue = shard_activation(be @ wu, ("moe_capacity", "mlp"))
    he = shard_activation(F.silu(ge) * ue, ("moe_capacity", "mlp"))
    return he @ wd


def _experts(params, cfg, buf):
    """The per-expert SwiGLU on the (E, C, D) buffer. With
    moe_scan_experts (grok-1) one expert at a time, each recomputed in
    the backward pass while gradients are recorded (the reference's
    jax.checkpoint inside its scan)."""
    if cfg.moe_scan_experts:
        fn = _one_expert
        if torch.is_grad_enabled():
            fn = functools.partial(checkpoint, _one_expert,
                                   use_reentrant=False)
        return torch.stack([fn(gather_weight(params["w_gate"][e]),
                               gather_weight(params["w_up"][e]),
                               gather_weight(params["w_down"][e]), buf[e])
                            for e in range(buf.shape[0])])
    g = torch.einsum("ecd,edf->ecf", buf, gather_weight(params["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", buf, gather_weight(params["w_up"]))
    h = shard_activation(F.silu(g) * u, ("expert", "moe_capacity", "mlp"))
    return torch.einsum("ecf,efd->ecd", h, gather_weight(params["w_down"]))


def _moe_ffn_flat(params, cfg, x: torch.Tensor):
    b, s, d = x.shape
    t = b * s
    e, k = cfg.moe_n_experts, cfg.moe_top_k
    capacity = int(cfg.moe_capacity_factor * t * k / e) + 1
    # explicit token-dim sharding under a mesh (the reference's
    # constraint: merging (batch, seq) loses tuple-axis sharding)
    x2d = shard_activation(x.reshape(t, d), ("moe_capacity", None))

    weights, ids, aux = _route(params["router"], x2d, e, k)
    pos, keep = _dispatch_indices(ids, e, capacity)
    weights = weights * keep.to(weights.dtype)

    # scatter tokens into (E, C, D) expert buffers; a dropped assignment
    # adds a zero source at slot C-1
    keep_f = keep.reshape(-1)
    tok_idx = torch.arange(t, device=x.device)[:, None].expand(t, k) \
        .reshape(-1)
    e_idx = ids.reshape(-1)
    c_idx = torch.where(keep_f, pos.reshape(-1), capacity - 1)
    src = torch.where(keep_f[:, None], x2d[tok_idx], x2d.new_zeros(()))
    src = shard_activation(src, ("moe_capacity", None))
    buf = x.new_zeros((e, capacity, d)).index_put(
        (e_idx, c_idx), src, accumulate=True)
    buf = shard_activation(buf, ("expert", "moe_capacity", None))

    y_buf = shard_activation(_experts(params, cfg, buf),
                             ("expert", "moe_capacity", None))

    # combine: gather each (token, choice) slot back, weight, sum over k
    y_tk = shard_activation(y_buf[e_idx, c_idx], ("moe_capacity", None))
    y_tk = y_tk * weights.reshape(-1)[:, None].to(y_buf.dtype)
    y = y_tk.reshape(t, k, d).sum(dim=1)

    if "shared" in params:
        gate = torch.sigmoid(nn.dense(params["shared_gate"], x2d.float()))
        y = y + mlp.swiglu(params["shared"], x2d) * gate.to(y.dtype)
    return y.reshape(b, s, d), aux
