"""Dense decoder blocks and their layer stacks (twin of the dense part of
`repro/models/blocks.py`).

The reference scans stacked params with `jax.lax.scan`; the port holds one
params module per layer and loops over them in Python, so the decode
stacks take no `unroll` knob (the configs keep the field as data).
`stack_forward`'s `remat` checkpoints each layer while gradients are
recorded: "full" (`jax.checkpoint`) recomputes the whole layer in the
backward pass, "dots" (`dots_with_no_batch_dims_saveable`) keeps the
outputs of the weight products (`aten.mm` / `aten.addmm`) and recomputes
the rest. Remat changes memory, never the bits. With no mesh the
reference's activation sharding constraints are the identity, so the port
has none. The MoE, mamba, xLSTM and encoder blocks come with the other
families.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention, mlp, nn


def _norm(cfg):
    if cfg.norm == "layernorm":
        return nn.layernorm_spec, nn.layernorm
    return nn.rmsnorm_spec, nn.rmsnorm


def _ffn(params, cfg, y):
    if cfg.act == "gelu":
        return mlp.gelu_mlp(params["ffn"], y)
    return mlp.swiglu(params["ffn"], y)


# ---------------------------------------------------------------------------
# Dense decoder block
# ---------------------------------------------------------------------------

def decoder_block_spec(cfg, dtype):
    if cfg.family == "moe":
        raise NotImplementedError(
            "MoE blocks are not ported yet: they come with the other "
            "families (LM scaffold slice (c))")
    norm_spec, _ = _norm(cfg)
    spec = {
        "ln1": norm_spec(cfg.d_model, dtype=dtype),
        "attn": attention.attention_spec(cfg, dtype),
        "ln2": norm_spec(cfg.d_model, dtype=dtype),
    }
    if cfg.act == "gelu":
        spec["ffn"] = mlp.gelu_mlp_spec(cfg.d_model, cfg.d_ff, cfg.n_layers,
                                        dtype, bias=cfg.out_bias)
    else:
        spec["ffn"] = mlp.swiglu_spec(cfg.d_model, cfg.d_ff, cfg.n_layers,
                                      dtype)
    return spec


def decoder_block(params, cfg, x, positions, *, causal=True,
                  q_chunk=1024):
    """Returns (x, aux, (k, v)); aux is the MoE balance loss (0, dense)."""
    _, norm_fn = _norm(cfg)
    h, (k, v) = attention.full_attention(
        params["attn"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        positions, causal=causal, q_chunk=q_chunk)
    x = x + h
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + _ffn(params, cfg, y), aux, (k, v)


def decoder_block_decode(params, cfg, x, cache, cache_len):
    _, norm_fn = _norm(cfg)
    h, cache = attention.decode_attention(
        params["attn"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        cache, cache_len)
    x = x + h
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    return x + _ffn(params, cfg, y), cache


def decoder_block_decode_readonly(params, cfg, x, cache, cache_len):
    """Decode block that does NOT write the cache; returns (x, k_new,
    v_new) for a single cache update at the end of the step."""
    _, norm_fn = _norm(cfg)
    h, k_new, v_new = attention.decode_attention_readonly(
        params["attn"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        cache, cache_len)
    x = x + h
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    return x + _ffn(params, cfg, y), k_new, v_new


# ---------------------------------------------------------------------------
# Layer stacks (a Python loop over the per-layer params)
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    # the weight products have no batch dims once matmul folds (B, S) into
    # rows; the attention's batched products (bmm) are recomputed
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, policy: Optional[str]):
    if policy is None or policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(policy)


def stack_forward(layers: Sequence, cfg, x, positions, *, causal=True,
                  q_chunk=1024, remat: Optional[str] = "dots",
                  collect_kv=False):
    """Run the decoder stack. Returns (x, aux_sum, (k, v) stacked over
    layers as (L, B, S, KVH, Dh), or None). `remat` applies only while
    gradients are recorded."""
    def body(layer, x):
        return decoder_block(layer, cfg, x, positions, causal=causal,
                             q_chunk=q_chunk)

    if torch.is_grad_enabled():
        body = _maybe_remat(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for layer in layers:
        x, a, (k, v) = body(layer, x)
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
                    else None)


def _layer_cache(caches, l):
    return {"k": caches["k"][l], "v": caches["v"][l]}


@torch.no_grad()
def stack_decode(layers: Sequence, cfg, x, caches, cache_len):
    """Decode across layers; caches {'k': (L,B,S,KV), 'v': ...}, each
    layer's column written in place. Returns (x, caches). The decode
    stacks are serving's: they record no gradient of the weights."""
    for l, layer in enumerate(layers):
        x, _ = decoder_block_decode(layer, cfg, x, _layer_cache(caches, l),
                                    cache_len)
    return x, caches


@torch.no_grad()
def stack_decode_readonly(layers: Sequence, cfg, x, caches, cache_len):
    """Decode across layers reading caches without writing them; returns
    (x, k_news, v_news), the per-layer new k/v stacked as (L, B, 1, KV)
    for one cache update by the caller."""
    k_news, v_news = [], []
    for l, layer in enumerate(layers):
        x, k_new, v_new = decoder_block_decode_readonly(
            layer, cfg, x, _layer_cache(caches, l), cache_len)
        k_news.append(k_new)
        v_news.append(v_new)
    return x, torch.stack(k_news), torch.stack(v_news)


def write_cache_column(caches, k_news, v_news, cache_len):
    """Insert the (L, B, 1, KV) new column at cache_len (in place, one
    write per cache tensor); returns the caches."""
    col = attention.update_start(cache_len, 1, caches["k"].shape[2])
    for name, new in (("k", k_news), ("v", v_news)):
        caches[name][:, :, col] = nn.cast(new[:, :, 0], caches[name].dtype)
    return caches
