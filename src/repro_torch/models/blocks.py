"""Transformer-family blocks and their layer stacks (twin of
`repro/models/blocks.py`): the dense / MoE decoder block, the whisper
encoder and enc-dec blocks, the mamba2 block (zamba2) and the mLSTM /
sLSTM blocks (xLSTM).

The reference scans stacked params with `jax.lax.scan`; the port holds one
params module per layer and loops over them in Python, so the decode
stacks take no `unroll` knob (the configs keep the field as data). A
segmented stack (zamba2, xLSTM) is a list of such lists. Every stack
the reference wraps in its remat policy checkpoints each layer while
gradients are recorded (`_maybe_remat`): "full" (`jax.checkpoint`)
recomputes the whole layer in the backward pass, "dots"
(`dots_with_no_batch_dims_saveable`) keeps the outputs of the weight
products (`aten.mm` / `aten.addmm`) and recomputes the rest. Remat
changes memory, never the bits. The reference's activation sharding
constraints sit at its sites (`repro_torch.sharding.shard_activation`):
the identity without an active mesh.

The KV caches of the attention blocks are written in place; a recurrent
block's decode returns new state tensors (their dtype follows the
reference's promotions, which can differ between a prefilled state and
one from `init_caches`), and the stacks stack them over layers.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention, mlp, moe, nn, ssm, xlstm
from repro_torch.sharding import shard_activation


def _norm(cfg):
    if cfg.norm == "layernorm":
        return nn.layernorm_spec, nn.layernorm
    return nn.rmsnorm_spec, nn.rmsnorm


def _ffn(params, cfg, y):
    """(the block's FFN of y, the MoE balance loss or None)."""
    if cfg.family == "moe":
        return moe.moe_ffn(params["ffn"], cfg, y)
    if cfg.act == "gelu":
        return mlp.gelu_mlp(params["ffn"], y), None
    return mlp.swiglu(params["ffn"], y), None


# ---------------------------------------------------------------------------
# Dense / MoE decoder block
# ---------------------------------------------------------------------------

def decoder_block_spec(cfg, dtype):
    norm_spec, _ = _norm(cfg)
    spec = {
        "ln1": norm_spec(cfg.d_model, dtype=dtype),
        "attn": attention.attention_spec(cfg, dtype),
        "ln2": norm_spec(cfg.d_model, dtype=dtype),
    }
    if cfg.family == "moe":
        spec["ffn"] = moe.moe_spec(cfg, dtype)
    elif cfg.act == "gelu":
        spec["ffn"] = mlp.gelu_mlp_spec(cfg.d_model, cfg.d_ff, cfg.n_layers,
                                        dtype, bias=cfg.out_bias)
    else:
        spec["ffn"] = mlp.swiglu_spec(cfg.d_model, cfg.d_ff, cfg.n_layers,
                                      dtype)
    return spec


def decoder_block(params, cfg, x, positions, *, causal=True,
                  q_chunk=1024):
    """Returns (x, aux, (k, v)); aux is the MoE balance loss (0, dense).
    Under an active mesh the residual stream is sequence-sharded over
    'model' around the attention and the FFN (`shard_activation`)."""
    _, norm_fn = _norm(cfg)
    x = shard_activation(x, ("batch", "act_seq", None))
    h, (k, v) = attention.full_attention(
        params["attn"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        positions, causal=causal, q_chunk=q_chunk)
    h = shard_activation(h, ("batch", "act_seq", None))
    x = x + h
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    f, aux = _ffn(params, cfg, y)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    f = shard_activation(f, ("batch", "act_seq", None))
    return x + f, aux, (k, v)


def decoder_block_decode(params, cfg, x, cache, cache_len):
    _, norm_fn = _norm(cfg)
    h, cache = attention.decode_attention(
        params["attn"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        cache, cache_len)
    x = x + h
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    return x + _ffn(params, cfg, y)[0], cache


def decoder_block_decode_readonly(params, cfg, x, cache, cache_len):
    """Decode block that does NOT write the cache; returns (x, k_new,
    v_new) for a single cache update at the end of the step."""
    _, norm_fn = _norm(cfg)
    h, k_new, v_new = attention.decode_attention_readonly(
        params["attn"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        cache, cache_len)
    x = x + h
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    return x + _ffn(params, cfg, y)[0], k_new, v_new


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


def _remat(fn, policy: Optional[str]):
    """`fn` under the remat policy while gradients are recorded; as it is
    otherwise (serving records none)."""
    return _maybe_remat(fn, policy) if torch.is_grad_enabled() else fn


def stack_forward(layers: Sequence, cfg, x, positions, *, causal=True,
                  q_chunk=1024, remat: Optional[str] = "dots",
                  collect_kv=False):
    """Run the decoder stack. Returns (x, aux_sum, (k, v) stacked over
    layers as (L, B, S, KVH, Dh), or None). `remat` applies only while
    gradients are recorded."""
    def body(layer, x):
        return decoder_block(layer, cfg, x, positions, causal=causal,
                             q_chunk=q_chunk)

    body = _remat(body, remat)
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
        nn.write_slice(caches[name], 2, col,
                       nn.cast(new, caches[name].dtype))
    return caches


# ---------------------------------------------------------------------------
# Encoder block (whisper encoder: bidirectional, pre-LN)
# ---------------------------------------------------------------------------

def encoder_block_spec(cfg, dtype):
    norm_spec, _ = _norm(cfg)
    return {
        "ln1": norm_spec(cfg.d_model, dtype=dtype),
        "attn": attention.attention_spec(cfg, dtype),
        "ln2": norm_spec(cfg.d_model, dtype=dtype),
        "ffn": mlp.gelu_mlp_spec(cfg.d_model, cfg.d_ff, cfg.enc_layers,
                                 dtype, bias=cfg.out_bias),
    }


def encoder_block(params, cfg, x, positions, *, q_chunk=1024):
    _, norm_fn = _norm(cfg)
    h, _ = attention.full_attention(
        params["attn"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        positions, causal=False, q_chunk=q_chunk)
    x = x + h
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    return x + mlp.gelu_mlp(params["ffn"], y)


def encoder_stack(layers: Sequence, cfg, x, positions, *, q_chunk=1024,
                  remat="dots"):
    def body(layer, x):
        return encoder_block(layer, cfg, x, positions, q_chunk=q_chunk)

    body = _remat(body, remat)
    for layer in layers:
        x = body(layer, x)
    return x


# ---------------------------------------------------------------------------
# Enc-dec decoder block (self-attn + cross-attn + FFN)
# ---------------------------------------------------------------------------

def encdec_block_spec(cfg, dtype):
    norm_spec, _ = _norm(cfg)
    return {
        "ln1": norm_spec(cfg.d_model, dtype=dtype),
        "self": attention.attention_spec(cfg, dtype),
        "lnx": norm_spec(cfg.d_model, dtype=dtype),
        "cross": attention.attention_spec(cfg, dtype),
        "ln2": norm_spec(cfg.d_model, dtype=dtype),
        "ffn": mlp.gelu_mlp_spec(cfg.d_model, cfg.d_ff, cfg.n_layers, dtype,
                                 bias=cfg.out_bias),
    }


def encdec_block(params, cfg, x, enc_out, positions, *, q_chunk=1024):
    """Returns (x, (k, v)) of the self attention."""
    _, norm_fn = _norm(cfg)
    h, kv = attention.full_attention(
        params["self"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        positions, causal=True, q_chunk=q_chunk)
    x = x + h
    x = x + attention.cross_attention(
        params["cross"], cfg, norm_fn(params["lnx"], x, eps=cfg.norm_eps),
        enc_out=enc_out)
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    return x + mlp.gelu_mlp(params["ffn"], y), kv


def encdec_stack(layers: Sequence, cfg, x, enc_out, positions, *,
                 q_chunk=1024, remat="dots", collect_kv=False):
    """Returns (x, (k, v) stacked over layers as (L, B, S, KVH, Dh), or
    None)."""
    def body(layer, x):
        return encdec_block(layer, cfg, x, enc_out, positions,
                            q_chunk=q_chunk)

    body = _remat(body, remat)
    ks, vs = [], []
    for layer in layers:
        x, (k, v) = body(layer, x)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def encdec_block_decode(params, cfg, x, self_cache, cross_kv, cache_len):
    _, norm_fn = _norm(cfg)
    h, self_cache = attention.decode_attention(
        params["self"], cfg, norm_fn(params["ln1"], x, eps=cfg.norm_eps),
        self_cache, cache_len)
    x = x + h
    x = x + attention.cross_attention(
        params["cross"], cfg, norm_fn(params["lnx"], x, eps=cfg.norm_eps),
        kv_flat=cross_kv)
    y = norm_fn(params["ln2"], x, eps=cfg.norm_eps)
    return x + mlp.gelu_mlp(params["ffn"], y), self_cache


@torch.no_grad()
def encdec_stack_decode(layers: Sequence, cfg, x, self_caches, cross_kvs,
                        cache_len):
    """Decode across layers; the self caches {'k': (L,B,S,KV), 'v'} have
    each layer's column written in place. Returns (x, self_caches)."""
    for l, layer in enumerate(layers):
        x, _ = encdec_block_decode(layer, cfg, x,
                                   _layer_cache(self_caches, l),
                                   _layer_cache(cross_kvs, l), cache_len)
    return x, self_caches


# ---------------------------------------------------------------------------
# Recurrent states stacked over layers
# ---------------------------------------------------------------------------

def state_at(states, i):
    """Layer (or segment) i's state of a dict of stacked states (views)."""
    return {k: v[i] for k, v in states.items()}


def stack_states(states: Sequence) -> dict:
    """A list of per-layer state dicts as one dict of stacked tensors."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# ---------------------------------------------------------------------------

def mamba_block_spec(cfg, dtype):
    norm_spec, _ = _norm(cfg)
    return {
        "ln": norm_spec(cfg.d_model, dtype=dtype),
        "mixer": ssm.mamba2_spec(cfg, dtype),
    }


def mamba_block(params, cfg, x, *, chunk=128, state=None):
    _, norm_fn = _norm(cfg)
    y, new_state = ssm.mamba2_forward(
        params["mixer"], cfg, norm_fn(params["ln"], x, eps=cfg.norm_eps),
        chunk=chunk, state=state)
    return x + y, new_state


def mamba_block_decode(params, cfg, x, state):
    _, norm_fn = _norm(cfg)
    y, new_state = ssm.mamba2_decode(
        params["mixer"], cfg, norm_fn(params["ln"], x, eps=cfg.norm_eps),
        state)
    return x + y, new_state


def mamba_stack(layers: Sequence, cfg, x, *, chunk=128, remat="dots"):
    def body(layer, x):
        return mamba_block(layer, cfg, x, chunk=chunk)[0]

    body = _remat(body, remat)
    for layer in layers:
        x = body(layer, x)
    return x


@torch.no_grad()
def mamba_stack_decode(layers: Sequence, cfg, x, states):
    """states {'conv': (L, B, K-1, C), 'ssm': (L, B, H, P, N)}; returns (x,
    the new states stacked)."""
    new = []
    for l, layer in enumerate(layers):
        x, st = mamba_block_decode(layer, cfg, x, state_at(states, l))
        new.append(st)
    return x, stack_states(new)


def mamba_stack_prefill(layers: Sequence, cfg, x, *, chunk=128,
                        remat="dots"):
    """The stack, collecting each layer's final (conv, ssm) state:
    returns (x, the states stacked over layers)."""
    def body(layer, x):
        return mamba_block(layer, cfg, x, chunk=chunk)

    body = _remat(body, remat)
    states = []
    for layer in layers:
        x, st = body(layer, x)
        states.append(st)
    return x, stack_states(states)


# ---------------------------------------------------------------------------
# xLSTM blocks (pre-norm residual wrappers)
# ---------------------------------------------------------------------------

def mlstm_block_spec(cfg, dtype):
    norm_spec, _ = _norm(cfg)
    return {"ln": norm_spec(cfg.d_model, dtype=dtype),
            "cell": xlstm.mlstm_spec(cfg, dtype)}


def mlstm_block(params, cfg, x, *, chunk=256):
    _, norm_fn = _norm(cfg)
    return x + xlstm.mlstm_forward(
        params["cell"], cfg, norm_fn(params["ln"], x, eps=cfg.norm_eps),
        chunk=chunk)


def mlstm_block_decode(params, cfg, x, state):
    _, norm_fn = _norm(cfg)
    y, state = xlstm.mlstm_decode(
        params["cell"], cfg, norm_fn(params["ln"], x, eps=cfg.norm_eps),
        state)
    return x + y, state


def slstm_block_spec(cfg, dtype):
    norm_spec, _ = _norm(cfg)
    return {"ln": norm_spec(cfg.d_model, dtype=dtype),
            "cell": xlstm.slstm_spec(cfg, dtype)}


def slstm_block(params, cfg, x, *, state=None):
    """Under an active mesh the time loop's input is gathered along the
    sequence once (`shard_activation`), as GSPMD gathers the reference's
    scan input: DTensor would gather the whole sequence for each step's
    slice and keep each gathered copy for the backward."""
    _, norm_fn = _norm(cfg)
    y = shard_activation(norm_fn(params["ln"], x, eps=cfg.norm_eps),
                         ("batch", None, "act_embed"))
    y, new_state = xlstm.slstm_forward(params["cell"], cfg, y, state=state)
    return x + y, new_state


def slstm_block_decode(params, cfg, x, state):
    _, norm_fn = _norm(cfg)
    y, state = xlstm.slstm_decode(
        params["cell"], cfg, norm_fn(params["ln"], x, eps=cfg.norm_eps),
        state)
    return x + y, state


def mlstm_stack(layers: Sequence, cfg, x, *, chunk=256, remat="dots"):
    def body(layer, x):
        return mlstm_block(layer, cfg, x, chunk=chunk)

    body = _remat(body, remat)
    for layer in layers:
        x = body(layer, x)
    return x


@torch.no_grad()
def mlstm_stack_decode(layers: Sequence, cfg, x, states):
    """states {'c', 'n', 'm', 'conv'} stacked over the layers; returns (x,
    the new states stacked)."""
    new = []
    for l, layer in enumerate(layers):
        x, st = mlstm_block_decode(layer, cfg, x, state_at(states, l))
        new.append(st)
    return x, stack_states(new)


def mlstm_stack_prefill(layers: Sequence, cfg, x, *, chunk=256,
                        remat="dots"):
    """The stack, collecting each layer's final (c, n, m, conv) state:
    returns (x, the states stacked over layers)."""
    _, norm_fn = _norm(cfg)

    def body(layer, x):
        y, st = xlstm.mlstm_forward(
            layer["cell"], cfg, norm_fn(layer["ln"], x, eps=cfg.norm_eps),
            chunk=chunk, return_state=True)
        return x + y, st

    body = _remat(body, remat)
    states = []
    for layer in layers:
        x, st = body(layer, x)
        states.append(st)
    return x, stack_states(states)
