"""Grouped-query attention: training/prefill (chunked over queries),
single-token decode against a KV cache, and whisper's cross attention
(twin of `repro/models/attention.py`).

The reference's plain form, kept as it is: einsums with an fp32 softmax
over repeated k/v heads, the decode step attending over the whole
`S_max`-long cache with a mask. No fused attention library stands in for
it; a faster form is later work, measured against a benchmark.

Layouts:
  q:       (B, S, H, Dh)
  k, v:    (B, S, KVH, Dh)
  cache:   (B, Smax, KVH*Dh)

The decode forms take `cache_len` as a Python int (or a 0-d integer
tensor). The cache writes (`decode_attention`, `seed_cache`,
`blocks.write_cache_column`) write the given cache in place and return
it; a start past the end is clamped so the update fits, as
`jax.lax.dynamic_update_slice` clamps it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import nn, rope
from repro_torch.sharding import shard_activation

NEG_INF = -1e30


def attention_spec(cfg, dtype):
    d = cfg.d_model
    h = cfg.n_heads * cfg.d_head
    kvh = cfg.n_kv_heads * cfg.d_head
    return {
        "wq": nn.dense_spec(d, h, "embed", "heads", bias=cfg.qkv_bias,
                            dtype=dtype),
        "wk": nn.dense_spec(d, kvh, "embed", "kv", bias=cfg.qkv_bias,
                            dtype=dtype),
        "wv": nn.dense_spec(d, kvh, "embed", "kv", bias=cfg.qkv_bias,
                            dtype=dtype),
        "wo": nn.dense_spec(h, d, "heads", "embed", bias=cfg.out_bias,
                            dtype=dtype, init="fanin_deep",
                            scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }


def _project_qkv(params, cfg, x, positions):
    b, s, _ = x.shape
    q = nn.dense(params["wq"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = nn.dense(params["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = nn.dense(params["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope_fraction > 0:
        q = rope.apply_rope(q, positions, theta=cfg.rope_theta,
                            fraction=cfg.rope_fraction)
        k = rope.apply_rope(k, positions, theta=cfg.rope_theta,
                            fraction=cfg.rope_fraction)
    return q, k, v


def _repeat_kv(k, n_heads):
    """(B,S,KVH,Dh) -> (B,S,H,Dh) repeating each kv head onto its group."""
    b, s, kvh, dh = k.shape
    rep = k[:, :, :, None, :].expand(b, s, kvh, n_heads // kvh, dh)
    return rep.reshape(b, s, n_heads, dh)


def _attend_block(q, k, v, mask, softmax_scale):
    """One (q-chunk x full-kv) attention with fp32 softmax.

    q: (B,Sq,H,Dh)  k,v: (B,Sk,H,Dh) (kv pre-repeated)  mask broadcastable
    to (B,H,Sq,Sk) or None.
    """
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    logits = logits * softmax_scale
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def full_attention(params, cfg, x, positions, *, causal=True,
                   q_chunk: int = 1024):
    """Training / prefill attention, a Python loop over query chunks.

    Peak score memory = q_chunk * S per (batch, head) instead of S^2; an
    irregular length (S not a multiple of q_chunk) takes the whole
    sequence at once, as the reference does. Returns (out, (k, v)) so
    prefill can seed the decode cache.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    q = shard_activation(q, ("batch", None, "heads", None))
    k_rep = shard_activation(_repeat_kv(k, cfg.n_heads),
                             ("batch", None, "heads", None))
    v_rep = shard_activation(_repeat_kv(v, cfg.n_heads),
                             ("batch", None, "heads", None))
    scale = cfg.d_head ** -0.5

    q_chunk = min(q_chunk, s)
    if s % q_chunk != 0:
        q_chunk = s
    kv_pos = torch.arange(s, device=x.device)
    outs = []
    for lo in range(0, s, q_chunk):
        q_pos = lo + torch.arange(q_chunk, device=x.device)
        m = (kv_pos[None, :] <= q_pos[:, None])[None, None] if causal \
            else None
        outs.append(_attend_block(q[:, lo:lo + q_chunk], k_rep, v_rep, m,
                                  scale))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head)
    out = shard_activation(out, ("batch", None, "heads"))
    return nn.dense(params["wo"], out), (k, v)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCacheSpec:
    batch: int
    max_len: int
    n_kv_heads: int
    d_head: int
    dtype: torch.dtype = torch.bfloat16

    @property
    def shape(self) -> tuple:
        """One layer's k (or v) cache: (B, Smax, KVH*Dh)."""
        return (self.batch, self.max_len, self.n_kv_heads * self.d_head)


def update_start(start, length: int, size: int) -> int:
    """Where a `length`-long update lands in a dimension of `size`: the
    start clamped to [0, size - length], as dynamic_update_slice does."""
    return min(max(int(start), 0), size - length)


def _positions_at(b, cache_len, device):
    return torch.full((b, 1), int(cache_len), dtype=torch.int32,
                      device=device)


def _cache_heads(c, cfg, dtype):
    """(B, Smax, KVH*Dh) cache -> (B, Smax, H, Dh) repeated heads in
    `dtype`."""
    b, s_max, _ = c.shape
    return _repeat_kv(c.reshape(b, s_max, cfg.n_kv_heads, cfg.d_head)
                      .to(dtype), cfg.n_heads)


def decode_attention_readonly(params, cfg, x, cache, cache_len):
    """One-token decode WITHOUT writing the cache.

    Attends over cache positions [0, cache_len) plus the current token's
    own k/v, and returns (out, k_new, v_new) so the caller writes ONE new
    column per step across all layers (`blocks.write_cache_column`).
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, cfg, x,
                                   _positions_at(b, cache_len, x.device))
    s_max = cache["k"].shape[1]
    k = _cache_heads(cache["k"], cfg, x.dtype)
    v = _cache_heads(cache["v"], cfg, x.dtype)
    scale = cfg.d_head ** -0.5

    qk = q.to(k.dtype)
    logits_c = torch.einsum("bqhd,bshd->bhqs", qk, k).float() * scale
    valid = (torch.arange(s_max, device=x.device)
             < int(cache_len))[None, None, None, :]
    logits_c = torch.where(valid, logits_c, NEG_INF)
    kn = k_new.to(k.dtype).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    vn = v_new.to(v.dtype).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    kn_r = _repeat_kv(kn, cfg.n_heads)
    vn_r = _repeat_kv(vn, cfg.n_heads)
    logit_self = torch.einsum("bqhd,bshd->bhqs", qk, kn_r).float() * scale
    logits = torch.cat([logits_c, logit_self], dim=-1)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs[..., :-1], v) \
        + torch.einsum("bhqs,bshd->bqhd", probs[..., -1:], vn_r)
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
    y = nn.dense(params["wo"], out)
    return y, kn.reshape(b, 1, -1), vn.reshape(b, 1, -1)


def decode_attention(params, cfg, x, cache, cache_len):
    """One-token decode: x (B, 1, D); cache k/v (B, Smax, KVH*Dh).

    Writes the new k/v at column cache_len of the cache (in place) and
    attends over [0, cache_len]. Returns (out (B,1,D), the cache).
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, cfg, x,
                                   _positions_at(b, cache_len, x.device))
    flat = cfg.n_kv_heads * cfg.d_head
    s_max = cache["k"].shape[1]
    col = update_start(cache_len, 1, s_max)
    for name, new in (("k", k_new), ("v", v_new)):
        nn.write_slice(cache[name], 1, col,
                       nn.cast(new.reshape(b, 1, flat), cache[name].dtype))
    # cache layout: sequence-sharded over 'model' (matches launch/cells
    # decode sharding): partial attention + reduce, no cache gathers
    k_cache = shard_activation(cache["k"], ("batch", "kv_seq", None))
    v_cache = shard_activation(cache["v"], ("batch", "kv_seq", None))

    k = _cache_heads(k_cache, cfg, x.dtype)
    v = _cache_heads(v_cache, cfg, x.dtype)
    valid = (torch.arange(s_max, device=x.device)
             <= int(cache_len))[None, None, None, :]
    out = _attend_block(q.to(k.dtype), k, v, valid, cfg.d_head ** -0.5)
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
    return nn.dense(params["wo"], out), cache


def cross_attention(params, cfg, x, enc_out=None, kv_flat=None):
    """Encoder-decoder cross attention (whisper): no positional rotation,
    no mask. Either enc_out (B,Se,D), whose k/v are projected here, or
    precomputed flattened kv_flat {'k','v'}: (B,Se,KVH*Dh)."""
    b, s, _ = x.shape
    q = nn.dense(params["wq"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    if kv_flat is None:
        se = enc_out.shape[1]
        k = nn.dense(params["wk"], enc_out).reshape(
            b, se, cfg.n_kv_heads, cfg.d_head)
        v = nn.dense(params["wv"], enc_out).reshape(
            b, se, cfg.n_kv_heads, cfg.d_head)
    else:
        se = kv_flat["k"].shape[1]
        k = kv_flat["k"].reshape(b, se, cfg.n_kv_heads,
                                 cfg.d_head).to(x.dtype)
        v = kv_flat["v"].reshape(b, se, cfg.n_kv_heads,
                                 cfg.d_head).to(x.dtype)
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    out = _attend_block(q.to(k.dtype), k, v, None, cfg.d_head ** -0.5)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head).to(x.dtype)
    return nn.dense(params["wo"], out)


def cross_kv(params, cfg, enc_out):
    """Precomputed flattened cross-attention K/V of the encoder output:
    {'k', 'v'}: (B, Se, KVH*Dh)."""
    b, se, _ = enc_out.shape
    flat = cfg.n_kv_heads * cfg.d_head
    return {"k": nn.dense(params["wk"], enc_out).reshape(b, se, flat),
            "v": nn.dense(params["wv"], enc_out).reshape(b, se, flat)}


def seed_cache(cache, k, v, *, start: int = 0):
    """Write prefill k/v (B,S,KVH,Dh) into a decode cache at position start
    (in place); returns the cache."""
    b, s, kvh, dh = k.shape
    lo = update_start(start, s, cache["k"].shape[1])
    for name, new in (("k", k), ("v", v)):
        nn.write_slice(cache[name], 1, lo, nn.cast(
            new.reshape(b, s, kvh * dh), cache[name].dtype))
    return cache
