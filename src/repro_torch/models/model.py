"""Top-level language models for every architecture family (twin of
`repro/models/model.py`).

  DecoderLM  dense | moe | vlm   (vlm = dense + a precomputed vision
             prefix in front of the token embeddings)
  HybridLM   zamba2: mamba2 segments + one SHARED attention block
  XLSTMLM    interleaved mLSTM / sLSTM segments
  EncDecLM   whisper: encoder stack + cross-attending decoder

Interface (consumed by train/, serve/ and launch/):
  param_specs()                          -> spec tree (no allocation)
  Model(cfg, generator=, device=)        -> weights drawn from the specs
  init(generator)                        -> weights drawn anew, in place
  param_tree()                           -> the weights as a tree
  loss(batch)                            -> (scalar, metrics)
  init_caches(batch, max_len)            -> decode caches / states
  prefill(batch[, max_len])              -> (last_logits, caches)
  decode_step(token, caches, cache_len)  -> (logits, caches)

A model is a `torch.nn.Module` that holds its weights as trainable
Parameters, so the reference's explicit `params` argument is gone from
these calls: `loss` differentiates with respect to the module's own
weights, and training updates them in place. `prefill` and
`decode_step` run under `torch.inference_mode()`.

The param tree is the reference's with each stacked (L, ...) subtree a
list of per-layer trees (`STACK_DEPTH`): xLSTM's (n_seg, every-1, ...)
mLSTM stack is a list of lists. A leaf is drawn with the fan-in of the
reference's stacked leaf (`nn.init_params(stack=)`).

The LM head loss is chunked over the sequence (never the full (B, S, V)
logits at once).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.hw import resolve_device
from repro_torch.models import attention, blocks, nn, ssm, xlstm
from repro_torch.sharding import gather_weight, shard_activation
from repro_torch.utils.tree import tree_map

# stacked dims before a layer's leaves, by top-level key of a param tree
STACK_DEPTH = {"layers": 1, "mamba": 1, "mlstm": 2, "slstm": 1,
               "mlstm_tail": 1, "enc_layers": 1, "dec_layers": 1}


def _unembed_spec(cfg, dtype):
    return {"w": nn.ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                              init="fanin", dtype=dtype)}


def _final_norm_spec(cfg, dtype):
    return (nn.layernorm_spec if cfg.norm == "layernorm"
            else nn.rmsnorm_spec)(cfg.d_model, dtype=dtype)


def _norm_fn(cfg):
    return blocks._norm(cfg)[1]


def param_specs(cfg: ArchConfig) -> dict:
    """The model's spec tree, the reference's leaf for leaf (layers
    stacked (L, ...) as there), built without allocating anything."""
    return FAMILIES[cfg.family].specs(cfg)


def chunked_cross_entropy(x, targets, mask, w_unembed, *,
                          chunk: int = 1024):
    """Mean NLL over masked positions, over sequence chunks.

    x: (B,S,D) final hidden; targets: (B,S) int; mask: (B,S) float32.
    The logits of a chunk are the product in x's dtype, then float32.
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk != 0:
        chunk = s
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        logits = (x[:, lo:lo + chunk] @ gather_weight(w_unembed)).float()
        logits = shard_activation(logits, ("batch", None, "act_vocab"))
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets[:, lo:lo + chunk, None].long())[..., 0]
        mc = mask[:, lo:lo + chunk]
        tot = tot + torch.sum((logz - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def _positions(b, s, device=None):
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


def _logits_last(unembed, h_last):
    """(B,1,D) -> (B,1,V) f32 logits for decode/prefill outputs."""
    return (h_last @ gather_weight(unembed["w"])).float()


def _module(tree):
    """A param (sub)tree as modules: a dict is a `nn.Params`, a list of
    layers a ModuleList."""
    if isinstance(tree, list):
        return torch.nn.ModuleList(_module(t) for t in tree)
    return nn.Params(tree)


def _tree_of(m):
    """`_module` undone: the tree of a module's own Parameters."""
    if isinstance(m, torch.nn.ModuleList):
        return [_tree_of(c) for c in m]
    if isinstance(m, nn.Params):
        return m.tree()
    return m


def _draw_stack(one, dims, g, dev, depth_dims):
    """Nested lists over `dims` of one layer's tree drawn from `one`, each
    with the fan-in of the stacked leaf (`depth_dims` + its shape)."""
    if not dims:
        return nn.init_params(one, g, dev, stack=depth_dims)
    return [_draw_stack(one, dims[1:], g, dev, depth_dims)
            for _ in range(dims[0])]


def _ce_loss(h, batch, unembed):
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                          device=h.device)
    return chunked_cross_entropy(h, batch["targets"], mask, unembed["w"])


def _zeros(shape_dtype, dims, device):
    shape, dtype = shape_dtype
    return torch.zeros(tuple(dims) + tuple(shape), dtype=dtype,
                       device=device)


class BaseLM(torch.nn.Module):
    """Weights are drawn from the specs by the reference's init laws with
    `generator` (default: seed 0 on `device`), or taken from `params`:
    the param tree (`param_tree`'s layout: each stacked subtree a list of
    per-layer trees) as tensors on `device` in the config's dtype
    (`compat.lm_params_from_reference` builds it)."""

    families: tuple = ()

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", params: Optional[dict] = None):
        super().__init__()
        if cfg.family not in self.families:
            raise ValueError(f"{type(self).__name__} builds the "
                             f"{self.families} families, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = cfg.torch_dtype
        dev = resolve_device(device)
        if params is None:
            params = self._draw(
                generator or torch.Generator(device=dev).manual_seed(0), dev)
        self._param_keys = sorted(params)
        for k in self._param_keys:
            v = params[k]
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, torch.nn.Parameter(v))
            else:
                self.add_module(k, _module(v))

    @classmethod
    def specs(cls, cfg) -> dict:
        raise NotImplementedError

    def param_specs(self):
        return self.specs(self.cfg)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _draw(self, g: torch.Generator, dev) -> dict:
        """A param tree drawn from the specs with `g`, top-level keys in
        sorted order and a stack layer by layer (the dense model's order
        since it was ported)."""
        specs = self.param_specs()
        out = {}
        for k in sorted(specs):
            one, dims = nn.unstack_specs(specs[k], STACK_DEPTH.get(k, 0))
            out[k] = _draw_stack(one, dims, g, dev, dims)
        return out

    def param_axes(self) -> dict:
        """The logical axes of every weight, a tree of `param_tree`'s
        layout (a layer's leaf without the stacked dims' "layers")."""
        specs = self.param_specs()

        def axes(spec):
            return (spec.axes if nn.is_spec(spec)
                    else {k: axes(v) for k, v in spec.items()})

        def nest(tree, dims):
            return tree if not dims else [nest(tree, dims[1:])
                                          for _ in range(dims[0])]

        out = {}
        for k in self._param_keys:
            one, dims = nn.unstack_specs(specs[k], STACK_DEPTH.get(k, 0))
            out[k] = nest(axes(one), dims)
        return out

    def param_tree(self) -> dict:
        """The weights as the port's param tree, each leaf this module's
        own Parameter (not a copy)."""
        return {k: _tree_of(getattr(self, k)) for k in self._param_keys}

    @torch.no_grad()
    def load_params(self, params: dict) -> dict:
        """Copy a param tree (the `param_tree` layout) into the weights;
        a leaf that already is the weight is left alone. Returns
        `param_tree()`."""
        def put(mine, new):
            if new is not mine:
                mine.copy_(new)
        tree_map(put, self.param_tree(), params)
        return self.param_tree()

    def init(self, generator: torch.Generator) -> dict:
        """Draw the weights anew from `generator` (as the constructor
        draws them) into the module; returns `param_tree()`."""
        return self.load_params(self._draw(generator, self.device))

    def _final_norm(self, h):
        return _norm_fn(self.cfg)(self.final_norm, h, eps=self.cfg.norm_eps)

    def _embed_tokens(self, tokens):
        return nn.embed(self.embed, tokens).to(self.dtype)

    def _kv_zeros(self, n, batch, length):
        cfg = self.cfg
        spec = attention.KVCacheSpec(batch, length, cfg.n_kv_heads,
                                     cfg.d_head, dtype=cfg.torch_kv_dtype)
        # sequence-sharded over 'model' under a mesh, as the reference's
        # decode caches are (launch.cells)
        return {k: shard_activation(
            torch.zeros((n,) + spec.shape, dtype=spec.dtype,
                        device=self.device),
            ("layers", "batch", "kv_seq", None)) for k in ("k", "v")}

    def _kv_seeded(self, n, k, v, max_len):
        """Caches (n, B, max(S, max_len), KVH*Dh) holding the prefill's k/v
        (n, B, S, KVH, Dh) in their first S columns, cast as the cache."""
        _, b, s = k.shape[:3]
        caches = self._kv_zeros(n, b, max(s, max_len or 0))
        for name, new in (("k", k), ("v", v)):
            nn.write_slice(caches[name], 2, 0, nn.cast(
                new.reshape(n, b, s, -1), caches[name].dtype))
        return caches


# ---------------------------------------------------------------------------
# DecoderLM: dense | moe | vlm
# ---------------------------------------------------------------------------

class DecoderLM(BaseLM):
    """A decoder-only LM: embedding -> decoder blocks (dense or MoE FFN)
    -> final norm -> unembed; a vlm batch may carry 'vision_embeds' (B,
    n_vis, D), a prefix in front of the token embeddings."""

    families = ("dense", "moe", "vlm")

    @classmethod
    def specs(cls, cfg):
        dt = cfg.torch_dtype
        return {
            "embed": nn.embedding_spec(cfg.vocab, cfg.d_model, dtype=dt),
            "layers": nn.stack_specs(blocks.decoder_block_spec(cfg, dt),
                                     cfg.n_layers),
            "final_norm": _final_norm_spec(cfg, dt),
            "unembed": _unembed_spec(cfg, dt),
        }

    def _embed_input(self, batch):
        """(hidden (B, n_vis + S, D), number of vision tokens n_vis)."""
        h = self._embed_tokens(batch["tokens"])
        n_vis = 0
        if self.cfg.family == "vlm" and "vision_embeds" in batch:
            vis = batch["vision_embeds"].to(self.dtype)
            h = torch.cat([vis, h], dim=1)
            n_vis = vis.shape[1]
        return shard_activation(h, ("batch", None, "act_embed")), n_vis

    def _backbone(self, h, positions, collect_kv=False):
        cfg = self.cfg
        h, aux, kvs = blocks.stack_forward(
            self.layers, cfg, h, positions, causal=True,
            q_chunk=cfg.attn_q_chunk, remat=cfg.remat, collect_kv=collect_kv)
        return self._final_norm(h), aux, kvs

    # --- training ----------------------------------------------------------
    def loss(self, batch):
        """(loss, {'ce', 'aux'}) of a batch {'tokens', 'targets'[,
        'loss_mask', 'vision_embeds']} of tensors on the model's device:
        the masked mean NLL of the text positions plus 0.01 x the MoE
        balance loss (0 for dense)."""
        h, n_vis = self._embed_input(batch)
        b, s, _ = h.shape
        h, aux, _ = self._backbone(h, _positions(b, s, device=h.device))
        if n_vis:
            h = h[:, n_vis:, :]
        ce = _ce_loss(h, batch, self.unembed)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    # --- serving -----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int) -> dict:
        return self._kv_zeros(self.cfg.n_layers, batch, max_len)

    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None):
        h, _ = self._embed_input(batch)
        b, s, _ = h.shape
        h, _, (k, v) = self._backbone(h, _positions(b, s, device=h.device),
                                      collect_kv=True)
        caches = self._kv_seeded(self.cfg.n_layers, k, v, max_len)
        return _logits_last(self.unembed, h[:, -1:, :]), caches

    @torch.inference_mode()
    def decode_step(self, token, caches, cache_len):
        """One token (B, 1) at position cache_len: (logits (B, 1, V) f32,
        the caches with the new column written in place)."""
        cfg = self.cfg
        h = self._embed_tokens(token)
        h, k_news, v_news = blocks.stack_decode_readonly(
            self.layers, cfg, h, caches, cache_len)
        caches = blocks.write_cache_column(caches, k_news, v_news,
                                           cache_len)
        return _logits_last(self.unembed, self._final_norm(h)), caches


# ---------------------------------------------------------------------------
# HybridLM: zamba2 — mamba segments + a shared attention block
# ---------------------------------------------------------------------------

class HybridLM(BaseLM):
    """zamba2: `hybrid_shared_every` mamba2 layers, then the ONE shared
    attention block (the same weights at every invocation, its own KV
    cache each time), repeated; the remaining mamba layers form a tail."""

    families = ("hybrid",)

    @classmethod
    def specs(cls, cfg):
        dt = cfg.torch_dtype
        return {
            "embed": nn.embedding_spec(cfg.vocab, cfg.d_model, dtype=dt),
            "mamba": nn.stack_specs(blocks.mamba_block_spec(cfg, dt),
                                    cfg.n_layers),
            "shared_attn": blocks.decoder_block_spec(
                dataclasses.replace(cfg, family="dense"), dt),
            "final_norm": nn.rmsnorm_spec(cfg.d_model, dtype=dt),
            "unembed": _unembed_spec(cfg, dt),
        }

    def _segments(self):
        seg = self.cfg.hybrid_shared_every
        q, r = divmod(self.cfg.n_layers, seg)
        return seg, q, r

    def n_shared_invocations(self):
        return self._segments()[1]

    def _final_norm(self, h):
        return nn.rmsnorm(self.final_norm, h, eps=self.cfg.norm_eps)

    def _forward(self, h, positions):
        cfg = self.cfg
        dense_cfg = dataclasses.replace(cfg, family="dense")
        seg, q, r = self._segments()
        for i in range(q):
            h = blocks.mamba_stack(self.mamba[i * seg:(i + 1) * seg], cfg, h,
                                   chunk=cfg.ssd_chunk, remat=cfg.remat)
            h, _, _ = blocks.stack_forward(   # the shared block: 1 "layer"
                [self.shared_attn], dense_cfg, h, positions,
                q_chunk=cfg.attn_q_chunk, remat=cfg.remat)
        if r:
            h = blocks.mamba_stack(self.mamba[q * seg:], cfg, h,
                                   chunk=cfg.ssd_chunk, remat=cfg.remat)
        return self._final_norm(h)

    def loss(self, batch):
        h = shard_activation(self._embed_tokens(batch["tokens"]),
                             ("batch", None, "act_embed"))
        b, s, _ = h.shape
        h = self._forward(h, _positions(b, s, device=h.device))
        ce = _ce_loss(h, batch, self.unembed)
        return ce, {"ce": ce}

    # --- serving -----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int) -> dict:
        """{'mamba': {'conv', 'ssm'} stacked over the n_layers mamba layers
        (the model's dtype), 'shared': {'k', 'v'} a KV cache per shared
        invocation}."""
        cfg = self.cfg
        one = ssm.mamba2_state_spec(cfg, batch, dtype=self.dtype)
        mamba = {k: _zeros(v, (cfg.n_layers,), self.device)
                 for k, v in one.items()}
        return {"mamba": mamba,
                "shared": self._kv_zeros(self._segments()[1], batch,
                                         max_len)}

    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None):
        """Process the prompt: (last logits, decode caches)."""
        cfg = self.cfg
        dense_cfg = dataclasses.replace(cfg, family="dense")
        h = shard_activation(self._embed_tokens(batch["tokens"]),
                             ("batch", None, "act_embed"))
        b, s, _ = h.shape
        positions = _positions(b, s, device=h.device)
        seg, q, r = self._segments()
        m_states, sh_k, sh_v = [], [], []
        for i in range(q):
            h, st = blocks.mamba_stack_prefill(
                self.mamba[i * seg:(i + 1) * seg], cfg, h,
                chunk=cfg.ssd_chunk, remat=cfg.remat)
            m_states.append(st)
            h, _, (k, v) = blocks.stack_forward(
                [self.shared_attn], dense_cfg, h, positions,
                q_chunk=cfg.attn_q_chunk, remat=cfg.remat, collect_kv=True)
            sh_k.append(k[0])
            sh_v.append(v[0])
        if r:
            h, st = blocks.mamba_stack_prefill(
                self.mamba[q * seg:], cfg, h, chunk=cfg.ssd_chunk,
                remat=cfg.remat)
            m_states.append(st)
        mamba = {k: torch.cat([st[k] for st in m_states])
                 for k in m_states[0]}
        shared = self._kv_seeded(q, torch.stack(sh_k), torch.stack(sh_v),
                                 max_len)
        h = self._final_norm(h)
        return (_logits_last(self.unembed, h[:, -1:, :]),
                {"mamba": mamba, "shared": shared})

    @torch.inference_mode()
    def decode_step(self, token, caches, cache_len):
        """(logits, caches): the mamba states anew, each shared
        invocation's KV column written in place."""
        cfg = self.cfg
        dense_cfg = dataclasses.replace(cfg, family="dense")
        h = self._embed_tokens(token)
        seg, q, r = self._segments()
        states = caches["mamba"]
        new = []
        for i in range(q):
            sl = slice(i * seg, (i + 1) * seg)
            h, st = blocks.mamba_stack_decode(
                self.mamba[sl], cfg, h, {k: v[sl] for k, v in states.items()})
            new.append(st)
            h, _ = blocks.decoder_block_decode(
                self.shared_attn, dense_cfg, h,
                blocks.state_at(caches["shared"], i), cache_len)
        if r:
            h, st = blocks.mamba_stack_decode(
                self.mamba[q * seg:], cfg, h,
                {k: v[q * seg:] for k, v in states.items()})
            new.append(st)
        mamba = {k: torch.cat([st[k] for st in new]) for k in new[0]}
        h = self._final_norm(h)
        return (_logits_last(self.unembed, h),
                {"mamba": mamba, "shared": caches["shared"]})


# ---------------------------------------------------------------------------
# XLSTMLM
# ---------------------------------------------------------------------------

class XLSTMLM(BaseLM):
    """xLSTM: segments of (every - 1) mLSTM blocks and 1 sLSTM block, then
    a tail of the remaining mLSTM blocks."""

    families = ("xlstm",)

    @staticmethod
    def _segments_of(cfg):
        every = max(cfg.slstm_every, 1)
        n_seg, rem = divmod(cfg.n_layers, every)
        return every, n_seg, rem

    def _segments(self):
        return self._segments_of(self.cfg)

    @classmethod
    def specs(cls, cfg):
        dt = cfg.torch_dtype
        every, n_seg, rem = cls._segments_of(cfg)
        spec = {
            "embed": nn.embedding_spec(cfg.vocab, cfg.d_model, dtype=dt),
            "final_norm": nn.rmsnorm_spec(cfg.d_model, dtype=dt),
            "unembed": _unembed_spec(cfg, dt),
        }
        if n_seg:
            m_spec = nn.stack_specs(blocks.mlstm_block_spec(cfg, dt),
                                    every - 1)
            spec["mlstm"] = nn.stack_specs(m_spec, n_seg)
            spec["slstm"] = nn.stack_specs(blocks.slstm_block_spec(cfg, dt),
                                           n_seg)
        if rem:
            spec["mlstm_tail"] = nn.stack_specs(
                blocks.mlstm_block_spec(cfg, dt), rem)
        return spec

    def _final_norm(self, h):
        return nn.rmsnorm(self.final_norm, h, eps=self.cfg.norm_eps)

    def _forward(self, h):
        cfg = self.cfg
        every, n_seg, rem = self._segments()
        for i in range(n_seg):
            h = blocks.mlstm_stack(self.mlstm[i], cfg, h, remat=cfg.remat)
            h, _ = blocks.slstm_block(self.slstm[i], cfg, h)
        if rem:
            h = blocks.mlstm_stack(self.mlstm_tail, cfg, h, remat=cfg.remat)
        return self._final_norm(h)

    def loss(self, batch):
        h = self._forward(shard_activation(
            self._embed_tokens(batch["tokens"]), ("batch", None, "act_embed")))
        ce = _ce_loss(h, batch, self.unembed)
        return ce, {"ce": ce}

    # --- serving -----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int) -> dict:
        """Recurrent states, float32 zeros (m too, as the reference's):
        'mlstm' (n_seg, every-1, ...), 'slstm' (n_seg, ...), 'mlstm_tail'
        (rem, ...). max_len is not used: the states do not grow."""
        every, n_seg, rem = self._segments()
        m_one = xlstm.mlstm_state_spec(self.cfg, batch, dtype=torch.float32)
        s_one = xlstm.slstm_state_spec(self.cfg, batch, dtype=torch.float32)
        out = {}
        if n_seg:
            out["mlstm"] = {k: _zeros(v, (n_seg, every - 1), self.device)
                            for k, v in m_one.items()}
            out["slstm"] = {k: _zeros(v, (n_seg,), self.device)
                            for k, v in s_one.items()}
        if rem:
            out["mlstm_tail"] = {k: _zeros(v, (rem,), self.device)
                                 for k, v in m_one.items()}
        return out

    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None):
        cfg = self.cfg
        every, n_seg, rem = self._segments()
        h = shard_activation(self._embed_tokens(batch["tokens"]),
                             ("batch", None, "act_embed"))
        m_states, s_states = [], []
        for i in range(n_seg):
            h, st = blocks.mlstm_stack_prefill(self.mlstm[i], cfg, h,
                                               remat=cfg.remat)
            m_states.append(st)
            h, sst = blocks.slstm_block(self.slstm[i], cfg, h)
            s_states.append(sst)
        caches = {}
        if n_seg:
            caches["mlstm"] = blocks.stack_states(m_states)
            caches["slstm"] = blocks.stack_states(s_states)
        if rem:
            h, caches["mlstm_tail"] = blocks.mlstm_stack_prefill(
                self.mlstm_tail, cfg, h, remat=cfg.remat)
        h = self._final_norm(h)
        return _logits_last(self.unembed, h[:, -1:, :]), caches

    @torch.inference_mode()
    def decode_step(self, token, caches, cache_len):
        """(logits, the new states); cache_len is not used."""
        cfg = self.cfg
        every, n_seg, rem = self._segments()
        h = self._embed_tokens(token)
        new_m, new_s = [], []
        for i in range(n_seg):
            h, st = blocks.mlstm_stack_decode(
                self.mlstm[i], cfg, h, blocks.state_at(caches["mlstm"], i))
            new_m.append(st)
            h, sst = blocks.slstm_block_decode(
                self.slstm[i], cfg, h, blocks.state_at(caches["slstm"], i))
            new_s.append(sst)
        out = {}
        if n_seg:
            out["mlstm"] = blocks.stack_states(new_m)
            out["slstm"] = blocks.stack_states(new_s)
        if rem:
            h, out["mlstm_tail"] = blocks.mlstm_stack_decode(
                self.mlstm_tail, cfg, h, caches["mlstm_tail"])
        return _logits_last(self.unembed, self._final_norm(h)), out


# ---------------------------------------------------------------------------
# EncDecLM (whisper)
# ---------------------------------------------------------------------------

class EncDecLM(BaseLM):
    """whisper: learned positions, an encoder stack over precomputed frame
    embeddings (B, Se, D) (the conv front end is a stub, as the
    reference's), and a decoder that cross-attends to its output."""

    families = ("encdec",)

    @classmethod
    def specs(cls, cfg):
        dt = cfg.torch_dtype
        return {
            "enc_pos": nn.ParamSpec((cfg.max_enc_len, cfg.d_model),
                                    (None, "embed"), init="normal",
                                    dtype=dt),
            "enc_layers": nn.stack_specs(blocks.encoder_block_spec(cfg, dt),
                                         cfg.enc_layers),
            "enc_norm": _final_norm_spec(cfg, dt),
            "embed": nn.embedding_spec(cfg.vocab, cfg.d_model, dtype=dt),
            "dec_pos": nn.ParamSpec((cfg.max_seq, cfg.d_model),
                                    (None, "embed"), init="normal",
                                    dtype=dt),
            "dec_layers": nn.stack_specs(blocks.encdec_block_spec(cfg, dt),
                                         cfg.n_layers),
            "final_norm": _final_norm_spec(cfg, dt),
            "unembed": _unembed_spec(cfg, dt),
        }

    def encode(self, frames):
        """(B, Se, D) frame embeddings -> the encoder's output."""
        cfg = self.cfg
        b, se, _ = frames.shape
        h = frames.to(self.dtype) + self.enc_pos[None, :se, :]
        h = shard_activation(h, ("batch", None, "act_embed"))
        h = blocks.encoder_stack(self.enc_layers, cfg, h,
                                 _positions(b, se, device=h.device),
                                 q_chunk=cfg.attn_q_chunk, remat=cfg.remat)
        return _norm_fn(cfg)(self.enc_norm, h, eps=cfg.norm_eps)

    def _decoder(self, tokens, enc_out, collect_kv=False):
        cfg = self.cfg
        b, s = tokens.shape
        h = self._embed_tokens(tokens) + self.dec_pos[None, :s, :]
        h, kvs = blocks.encdec_stack(self.dec_layers, cfg, h, enc_out,
                                     _positions(b, s, device=h.device),
                                     q_chunk=cfg.attn_q_chunk,
                                     remat=cfg.remat, collect_kv=collect_kv)
        return self._final_norm(h), kvs

    def loss(self, batch):
        """(ce, {'ce'}) of a batch {'frames', 'tokens', 'targets'[,
        'loss_mask']}."""
        h, _ = self._decoder(batch["tokens"], self.encode(batch["frames"]))
        ce = _ce_loss(h, batch, self.unembed)
        return ce, {"ce": ce}

    # --- serving -----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int,
                    enc_len: Optional[int] = None) -> dict:
        """{'self': KV caches (L, B, max_len, KV), 'cross': the encoder's
        projected k/v (L, B, enc_len, KV)}; enc_len defaults to
        min(max_enc_len, 1500), whisper's 30 s of frames."""
        cfg = self.cfg
        enc_len = enc_len or min(cfg.max_enc_len, 1500)
        return {"self": self._kv_zeros(cfg.n_layers, batch, max_len),
                "cross": self._kv_zeros(cfg.n_layers, batch, enc_len)}

    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None):
        """Encode the frames and run the decoder prompt, seeding the self
        caches and filling the cross ones for decode."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        h, (k, v) = self._decoder(batch["tokens"], enc_out, collect_kv=True)
        self_caches = self._kv_seeded(cfg.n_layers, k, v, max_len)
        kvdt = cfg.torch_kv_dtype
        crosses = [attention.cross_kv(layer["cross"], cfg, enc_out)
                   for layer in self.dec_layers]
        cross = {n: nn.cast(torch.stack([c[n] for c in crosses]), kvdt)
                 for n in ("k", "v")}
        return (_logits_last(self.unembed, h[:, -1:, :]),
                {"self": self_caches, "cross": cross})

    @torch.inference_mode()
    def decode_step(self, token, caches, cache_len):
        cfg = self.cfg
        pos = min(max(int(cache_len), 0), cfg.max_seq - 1)   # jnp.take clamps
        h = self._embed_tokens(token) + self.dec_pos[pos][None, None, :]
        h, self_caches = blocks.encdec_stack_decode(
            self.dec_layers, cfg, h, caches["self"], caches["cross"],
            cache_len)
        return (_logits_last(self.unembed, self._final_norm(h)),
                {"self": self_caches, "cross": caches["cross"]})


FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
    "hybrid": HybridLM,
    "xlstm": XLSTMLM,
    "encdec": EncDecLM,
}


def build_model(cfg: ArchConfig, *,
                generator: Optional[torch.Generator] = None,
                device="cuda", params: Optional[dict] = None) -> BaseLM:
    """The config's model (any family of `FAMILIES`), its weights drawn by
    `generator` or taken from `params` (`BaseLM`)."""
    return FAMILIES[cfg.family](cfg, generator=generator, device=device,
                                params=params)


LMModel = BaseLM
