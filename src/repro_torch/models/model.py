"""Top-level language models (twin of `repro/models/model.py`), the dense
family so far.

  DecoderLM  dense: embedding -> decoder blocks -> final norm -> unembed

Interface (consumed by train/, serve/ and launch/):
  param_specs()                          -> spec tree (no allocation)
  DecoderLM(cfg, generator=, device=)    -> weights drawn from the specs
  init(generator)                        -> weights drawn anew, in place
  param_tree()                           -> the weights as a tree
  loss(batch)                            -> (scalar, metrics)
  init_caches(batch, max_len)            -> KV caches (L, B, S_max, KVH*Dh)
  prefill(batch[, max_len])              -> (last_logits, caches)
  decode_step(token, caches, cache_len)  -> (logits, caches)

The model is a `torch.nn.Module` that holds its weights as trainable
Parameters (one params module per layer), so the reference's explicit
`params` argument is gone from these calls: `loss` differentiates with
respect to the module's own weights, and training updates them in place.
`prefill` and `decode_step` run under `torch.inference_mode()`.

The LM head loss is chunked over the sequence (never the full (B, S, V)
logits at once). The MoE, VLM, hybrid, xLSTM and enc-dec families come in
a later slice of the LM scaffold; `build_model` raises
`NotImplementedError` for them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.hw import resolve_device
from repro_torch.models import attention, blocks, nn
from repro_torch.utils.tree import tree_map


def _not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family!r} family is not ported yet: it comes with the other "
        "families (LM scaffold slice (c)); the port builds 'dense' models")


def _unembed_spec(cfg, dtype):
    return {"w": nn.ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                              init="fanin", dtype=dtype)}


def _final_norm_spec(cfg, dtype):
    return (nn.layernorm_spec if cfg.norm == "layernorm"
            else nn.rmsnorm_spec)(cfg.d_model, dtype=dtype)


def param_specs(cfg: ArchConfig) -> dict:
    """The model's spec tree, the reference's leaf for leaf (layers
    stacked (L, ...) as there), built without allocating anything."""
    if cfg.family != "dense":
        raise _not_ported(cfg.family)
    dt = cfg.torch_dtype
    return {
        "embed": nn.embedding_spec(cfg.vocab, cfg.d_model, dtype=dt),
        "layers": nn.stack_specs(blocks.decoder_block_spec(cfg, dt),
                                 cfg.n_layers),
        "final_norm": _final_norm_spec(cfg, dt),
        "unembed": _unembed_spec(cfg, dt),
    }


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
        logits = (x[:, lo:lo + chunk] @ w_unembed).float()
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
    return (h_last @ unembed["w"]).float()


class BaseLM(torch.nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = cfg.torch_dtype

    def param_specs(self):
        return param_specs(self.cfg)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


class DecoderLM(BaseLM):
    """A dense decoder LM. Its weights are drawn from the specs by the
    reference's init laws with `generator` (default: seed 0 on `device`),
    or taken from `params`: {'embed', 'final_norm', 'unembed'} subtrees
    and 'layers', a list of per-layer trees, as tensors on `device` in
    the config's dtype (`compat.lm_params_from_reference` builds it)."""

    def __init__(self, cfg: ArchConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", params: Optional[dict] = None):
        super().__init__(cfg)
        if cfg.family != "dense":
            raise _not_ported(cfg.family)
        dev = resolve_device(device)
        if params is None:
            params = self._draw(
                generator or torch.Generator(device=dev).manual_seed(0), dev)
        self.embed = nn.Params(params["embed"])
        self.layers = torch.nn.ModuleList(
            nn.Params(p) for p in params["layers"])
        self.final_norm = nn.Params(params["final_norm"])
        self.unembed = nn.Params(params["unembed"])

    def _draw(self, g: torch.Generator, dev) -> dict:
        """A param tree drawn from the specs with `g`, in the order the
        constructor has always drawn it."""
        cfg = self.cfg
        specs = self.param_specs()
        block = blocks.decoder_block_spec(cfg, self.dtype)
        params = {k: nn.init_params(specs[k], g, dev)
                  for k in ("embed", "final_norm")}
        params["layers"] = [nn.init_params(block, g, dev, stack=cfg.n_layers)
                            for _ in range(cfg.n_layers)]
        params["unembed"] = nn.init_params(specs["unembed"], g, dev)
        return params

    def param_tree(self) -> dict:
        """The weights as the port's param tree: {'embed', 'final_norm',
        'unembed'} subtrees and 'layers', a list of per-layer trees, each
        leaf this module's own Parameter (not a copy)."""
        return {"embed": self.embed.tree(),
                "final_norm": self.final_norm.tree(),
                "layers": [layer.tree() for layer in self.layers],
                "unembed": self.unembed.tree()}

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
        fn = nn.layernorm if self.cfg.norm == "layernorm" else nn.rmsnorm
        return fn(self.final_norm, h, eps=self.cfg.norm_eps)

    def _embed_input(self, batch):
        """(hidden (B, S, D), number of vision tokens: 0 for dense)."""
        return nn.embed(self.embed, batch["tokens"]).to(self.dtype), 0

    def _backbone(self, h, positions, collect_kv=False):
        cfg = self.cfg
        h, aux, kvs = blocks.stack_forward(
            self.layers, cfg, h, positions, causal=True,
            q_chunk=cfg.attn_q_chunk, remat=cfg.remat, collect_kv=collect_kv)
        return self._final_norm(h), aux, kvs

    # --- training ----------------------------------------------------------
    def loss(self, batch):
        """(loss, {'ce', 'aux'}) of a batch {'tokens', 'targets'[,
        'loss_mask']} of tensors on the model's device: the masked mean
        NLL plus 0.01 x the MoE balance loss (0 for dense)."""
        h, n_vis = self._embed_input(batch)
        b, s, _ = h.shape
        h, aux, _ = self._backbone(h, _positions(b, s, device=h.device))
        if n_vis:
            h = h[:, n_vis:, :]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(batch["targets"].shape, dtype=torch.float32,
                              device=h.device)
        ce = chunked_cross_entropy(h, batch["targets"], mask,
                                   self.unembed["w"])
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    # --- serving -----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        spec = attention.KVCacheSpec(batch, max_len, cfg.n_kv_heads,
                                     cfg.d_head, dtype=cfg.torch_kv_dtype)
        shape = (cfg.n_layers,) + spec.shape
        return {k: torch.zeros(shape, dtype=spec.dtype, device=self.device)
                for k in ("k", "v")}

    @torch.inference_mode()
    def prefill(self, batch, max_len: Optional[int] = None):
        cfg = self.cfg
        h, _ = self._embed_input(batch)
        b, s, _ = h.shape
        h, _, (k, v) = self._backbone(h, _positions(b, s, device=h.device),
                                      collect_kv=True)
        caches = self.init_caches(b, max(s, max_len or 0))
        flat = cfg.n_kv_heads * cfg.d_head
        for name, new in (("k", k), ("v", v)):
            caches[name][:, :, :s] = nn.cast(
                new.reshape(cfg.n_layers, b, s, flat), caches[name].dtype)
        return _logits_last(self.unembed, h[:, -1:, :]), caches

    @torch.inference_mode()
    def decode_step(self, token, caches, cache_len):
        """One token (B, 1) at position cache_len: (logits (B, 1, V) f32,
        the caches with the new column written in place)."""
        cfg = self.cfg
        h = nn.embed(self.embed, token).to(self.dtype)
        h, k_news, v_news = blocks.stack_decode_readonly(
            self.layers, cfg, h, caches, cache_len)
        caches = blocks.write_cache_column(caches, k_news, v_news,
                                           cache_len)
        return _logits_last(self.unembed, self._final_norm(h)), caches


def build_model(cfg: ArchConfig, *,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> BaseLM:
    """The config's model with weights drawn by `generator`; the dense
    family only so far."""
    return DecoderLM(cfg, generator=generator, device=device)


LMModel = BaseLM
