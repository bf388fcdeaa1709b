"""Cell builder: one (architecture x input-shape x mesh) dry-run unit
(twin of `repro/launch/cells.py`).

A *cell* bundles the step to count (the train step for train shapes,
prefill for prefill shapes, the serve step for decode shapes), fake
stand-ins for every input (`input_specs`: tensors of the right shape and
dtype that hold no data), and the shardings derived from the logical-axis
rules. The reference lowers and compiles its cells; the port runs them on
DTensors of those shardings, their local shards fake tensors, over the
mesh of a fake process group (`launch.mesh.fake_world`), and counts the
program (`roofline.op_cost`). launch/dryrun.py drives it.

The model is built on CPU fake tensors (`FakeTensorMode`): a full-size
model costs no memory and no time to draw. Its weights become DTensor
Parameters of their shardings (`_shard_params`); the optimizer state,
the batch and the caches become DTensors of theirs.

Divergences from the reference: a decode cell's `cache_len` is a 0-d
host tensor holding seq_len - 1 in `input_specs` and a Python int in the
cell (the port's decode reads it as one; no op's shape depends on it),
and its `key_bits` input is a `torch.Generator` (the port's samplers
draw from one). The step runs in the fake mode the cell was built in
(`Cell.fake_mode`), so what it creates is fake too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, \
    shape_applicable
from repro_torch.configs.registry import ARCHS, SMOKES
from repro_torch.models.model import build_model
from repro_torch.serve.engine import make_serve_step
from repro_torch.sharding.rules import (NamedSharding, distribute,
                                        logical_to_spec, rules_for_mesh)
from repro_torch.sharding.state import (axes_to_shardings, batch_axes,
                                        distribute_tree, train_state_axes)
from repro_torch.train.step import (TrainState, default_optimizer_for,
                                    make_train_state_init, make_train_step)

WHISPER_DECODE_ENC_LEN = 1500   # realistic 30 s audio context


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                   # train | prefill | decode | skip
    fn: Any                     # the step to run and count
    args_abs: tuple             # its inputs (DTensors of fake shards)
    n_microbatches: int = 1
    notes: str = ""
    model: Any = None
    fake_mode: Any = None       # the mode the fake shards were made in


def fake_mode():
    """The fake-tensor mode cells build in (real tensors may enter)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


class _NoGradSteps:
    """A model whose `prefill` and `decode_step` run under no_grad in
    place of their inference_mode: DTensor's view ops raise in inference
    mode ("Cannot set version_counter for inference tensor"). The ops
    are the same."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _plain(self, name, *args, **kwargs):
        fn = getattr(type(self._model), name).__wrapped__
        with torch.no_grad():
            return fn(self._model, *args, **kwargs)

    def prefill(self, *args, **kwargs):
        return self._plain("prefill", *args, **kwargs)

    def decode_step(self, *args, **kwargs):
        return self._plain("decode_step", *args, **kwargs)


def pick_microbatches(cfg: ArchConfig, shape: ShapeConfig,
                      data_ways: int = 16) -> int:
    """Gradient-accumulation depth so train activations fit one device."""
    if not shape.is_train:
        return 1
    if cfg.d_model >= 6144 or cfg.moe_n_experts >= 32:
        nm = 16
    elif cfg.d_model >= 4096:
        nm = 8
    else:
        nm = 4
    # microbatch rows must stay divisible by the batch-sharding ways
    # (data, x pod when present): a smaller micro drops batch sharding
    # and REPLICATES activations per device
    return min(nm, max(shape.global_batch // data_ways, 1))


def _fake_model(cfg: ArchConfig, device="cpu", mode=None):
    mode = mode or fake_mode()
    with mode:
        model = build_model(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))
    return model, mode


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(arch_name: str, shape_name, *, smoke: bool = False,
                device="cpu", mode=None):
    """Fake stand-ins for every model input of this cell. `shape_name`
    names one of SHAPES or is a ShapeConfig of its own."""
    cfg = (SMOKES if smoke else ARCHS)[arch_name]
    shape = _shape(shape_name)
    b, s = shape.global_batch, shape.seq_len
    if smoke:
        b, s = min(b, 4), min(s, 64)
    mode = mode or fake_mode()
    i32 = torch.int32

    def like(shp, dtype):
        with mode:
            return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {
                "frames": like((b, min(s, cfg.max_enc_len), cfg.d_model),
                               cfg.torch_dtype),
                "tokens": like((b, s), i32),
                "targets": like((b, s), i32),
            }
        if cfg.family == "vlm":
            s_text = s - cfg.n_vision_tokens
            return {
                "vision_embeds": like((b, cfg.n_vision_tokens, cfg.d_model),
                                      cfg.torch_dtype),
                "tokens": like((b, s_text), i32),
                "targets": like((b, s_text), i32),
            }
        return {"tokens": like((b, s), i32), "targets": like((b, s), i32)}
    # decode: one new token against a seq_len cache
    model, _ = _fake_model(cfg, device, mode)
    kw = {}
    if cfg.family == "encdec":
        kw["enc_len"] = min(WHISPER_DECODE_ENC_LEN, cfg.max_enc_len)
    with mode:
        caches = model.init_caches(batch=b, max_len=s, **kw)
    return {
        "token": like((b, 1), i32),
        "caches": caches,
        "cache_len": torch.tensor(s - 1, dtype=i32),
        "generator": torch.Generator(device=device),
    }


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _cache_logical_axes(model, caches):
    cfg = model.cfg

    def kv(tree):
        # decode caches: SEQUENCE-sharded over 'model' (partial attention
        # + reduce beats per-step cache all-gathers; kv lanes replicated)
        return _map_leaves(lambda x: ("layers", "batch", "kv_seq", None),
                           tree)

    if cfg.family in ("dense", "moe", "vlm"):
        return kv(caches)
    if cfg.family == "encdec":
        return {"self": kv(caches["self"]), "cross": kv(caches["cross"])}
    if cfg.family == "hybrid":
        return {
            "mamba": {"conv": ("layers", "batch", None, "mlp"),
                      "ssm": ("layers", "batch", "heads", None, None)},
            "shared": kv(caches["shared"]),
        }
    if cfg.family == "xlstm":
        out = {}
        if "mlstm" in caches:
            out["mlstm"] = {
                "c": ("layers", "layers", "batch", "heads", None, None),
                "n": ("layers", "layers", "batch", "heads", None),
                "m": ("layers", "layers", "batch", "heads"),
                "conv": ("layers", "layers", "batch", None, "mlp"),
            }
            out["slstm"] = {k: ("layers", "batch", None)
                            for k in ("c", "n", "h", "m")}
        if "mlstm_tail" in caches:
            out["mlstm_tail"] = {
                "c": ("layers", "batch", "heads", None, None),
                "n": ("layers", "batch", "heads", None),
                "m": ("layers", "batch", "heads"),
                "conv": ("layers", "batch", None, "mlp"),
            }
        return out
    raise ValueError(cfg.family)


def _shard_params(module, shardings):
    """Replace each weight of `module` by a DTensor Parameter of its
    sharding (`shardings` has the module's param-tree layout)."""
    if isinstance(module, torch.nn.ModuleList):
        for m, s in zip(module, shardings):
            _shard_params(m, s)
        return
    for k, s in shardings.items():
        if k in module._parameters:
            p = module._parameters[k]
            module._parameters[k] = torch.nn.Parameter(
                distribute(p, s), requires_grad=p.requires_grad)
        else:
            _shard_params(module._modules[k], s)


def build_cell(arch_name: str, shape_name, mesh, *, smoke: bool = False,
               n_microbatches: Optional[int] = None) -> Cell:
    """The cell of an arch and a shape (a SHAPES name or a ShapeConfig) on
    `mesh`; `n_microbatches` replaces the train step's
    `pick_microbatches` depth."""
    cfg = (SMOKES if smoke else ARCHS)[arch_name]
    shape = _shape(shape_name)
    shape_name = shape.name
    runs, reason = shape_applicable(cfg, shape)
    if not runs:
        return Cell(arch=arch_name, shape=shape_name, kind="skip",
                    fn=None, args_abs=(), notes=f"SKIP: {reason}")
    device = mesh.device_type
    rules = rules_for_mesh(mesh)
    model, mode = _fake_model(cfg, device)
    specs = input_specs(arch_name, shape, smoke=smoke, device=device,
                        mode=mode)
    param_sh = axes_to_shardings(model.param_axes(), model.param_tree(),
                                 mesh, rules)

    if shape.kind in ("train", "prefill"):
        batch_sh = axes_to_shardings(batch_axes(specs), specs, mesh, rules)
        batch = distribute_tree(specs, batch_sh)
        if shape.kind == "train":
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            data_ways = sizes.get("data", 1) * sizes.get("pod", 1)
            nm = 1 if smoke else pick_microbatches(cfg, shape,
                                                   data_ways=data_ways)
            nm = n_microbatches or nm
            opt = default_optimizer_for(cfg)
            accum_dtype = {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[cfg.grad_accum_dtype]
            step = make_train_step(model, opt, n_microbatches=nm,
                                   accum_dtype=accum_dtype)
            with mode:
                state = make_train_state_init(model, opt)(
                    torch.Generator(device=device).manual_seed(0))
            state_axes = train_state_axes(model, opt, state)
            state_sh = axes_to_shardings(state_axes, state, mesh, rules)
            _shard_params(model, state_sh.params)
            state = TrainState(
                params=model.param_tree(),
                opt_state=distribute_tree(state.opt_state,
                                          state_sh.opt_state),
                step=distribute(state.step, state_sh.step))
            return Cell(arch=arch_name, shape=shape_name, kind="train",
                        fn=step, args_abs=(state, batch),
                        n_microbatches=nm,
                        notes=f"optimizer={opt.name} microbatches={nm}",
                        model=model, fake_mode=mode)
        # prefill
        _shard_params(model, param_sh)
        max_len = shape.seq_len

        def prefill_fn(batch):
            return _NoGradSteps(model).prefill(batch, max_len=max_len)

        return Cell(arch=arch_name, shape=shape_name, kind="prefill",
                    fn=prefill_fn, args_abs=(batch,), notes="prefill",
                    model=model, fake_mode=mode)

    # decode
    _shard_params(model, param_sh)
    caches = specs["caches"]
    cache_sh = axes_to_shardings(_cache_logical_axes(model, caches), caches,
                                 mesh, rules)
    token = distribute(specs["token"], NamedSharding(mesh, logical_to_spec(
        ("batch", None), specs["token"].shape, mesh, rules)))
    serve = make_serve_step(_NoGradSteps(model))
    return Cell(
        arch=arch_name, shape=shape_name, kind="decode",
        fn=serve,
        args_abs=(token, distribute_tree(caches, cache_sh),
                  int(specs["cache_len"]), specs["generator"]),
        notes="serve_step: 1 token vs seq_len cache",
        model=model, fake_mode=mode)

