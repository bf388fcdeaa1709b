"""Minimal module system: param specs with logical axes (twin of
`repro/models/nn.py`).

Every layer declares a spec tree of ParamSpec entries (shape, logical axis
names, init law, dtype). `init_params` draws a spec tree from a
`torch.Generator` into a nested dict of tensors, and `Params` holds such a
tree as a `torch.nn.Module`. The functional forms (`dense`, `rmsnorm`, the
attention and block functions) index their params by key, so they take a
`Params` module or a plain dict of tensors alike.

Logical axes map to mesh axes through `repro_torch.sharding`'s rules (the
dry-run's shardings; `shard_activation` / `gather_weight` under an active
mesh):
  "vocab" embedding rows / logits columns, "embed" the d_model dimension,
  "heads" / "kv" flattened head projections, "mlp" the d_ff dimension,
  "layers" a stacked-layer dimension, None replicated.

Weights keep the reference's (d_in, d_out) layout and `x @ w`, so a
reference param tree carries across as copies (`compat.lm_params_from_
reference`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.precision import fp8_quantize
from repro_torch.sharding.rules import gather_weight, is_dtensor


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                 # logical axis per dim (str | None)
    init: str = "normal"        # normal | zeros | ones | fanin | fanin_deep
    dtype: torch.dtype = torch.float32
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def _fan_in(shape) -> int:
    return shape[0] if len(shape) == 1 else math.prod(shape[:-1])


def _init_one(generator: torch.Generator, spec: ParamSpec, device, *,
              stack: tuple = ()) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        std = spec.scale * 0.02
    elif spec.init in ("fanin", "fanin_deep"):
        fan_in = _fan_in(tuple(stack) + tuple(spec.shape))
        std = spec.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    # scaled in place: a leaf holds one f32 transient beside its result
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=device)
    return draw.mul_(std).to(spec.dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def init_params(spec_tree, generator: torch.Generator, device, *,
                stack: tuple = ()):
    """Materialize a spec tree into a nested dict of tensors on `device`,
    drawing the leaves from `generator` in sorted-key order (a single
    ParamSpec gives a single tensor).

    With `stack` = (L,) the tree is one layer of an L-layer stack, and a
    fan-in law takes the fan-in of the stacked (L, ...) leaf, as the
    reference initialises its stacked layers: std = scale / sqrt(L *
    d_in), not scale / sqrt(d_in). With (n_seg, L) it is a layer of a
    stack of stacks (xLSTM's mLSTM), whose leaf is (n_seg, L, ...):
    fan-in n_seg * L * d_in."""
    if is_spec(spec_tree):
        return _init_one(generator, spec_tree, device, stack=stack)
    return {k: init_params(s, generator, device, stack=stack)
            for k, s in sorted(spec_tree.items())}


def spec_leaves(spec_tree, prefix: str = ""):
    """(path, ParamSpec) of every leaf, paths as 'a/b/c', sorted."""
    for k, s in sorted(spec_tree.items()):
        path = f"{prefix}{k}"
        if is_spec(s):
            yield path, s
        else:
            yield from spec_leaves(s, path + "/")


def count_params(spec_tree) -> int:
    """Parameters a spec tree declares, counted without allocation."""
    return sum(math.prod(s.shape) for _, s in spec_leaves(spec_tree))


def stack_specs(spec_tree, n: int):
    """Prepend a stacked 'layers' dim to every spec (the reference's
    scanned layout; the port holds the layers as a list of modules)."""
    return {k: (dataclasses.replace(s, shape=(n,) + s.shape,
                                    axes=("layers",) + s.axes)
                if is_spec(s) else stack_specs(s, n))
            for k, s in spec_tree.items()}


def unstack_specs(spec_tree, depth: int):
    """`stack_specs` undone `depth` times: (one layer's spec tree, the
    stacked dims that were taken off)."""
    if is_spec(spec_tree):
        return (dataclasses.replace(spec_tree, shape=spec_tree.shape[depth:],
                                    axes=spec_tree.axes[depth:]),
                tuple(spec_tree.shape[:depth]))
    out, dims = {}, ()
    for k, s in spec_tree.items():
        out[k], dims = unstack_specs(s, depth)
    return out, dims


class Params(torch.nn.Module):
    """A param tree as a module: a leaf is a trainable Parameter, a
    subtree a child Params. `params[key]` and `key in params` read either,
    as on the reference's dicts."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(k, torch.nn.Parameter(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The params as a nested dict of this module's own Parameters
        (not copies), keys sorted."""
        return {k: (self._modules[k].tree() if k in self._modules
                    else self._parameters[k])
                for k in sorted([*self._parameters, *self._modules])}


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x.astype(dtype) as the reference casts: float8_e4m3fn rounds to
    nearest even and gives NaN past its range (precision.fp8_quantize),
    where torch alone would saturate."""
    if dtype == torch.float8_e4m3fn:
        return fp8_quantize(x, 1.0)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Common primitives
# ---------------------------------------------------------------------------

def dense_spec(d_in: int, d_out: int, ax_in: Optional[str],
               ax_out: Optional[str], *, bias: bool = False,
               dtype=torch.float32, init: str = "fanin", scale: float = 1.0):
    spec = {"w": ParamSpec((d_in, d_out), (ax_in, ax_out), init=init,
                           dtype=dtype, scale=scale)}
    if bias:
        spec["b"] = ParamSpec((d_out,), (ax_out,), init="zeros", dtype=dtype)
    return spec


def promote(*xs):
    """The tensors cast to their common dtype, as JAX promotes the
    operands of a product (bf16 with f32 is f32); torch's matmul and
    einsum refuse mixed dtypes."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x if x.dtype == dt else x.to(dt) for x in xs]


def einsum(eq: str, *xs) -> torch.Tensor:
    """jnp.einsum: the operands promoted to one dtype first."""
    return torch.einsum(eq, *promote(*xs))


def dense(params, x: torch.Tensor) -> torch.Tensor:
    w = gather_weight(params["w"])
    if x.dtype != w.dtype:
        x, w = promote(x, w)
    y = x @ w
    if "b" in params:
        y = y + params["b"]
    return y


def rmsnorm_spec(d: int, dtype=torch.float32):
    return {"scale": ParamSpec((d,), ("embed",), init="ones", dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * gather_weight(params["scale"]).float()).to(dt)


def layernorm_spec(d: int, dtype=torch.float32):
    return {"scale": ParamSpec((d,), ("embed",), init="ones", dtype=dtype),
            "bias": ParamSpec((d,), ("embed",), init="zeros", dtype=dtype)}


def layernorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * gather_weight(params["scale"]).float() \
        + gather_weight(params["bias"]).float()
    return y.to(dt)


def write_slice(dst: torch.Tensor, dim: int, start: int,
                value: torch.Tensor) -> torch.Tensor:
    """dst[..., start:start + n, ...] = value along `dim` (n =
    value.shape[dim]), in place; returns dst. On a DTensor sharded along
    `dim` (a sequence-sharded KV cache under a mesh) each rank writes the
    part of the slice that falls in its own shard, from the value
    gathered along `dim`, as GSPMD partitions an update: DTensor's own
    indexed copy would gather the whole of `dst` first."""
    n = value.shape[dim]
    if not is_dtensor(dst) or not any(
            getattr(p, "dim", None) == dim for p in dst.placements):
        dst.narrow(dim, start, n).copy_(value)
        return dst
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = dst.device_mesh
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    if start == 0 and n == dst.shape[dim]:
        # the whole dimension: each rank takes its own shard of the value
        dst.to_local().copy_(
            value.redistribute(mesh, dst.placements).to_local())
        return dst
    # the value whole along `dim`, sharded as dst along every other dim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in dst.placements]
    src = value.redistribute(mesh, pl).to_local()
    # this rank's shard of `dim`, [offset, offset + size): DTensor's
    # chunks of ceil(size / ways), the mesh axes split in their order
    offset, size, coord = 0, dst.shape[dim], mesh.get_coordinate()
    for i, p in enumerate(dst.placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-size // mesh.size(i))
            first = min(coord[i] * chunk, size)
            offset, size = offset + first, min(chunk, size - first)
    lo, hi = max(start, offset), min(start + n, offset + size)
    if hi > lo:
        dst.to_local().narrow(dim, lo - offset, hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))
    return dst


def embedding_spec(vocab: int, d: int, dtype=torch.float32):
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), init="normal",
                               dtype=dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return gather_weight(params["table"])[tokens.long()]
