"""Logical-axis -> mesh-axis sharding rules (twin of
`repro/sharding/rules.py`).

Strategy, the reference's: FSDP + TP within a pod, pure DP across pods.

  tensor-parallel axes ("vocab", "heads", "kv", "mlp") -> "model"
  FSDP axis ("embed": the d_model dim of weight matrices) -> "data"
  batch -> ("pod", "data")  [pod only when present in the mesh]
  "layers" (the stacked dim), "expert" and small params -> replicated

A logical axis is replicated when the assigned mesh axes' size does not
divide the dimension (e.g. kv_heads*d_head=1024 shards 16-way, but a
G=60 expert dim does not). A spec is a `PartitionSpec`, a tuple of one
entry per dimension (a mesh axis name, a tuple of names, or None), its
trailing Nones trimmed as the reference's. On a `DeviceMesh` a spec
becomes DTensor placements (`placements`): `Shard(dim)` on each mesh axis
a dimension takes, `Replicate()` on the others.

`shard_activation` redistributes a DTensor activation to its spec while
a mesh is active (`set_active`), where the reference's
`with_sharding_constraint` constrains it; a plain tensor the step made
(every rank holds all of it) is cut to its spec locally, as GSPMD
partitions a replicated value. It is the identity without an active
mesh, so model code runs unchanged on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import threading
from typing import Optional


class PartitionSpec(tuple):
    """One entry per leading dimension: a mesh axis name, a tuple of
    names, or None (replicated); trailing dimensions not listed are
    replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self) if len(self) != 1 else '(%r)' % (self[0],)}"


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or of a mapping that stands
    for one (the records' meshes, tests without a process group)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = tuple(mesh.mesh_dim_names or ())
    return dict(zip(names, (int(s) for s in mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict                     # logical axis -> mesh axis | tuple | None

    def mesh_axes(self, logical: Optional[str], mesh):
        if logical is None:
            return None
        ax = self.rules.get(logical)
        if ax is None:
            return None
        names = axis_sizes(mesh)
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]


RULES_SINGLE_POD = ShardingRules(rules={
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "embed": "data",      # FSDP
    "expert": None,       # expert dim replicated; TP inside the expert
    "layers": None,
    "batch": ("data",),
    "moe_capacity": ("data",),  # MoE (E,C,D) buffers: shard capacity like batch
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "seq": None,
    # sequence parallelism: the residual stream between blocks is
    # sharded over 'model' along seq; attention/MLP interiors re-gather
    "act_seq": "model",
    # decode KV caches: the cache SEQUENCE sharded over 'model'
    "kv_seq": "model",
})

RULES_MULTI_POD = ShardingRules(rules={
    **RULES_SINGLE_POD.rules,
    "batch": ("pod", "data"),   # DP across pods; FSDP stays intra-pod
    "moe_capacity": ("pod", "data"),
})


def rules_for_mesh(mesh) -> ShardingRules:
    return RULES_MULTI_POD if "pod" in axis_sizes(mesh) else RULES_SINGLE_POD


def _dim_ways(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def logical_to_spec(axes_tuple, shape, mesh,
                    rules: Optional[ShardingRules] = None) -> PartitionSpec:
    """PartitionSpec for one array given its logical axes + shape.

    Drops any assignment whose mesh-axis product does not divide the dim.
    """
    rules = rules or rules_for_mesh(mesh)
    sizes = axis_sizes(mesh)
    entries = []
    for dim, logical in zip(shape, axes_tuple):
        ax = rules.mesh_axes(logical, mesh)
        if ax is not None and dim % _dim_ways(sizes, ax) != 0:
            ax = None
        entries.append(ax)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh axis:
    Shard(d) where dimension d takes the axis, Replicate() elsewhere.
    A dimension over several axes shards them in the order listed, as
    a PartitionSpec does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(ax)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's `jax.sharding.NamedSharding`."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(axes_tree, abstract_tree, mesh,
                    rules: Optional[ShardingRules] = None):
    """NamedSharding tree for a param tree (axes tree mirrors it; a leaf
    needs only a `.shape`)."""
    rules = rules or rules_for_mesh(mesh)

    def one(axes, arr):
        return NamedSharding(mesh, logical_to_spec(axes, arr.shape, mesh,
                                                   rules))

    return map_axes(one, axes_tree, abstract_tree)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical axis names or None."""
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) \
        and all(a is None or isinstance(a, str) for a in x)


def map_axes(fn, axes_tree, *trees):
    """fn(axes, *subtrees) at every leaf of an axes tree (dicts, lists
    and dataclasses of `is_axes` tuples), the matching subtrees of
    `trees` beside it; the result has the axes tree's structure."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [map_axes(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(axes_tree)]
    if dataclasses.is_dataclass(axes_tree):
        return type(axes_tree)(**{
            f.name: map_axes(fn, getattr(axes_tree, f.name),
                             *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(axes_tree)})
    raise TypeError(f"not an axes tree node: {type(axes_tree).__name__}")


def distribute(x, sharding: NamedSharding):
    """`x` (a tensor, fake or real, holding the whole array as every rank
    does, or a DTensor) as a DTensor of `sharding`'s placements. A plain
    tensor is cut locally (no collective: each rank holds it already)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = sharding.placements
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == pl else x.redistribute(
            sharding.mesh, pl)
    return distribute_tensor(x.detach(), sharding.mesh, pl,
                             src_data_rank=None).requires_grad_(
                                 x.requires_grad)


# ---------------------------------------------------------------------------
# Activation-constraint context (thread-local; no-op without a mesh)
# ---------------------------------------------------------------------------

class _Active(threading.local):
    mesh = None
    rules: Optional[ShardingRules] = None


_ACTIVE = _Active()


@contextlib.contextmanager
def set_active(mesh, rules: Optional[ShardingRules] = None):
    prev = (_ACTIVE.mesh, _ACTIVE.rules)
    _ACTIVE.mesh = mesh
    _ACTIVE.rules = rules or (rules_for_mesh(mesh) if mesh else None)
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev


@contextlib.contextmanager
def no_sharding():
    with set_active(None):
        yield


def get_active():
    return _ACTIVE.mesh, _ACTIVE.rules


def is_dtensor(x) -> bool:
    """x is a DTensor (without importing DTensor's module where no code
    has: then nothing can have made one)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def gather_weight(w):
    """A weight as the step uses it under the active mesh: gathered over
    the batch axes ("data", and "pod") that store its FSDP shards, its
    tensor-parallel sharding kept. GSPMD all-gathers FSDP weights so; left
    to itself, DTensor would often move the activations instead. The
    identity with no mesh or on a plain tensor; the gather's gradient is
    the reduce-scatter of the weight's gradient."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(w, DTensor):
        return w
    batch = _ACTIVE.rules.rules.get("batch") or ()
    batch = batch if isinstance(batch, tuple) else (batch,)
    pl = tuple(Replicate() if name in batch and isinstance(p, Shard) else p
               for name, p in zip(mesh.mesh_dim_names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(mesh, pl)


def shard_activation(x, logical_axes_tuple):
    """Redistribute a DTensor activation (or cut a plain tensor, held
    whole by every rank) to the spec of its logical axes on the active
    mesh; the identity with no mesh."""
    mesh = _ACTIVE.mesh
    if mesh is None:
        return x
    spec = logical_to_spec(logical_axes_tuple, x.shape, mesh, _ACTIVE.rules)
    return distribute(x, NamedSharding(mesh, spec))
