"""Per-device cost of one step, counted op by op (twin of
`repro/roofline/hlo_cost.py`).

The reference compiles a cell for the production mesh and reads the
per-device HLO: dot FLOPs, operand + result bytes of top-level
instructions, collective operand bytes, each loop body times its trip
count. The port has no HLO and no XLA compiler. It runs the cell's step
on DTensors whose local shards are fake tensors (no data, no compute)
over a fake process group, and counts what one rank's program does:

  FLOPs       torch's FlopCounterMode formulas (a matmul 2 M N K) applied
              to each LOCAL op, the op on this rank's shards, so the
              count is per device as the reference's is
  HBM bytes   each local op's tensor operands plus its results; views
              and metadata move nothing. XLA fuses elementwise chains and
              counts only a fusion's boundary, so this UNFUSED count is an
              upper bound on the reference's (`hbm_bytes_model`)
  collectives the operand bytes of each all-gather / all-reduce /
              reduce-scatter / all-to-all that DTensor issues to
              redistribute a tensor, by kind and by link: NVLink when
              the group's ranks stay within one node of `node_gpus`
              consecutive ranks, InfiniBand otherwise (`hw`)

The layers are Python loops and run unrolled. Two loops repeat one
program, the train step's microbatches and sLSTM's time loop: they run
one or a few trips, and `launch.dryrun` adds one trip's counts for each
of the rest, as the reference multiplies a loop body by its trip count. Where DTensor has no sharding rule for an op, the
op runs with its operands' innermost mesh axes replicated, one axis more
at a time until a rule fits, on local shards replicated over the whole
mesh at worst (their gathers counted), and its name is recorded
(`replicated_ops`): the count stays an upper bound there too. An op that
fails on its operands' global shapes as well is a fault of the program
and raises (`_fails_on_global_shapes`).
The peak of live bytes comes from torch's `MemTracker`, which follows a
DTensor's local shards.

Counters are TorchDispatchModes that return NotImplemented on a DTensor
call, so DTensor desugars it first and they see the local ops and the
collectives; ops that DTensor's sharding propagation runs on global
shapes under a fake mode are skipped (`_propagating`), by the counter
and by the MemTracker alike.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import hw

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

_METADATA_OPS = {
    "aten::sym_is_contiguous", "aten::is_contiguous",
    "aten::is_strides_like_format", "aten::is_non_overlapping_and_dense",
    "aten::size", "aten::sym_size", "aten::stride", "aten::sym_stride",
    "aten::storage_offset", "aten::sym_storage_offset", "aten::numel",
    "aten::sym_numel", "aten::dim", "prim::layout", "prim::device",
}

# ops that move no bytes: views share their operand's storage; the rest
# allocate or wait without reading or writing a tensor
_FREE_OPS = {"aten::detach", "aten::alias", "aten::lift_fresh",
             "aten::empty", "aten::empty_like", "aten::empty_strided",
             "aten::_local_scalar_dense", "_c10d_functional::wait_tensor"}


class _Propagation(threading.local):
    depth = 0


_PROPAGATION = _Propagation()


def _propagating() -> bool:
    """True while DTensor derives an op's output metadata: it runs the op
    on global-shape fake tensors of the shards' own fake mode, which no
    mode stack shows, so `counting` marks the call (`_dtensor_patches`)."""
    return _PROPAGATION.depth > 0


@contextlib.contextmanager
def _dtensor_patches():
    """Mark DTensor's metadata propagation (`_propagating`); run
    `_StridedShard`'s shard-size arithmetic outside the fake mode the
    step runs in (it computes on real tensors and reads them back, which
    a fake mode refuses as data-dependent); and price a candidate
    strategy's redistribution with each strided shard taken as a plain
    one. A strided shard (a flattened dimension sharded on two mesh
    axes) sends DTensor's cost model to a search over every placement
    of the mesh for each candidate, minutes a step on the 3-axis mesh;
    the redistribution the chosen strategy needs is still planned
    exactly, once for each pair of specs."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor import _collective_utils, _utils
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._ops import utils as _ops_utils
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    meta = ShardingPropagator._propagate_tensor_meta_non_cached
    sizes = _StridedShard.local_shard_size_and_offset
    cost = _collective_utils.redistribute_cost

    def unstrided(spec):
        pl = tuple(Shard(p.dim) if isinstance(p, _StridedShard) else p
                   for p in spec.placements)
        if pl == tuple(spec.placements):
            return spec
        return DTensorSpec(spec.mesh, pl, tensor_meta=spec.tensor_meta)

    def priced(current, target):
        return cost(unstrided(current), unstrided(target))

    def marked(self, *args, **kwargs):
        _PROPAGATION.depth += 1
        try:
            return meta(self, *args, **kwargs)
        finally:
            _PROPAGATION.depth -= 1

    memo = {}

    def real(self, *args, **kwargs):
        # pure in its arguments, and it splits an arange of the whole
        # dimension: memoised, a step's thousands of calls cost a few;
        # DTensor's bookkeeping, not the program, so not counted
        key = (self, args, tuple(sorted(kwargs.items())))
        if key not in memo:
            _PROPAGATION.depth += 1
            try:
                with unset_fake_temporarily():
                    memo[key] = sizes(self, *args, **kwargs)
            finally:
                _PROPAGATION.depth -= 1
        size, offsets = memo[key]
        return size, (list(offsets) if isinstance(offsets, list)
                      else offsets)

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    _StridedShard.local_shard_size_and_offset = real
    for mod in (_collective_utils, _utils, _ops_utils):
        mod.redistribute_cost = priced
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = meta
        _StridedShard.local_shard_size_and_offset = sizes
        for mod in (_collective_utils, _utils, _ops_utils):
            mod.redistribute_cost = cost


def _collective_kind(name: str) -> Optional[str]:
    if "all_gather" in name or "allgather" in name:
        return "all-gather"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_reduce" in name or "allreduce" in name:
        return "all-reduce"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    return None


def _tensors(tree, out=None):
    # no nested recursive function: its closure cycle would hold every
    # op's tensors until the collector ran, in MemTracker's live bytes
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for y in tree:
            _tensors(y, out)
    elif isinstance(tree, dict):
        for y in tree.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(group_name) -> tuple:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(
        _resolve_process_group(group_name)))


def link_of(ranks, chip: hw.ChipSpec = hw.TARGET) -> str:
    """'nvlink' when every rank of the group is in one node of
    `chip.node_gpus` consecutive ranks, else 'ib'."""
    return ("nvlink" if len({r // chip.node_gpus for r in ranks}) <= 1
            else "ib")


@dataclasses.dataclass
class OpCost:
    """One rank's counts of a step."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    coll_by_link: dict = dataclasses.field(
        default_factory=lambda: {"nvlink": 0, "ib": 0})
    replicated_ops: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    n_ops: int = 0

    def snapshot(self) -> dict:
        """The counts as plain numbers and dicts (for `add_since`)."""
        return {f.name: (dict(v) if isinstance(v, dict) else v)
                for f in dataclasses.fields(self)
                for v in [getattr(self, f.name)]}

    def restore(self, snap: dict):
        """The counts as `snapshot` took them."""
        for name, v in snap.items():
            if isinstance(v, dict):
                getattr(self, name).clear()
                getattr(self, name).update(v)
            else:
                setattr(self, name, v)

    def add_since(self, before: dict, after: dict, times: int = 1):
        """Add `times` x the counts between two snapshots."""
        for name, b in before.items():
            a = after[name]
            if isinstance(a, dict):
                d = getattr(self, name)
                for k, v in a.items():
                    d[k] = d.get(k, 0) + times * (v - b.get(k, 0))
            else:
                setattr(self, name, getattr(self, name) + times * (a - b))


class OpBudgetExceeded(RuntimeError):
    """More local ops ran than the count's budget allows."""


def _model_frame() -> str:
    """file:line function of the innermost model frame on the stack."""
    import traceback

    for fr in reversed(traceback.extract_stack()):
        if "/repro_torch/models/" in fr.filename:
            return (f"models/{fr.filename.rsplit('/models/', 1)[1]}:"
                    f"{fr.lineno} {fr.name}")
    return "outside the models"


class _Counter(TorchDispatchMode):
    """Counts the local ops and the collectives of one rank; raises
    OpBudgetExceeded once more than `max_ops` local ops have run."""

    def __init__(self, cost: OpCost, chip: hw.ChipSpec,
                 max_ops: Optional[int] = None):
        super().__init__()
        self.cost = cost
        self.chip = chip
        self.max_ops = max_ops
        self.ran = 0            # local ops run (n_ops also adds repeats)
        from torch.utils.flop_counter import FlopCounterMode

        self.registry = FlopCounterMode().flop_registry
        self._links = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._schema.name
        if name in _METADATA_OPS:
            return func(*args, **kwargs)
        if _propagating():
            # DTensor's sharding propagation: metadata, not the program
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry:
            # as FlopCounterMode: a composite op counts as its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        c = self.cost
        c.n_ops += 1
        self.ran += 1
        if self.max_ops is not None and self.ran > self.max_ops:
            raise OpBudgetExceeded(
                f"more than {self.max_ops:,} local ops: {func} in "
                f"{_model_frame()}")
        kind = _collective_kind(name)
        if kind is not None:
            nb = _nbytes(args[0]) if isinstance(args[0], torch.Tensor) \
                else sum(_nbytes(t) for t in _tensors(args[0]))
            group = args[-1] if isinstance(args[-1], str) \
                else kwargs.get("group_name")
            if group not in self._links:
                self._links[group] = link_of(_group_ranks(group), self.chip)
            c.coll_bytes += nb
            c.coll_by_kind[kind] += nb
            c.coll_counts[kind] += 1
            c.coll_by_link[self._links[group]] += nb
            return out
        if packet in self.registry:
            c.flops += self.registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or name in _FREE_OPS):
            c.hbm_bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(kwargs)) \
                + sum(_nbytes(t) for t in _tensors(out))
        return out


class _Replicating(TorchDispatchMode):
    """Runs each DTensor op; where DTensor has no sharding rule for it or
    its rule fails, runs it on replicated operands instead and records
    its name. An op that fails on its operands' global shapes too is the
    program's fault, not DTensor's, and raises. Values are fake, so only
    the shapes of the fallback matter."""

    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost
        # (op, operand specs) -> the fewest inner axes to replicate
        self.no_rule = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func is torch.ops.aten.gather.default:
            out = _sharded_gather(*args, **kwargs)
            if out is not None:
                return out
        key = (func, _signature(args), _signature(kwargs))
        mesh = _mesh_of((args, kwargs))
        start = self.no_rule.get(key, 0)
        # replicate the innermost k mesh axes, k = 0, 1, ...: the first
        # that DTensor has a rule for keeps the outer axes' sharding
        for k in range(start, mesh.ndim):
            before = self.cost.snapshot()
            try:
                out = func(*_replicate_inner(args, mesh, k),
                           **_replicate_inner(kwargs, mesh, k))
            except OpBudgetExceeded:
                raise
            except Exception:  # noqa: BLE001 — DTensor's, or the program's
                if k == 0 and key not in self.no_rule \
                        and _fails_on_global_shapes(func, args, kwargs):
                    raise
                # what the failed attempt moved is not the program's
                self.cost.restore(before)
                self.no_rule[key] = k + 1
                continue
            if k:
                self.cost.replicated_ops[str(func)] += 1
            return args[0] if k and func._schema.is_mutable else out
        self.cost.replicated_ops[str(func)] += 1
        return _replicated_call(func, args, kwargs)


def _fails_on_global_shapes(func, args, kwargs) -> bool:
    """True when `func` raises on meta tensors of its operands' global
    shapes: the op is wrong whatever the sharding (a shape or dtype
    fault of the program). An op whose output depends on data the meta
    device does not hold cannot be judged so and counts as valid. Run as
    propagation (`_propagating`): the counters skip it."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.utils._pytree import tree_map

    def meta(x):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                   dtype=x.dtype, device="meta")

    _PROPAGATION.depth += 1
    try:
        func(*tree_map(meta, args), **tree_map(meta, kwargs))
    except (DataDependentOutputException, DynamicOutputShapeException):
        return False
    except Exception:  # noqa: BLE001 — any fault of the op itself
        return True
    finally:
        _PROPAGATION.depth -= 1
    return False


def _replicate_inner(tree, mesh, k: int):
    """`tree` with each DTensor's innermost k mesh axes replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    if k == 0:
        return tree

    def one(x):
        if not isinstance(x, DTensor):
            return x
        pl = tuple(Replicate() if i >= mesh.ndim - k else p
                   for i, p in enumerate(x.placements))
        return (x if pl == tuple(x.placements)
                else _no_graph(x).redistribute(mesh, pl))

    return tree_map(one, tree)


def _no_graph(x):
    """`x` detached where autograd records nothing (grad mode off, as in
    a backward): redistributed as it is, a tensor that needs grad has its
    result detached in place, an op that some DTensor versions have no
    sharding rule for, and whose bytes are not the program's."""
    return x.detach() if x.requires_grad and not torch.is_grad_enabled() \
        else x


def _signature(tree):
    """A hashable stand-in for an op's operands: each DTensor's shape,
    dtype and placements, other values as they are."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return ("D", tuple(tree.shape), tree.dtype, tuple(tree.placements))
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype)
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(x) for x in tree)
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in sorted(tree.items()))
    try:
        hash(tree)
        return tree
    except TypeError:
        return repr(tree)


def _mesh_of(args):
    from torch.distributed.tensor import DTensor

    for t in _tensors(args):
        if isinstance(t, DTensor):
            return t.device_mesh
    raise ValueError("no DTensor operand")


def _replicated_call(func, args, kwargs):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    mesh = _mesh_of((args, kwargs))
    repl = [Replicate()] * mesh.ndim

    def local(x):
        if isinstance(x, DTensor):
            return _no_graph(x).redistribute(mesh, repl).to_local()
        return x

    out = func(*tree_map(local, args), **tree_map(local, kwargs))
    if func._schema.is_mutable:
        # the mutated operand stands for the result (fake values)
        return args[0]

    def wrap(x):
        if isinstance(x, torch.Tensor):
            return DTensor.from_local(x, mesh, repl, run_check=False)
        return x

    return tree_map(wrap, out)


def _sharded_gather(x, dim, index, *, sparse_grad=False):
    """torch.gather of a DTensor sharded along `dim` (the vocab of the
    cross-entropy's logits): each rank gathers within its own shard and
    the result is a partial sum over the sharding axes, as GSPMD
    partitions it; DTensor's own masked form cannot reduce a 3-D gather.
    None where `x` is not sharded along `dim`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return None
    dim = dim % x.ndim
    mesh = x.device_mesh
    along = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == dim]
    if not along:
        return None
    idx_pl = (list(index.placements) if isinstance(index, DTensor)
              else [Replicate()] * mesh.ndim)
    x_pl = [x.placements[i] if i in along else idx_pl[i]
            for i in range(mesh.ndim)]
    xl = x.redistribute(mesh, x_pl).to_local()
    il = (index.redistribute(mesh, idx_pl).to_local()
          if isinstance(index, DTensor) else index)
    out = torch.gather(xl, dim, torch.zeros_like(il))
    out_pl = [Partial("sum") if i in along else idx_pl[i]
              for i in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


@contextlib.contextmanager
def counting(*track, fake_mode=None, max_ops: Optional[int] = None,
             chip: hw.ChipSpec = hw.TARGET):
    """Count the ops run inside: yields (OpCost, MemTracker); `track` are
    the modules and tensors alive before the step (params, optimizer
    state, inputs), whose local shards MemTracker counts from the
    start. With `fake_mode` (the mode the cell's shards were made in)
    active, the tensors the step creates are fake too: a full-size
    cache or mask allocates nothing. Past `max_ops` local ops the step
    stops with OpBudgetExceeded, naming the op and the model's line."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication

    class _Mem(MemTracker):
        # MemTracker skips propagation ops by `active_fake_mode`, which
        # misses them on fake shards (`_propagating`)
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor

            if _propagating() and not any(issubclass(t, DTensor)
                                          for t in types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    cost = OpCost()
    mem = _Mem()
    mem.track_external(*[t for t in track if t is not None])
    # the last mode entered sees an op first: the replicating one must
    # run a DTensor op before the counters see its local ops
    with _dtensor_patches(), fake_mode or contextlib.nullcontext(), \
            implicit_replication(), mem, _Counter(cost, chip, max_ops), \
            _Replicating(cost):
        yield cost, mem


def peak_bytes(mem) -> int:
    """The largest total of live bytes on any device over the step."""
    snap = mem.get_tracker_snapshot("peak")
    return int(max((d.get("Total", 0) for d in snap.values()), default=0))
