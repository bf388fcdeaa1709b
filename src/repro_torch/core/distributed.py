"""Distributed PERMANOVA over a (pod, data, model) DeviceMesh.

Twin of `repro/core/distributed.py`, on torch.distributed. Every rank runs
the same call with the same arguments and returns the whole result
(SPMD); a world of one (launch.mesh.world_of_one) with a (1, 1) mesh runs
the same sweep on one host.

  * 'data' (and 'pod' when present) shard the PERMUTATION range: each rank
    draws only its own global indices [lo, lo + per) from the counter-hash
    draws (core.permutations), which do not depend on the chunk, so no
    (n_perms, n) label tensor crosses ranks.
  * 'model' shards the ROWS of mat2 = D * D: each rank computes the partial
    columns of its row slab (engine.registry.get_sharded); the slabs are
    whole 64-row bands, so brute's partials are the whole matrix's bands.

Collectives carry only small tensors (per-permutation partial columns).
They are all-gathered and combined on every rank in rank order; there is
no all_reduce, whose summation order is not fixed, so the same world and
mesh give the same bits on every run. Under gloo a card's tensors travel
through host copies (transport only: the kernels run on the card).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core import fstat, permutations
from repro_torch.core import permanova as _permanova

BAND_ROWS = fstat.BAND_ROWS


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Zero-pad `axis` up to a multiple; (padded, pad)."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x, 0
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return torch.nn.functional.pad(x, widths), pad


def _perm_axes(mesh) -> tuple:
    """Every mesh axis but 'model', in the mesh's order."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


class Layout(NamedTuple):
    """Where each world rank sits: its permutation block (row-major over
    the permutation axes), its row slab ('model') and its study block
    ('data'). One entry per world rank, in rank order."""
    rank: int
    perm_ways: int
    model_ways: int
    data_ways: int
    perm_index: tuple       # per world rank
    model_index: tuple
    data_index: tuple

    @property
    def world(self) -> int:
        return len(self.perm_index)

    def first_rank(self, **where) -> int:
        """The lowest world rank at the given indices (perm=, model=,
        data=)."""
        for r in range(self.world):
            if all(getattr(self, f"{k}_index")[r] == v
                   for k, v in where.items()):
                return r
        raise ValueError(f"no rank at {where}")


ONE_HOST = Layout(0, 1, 1, 1, (0,), (0,), (0,))   # one rank, no collective


def layout(mesh) -> Layout:
    """The Layout of `mesh` over the world."""
    from repro_torch.launch import mesh as _mesh   # deferred: a leaf
    names = tuple(mesh.mesh_dim_names)
    shape = {a: _mesh.axis_size(mesh, a) for a in names}
    perm, model, data = [], [], []
    for r in range(dist.get_world_size()):
        c = _mesh.coordinate(mesh, r)
        idx = 0
        for a in _perm_axes(mesh):       # row-major linearization
            idx = idx * shape[a] + c[a]
        perm.append(idx)
        model.append(c.get("model", 0))
        data.append(c.get("data", 0))
    perm_ways = 1
    for a in _perm_axes(mesh):
        perm_ways *= shape[a]
    return Layout(dist.get_rank(), perm_ways, shape.get("model", 1),
                  shape.get("data", 1), tuple(perm), tuple(model),
                  tuple(data))


def _my_perm_range(lay: Layout, n_perms_padded: int):
    """(lo, per): this rank's global permutation indices [lo, lo + per)."""
    per = n_perms_padded // lay.perm_ways
    return lay.perm_index[lay.rank] * per, per


def rows_per_shard(n: int, model_ways: int) -> int:
    """Rows a 'model' rank holds: ceil(n / model_ways) up to whole 64-row
    bands (the last rank's slab ends at n and may be shorter or empty)."""
    rows = -(-n // model_ways)
    return -(-rows // BAND_ROWS) * BAND_ROWS


def row_slab(n: int, model_ways: int, model_index: int) -> tuple:
    """(r0, r1): the rows of mat2 the 'model' rank at `model_index` holds
    (rows_per_shard each; empty past n)."""
    rows = rows_per_shard(n, model_ways)
    r0 = min(n, model_index * rows)
    return r0, min(n, r0 + rows)


def all_gather(t: torch.Tensor, lay: Layout) -> List[torch.Tensor]:
    """Every world rank's `t` (one shape and dtype on all ranks), in rank
    order, on t's device. Under gloo a card's tensor is copied to the host
    for the collective and back."""
    if lay.world == 1:
        return [t]
    send = t.contiguous()
    host = dist.get_backend() == "gloo" and send.device.type != "cpu"
    if host:
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(lay.world)]
    dist.all_gather(parts, send)
    return [p.to(t.device) for p in parts] if host else parts


def resolve_impl(impl: str, n: int, n_perms: int, n_groups: int,
                 backend: str = "cuda") -> str:
    """An impl request ('auto' or a registry name) as the engine planner
    resolves it on `backend`."""
    from repro_torch import engine   # deferred: engine imports core
    pinned = None if impl == "auto" else impl
    return engine.plan(n, n_perms, backend=backend, impl=pinned,
                       n_groups=n_groups).impl


def sw_distributed(mesh, mat2: torch.Tensor, grouping: torch.Tensor,
                   inv_gs: torch.Tensor, n_perms: int, *,
                   impl: str = "matmul", seed: int = 0,
                   perms: Optional[torch.Tensor] = None,
                   chunk: Optional[int] = None,
                   memory_budget_bytes: Optional[float] = None):
    """s_W for global permutation indices [0, n_perms_padded) in their
    order (entry 0 the observed labels); n_perms_padded is n_perms up to
    a multiple of the permutation ways.

    Each rank sweeps its permutation range in chunks of `chunk` (default:
    the engine planner's for its range at n) over its row slab
    mat2[r0:r1], keeping each chunk's partial columns; one all-gather
    brings every rank's columns, and each chunk's s_W is the sum of its
    slabs' columns concatenated in row order, per chunk as one s_W launch
    sums its partials. perms: explicit (n_perms_padded, n) int32 labels
    (each rank slices its own rows). Returns ((n_perms_padded,) f32, the
    chunk)."""
    from repro_torch.engine import planner, registry, scheduler
    lay = layout(mesh)
    n = int(mat2.shape[0])
    n_padded = n_perms + (-n_perms) % lay.perm_ways
    if perms is not None and tuple(perms.shape) != (n_padded, n):
        raise ValueError(f"perms must be (n_perms padded to the "
                         f"{lay.perm_ways} permutation ways, n) = "
                         f"{(n_padded, n)}, got {tuple(perms.shape)}")
    lo, per = _my_perm_range(lay, n_padded)
    if chunk is None:
        chunk = planner.plan(n, per, backend=mat2.device.type, impl=impl,
                             memory_budget_bytes=memory_budget_bytes).chunk
    chunk = int(max(1, min(chunk, per)))
    # every slab's partial width, computed alike on every rank
    widths = [registry.sharded_width(impl, r1 - r0) for r0, r1 in (
        row_slab(n, lay.model_ways, m) for m in range(lay.model_ways))]
    r0, r1 = row_slab(n, lay.model_ways, lay.model_index[lay.rank])
    mine = mat2.new_zeros((per, max(widths)))
    if r1 > r0:     # a slab past n holds no rows, so no columns
        partial_fn = registry.get_sharded(impl)
        slab = mat2[r0:r1]
        cols = []
        for c0 in range(lo, lo + per, chunk):
            labels = scheduler._labels(
                grouping, c0, min(c0 + chunk, lo + per), seed=seed,
                perms=perms, draw_budget=memory_budget_bytes)
            cols.append(partial_fn(slab, r0, labels, inv_gs))
            del labels
        mine[:, :widths[lay.model_index[lay.rank]]] = torch.cat(cols)
    parts = all_gather(mine, lay)
    out = []
    for b in range(lay.perm_ways):
        full = torch.cat([parts[lay.first_rank(perm=b, model=m)][
            :, :widths[m]] for m in range(lay.model_ways)], dim=1)
        # chunk by chunk, each a fresh tensor: one launch's partials sum
        out += [blk.clone().sum(dim=1) for blk in full.split(chunk)]
    return torch.cat(out), chunk


def permanova_distributed(mesh, dm, grouping, *, n_perms: int = 999,
                          seed: int = 0,
                          perms: Optional[torch.Tensor] = None,
                          n_groups: Optional[int] = None,
                          impl: str = "auto", chunk: Optional[int] = None,
                          memory_budget_bytes: Optional[float] = None):
    """Distributed full PERMANOVA on a DeviceMesh (launch.mesh.make_mesh):
    core.permanova's test, up to the permutation count's padding, which
    only adds null draws (f_perms carries them).

    Every rank passes the same dm (n, n), grouping and arguments and gets
    the whole result. The rank's device is the mesh's (one host: a world
    of one, launch.mesh.world_of_one, with a (1, 1) mesh). Only plain
    single-factor designs run here; strata / covariate / weighted designs
    shard over the STUDY axis (engine.permanova_many(mesh=...)).
    impl: 'auto' (the engine planner) or a registry name; brute and tiled
    run brute's band partials (on the card its kernel's row-slab entry),
    matmul the one-hot partial. seed / perms: the port's draws, or
    explicit (n_perms + 1 padded to the permutation ways, n) labels.
    """
    from repro_torch.core import design as _design
    from repro_torch.launch import mesh as _mesh
    dev = _mesh.mesh_device(mesh)
    design = _design.Design.from_labels(grouping, n_groups=n_groups,
                                        device=dev)
    if not design.is_plain_labels:
        raise ValueError(
            "permanova_distributed shards matrix rows for plain "
            "single-factor designs; use engine.permanova_many(mesh=...) "
            "for strata/covariate/weighted designs")
    grouping = design.grouping.to(dev, torch.int32)
    n_groups = design.n_groups
    dm = torch.as_tensor(dm).to(dev, torch.float32)
    n = int(dm.shape[0])
    mat2 = dm * dm
    inv_gs = permutations.inv_group_sizes(grouping, n_groups)
    name = resolve_impl(impl, n, n_perms + 1, n_groups, dev.type)
    if perms is not None:
        perms = torch.as_tensor(perms)
    s_w_all, ch = sw_distributed(
        mesh, mat2, grouping, inv_gs, n_perms + 1, impl=name, seed=seed,
        perms=perms, chunk=chunk, memory_budget_bytes=memory_budget_bytes)
    s_t = _permanova.s_total(mat2)
    f_all = _permanova.f_from_sw(s_w_all, s_t, n, n_groups)
    lay = layout(mesh)
    return _permanova.PermanovaResult(
        f_stat=f_all[0], p_value=_permanova.p_value_from_null(f_all),
        s_t=s_t, s_w=s_w_all[0], f_perms=f_all, n_objects=n,
        n_groups=n_groups, n_perms=int(f_all.shape[0]) - 1,
        method=f"permanova_distributed[{name}]",
        plan=(f"{name} perms@{'x'.join(_perm_axes(mesh)) or '-'}"
              f"[{lay.perm_ways}] rows@model[{lay.model_ways}]"
              f"(rows={rows_per_shard(n, lay.model_ways)}) chunk={ch} "
              f"on {dev.type}"))
