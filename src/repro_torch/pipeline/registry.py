"""Distance-implementation registry (stage 1 of the pipeline).

Twin of `repro/pipeline/registry.py` for the in-memory distance impls:
every way the port turns an (n, d) abundance table into pairwise
distances sits behind one interface with the metadata the pipeline
planner dispatches on. Three kinds per metric:

  dense     single full-matrix torch form (Gram trick / broadcast)
  blocked   row-streaming torch form over the same row primitives
  cuda      the hand-written CUDA kernels (kernels/distance): rectangular,
            so they serve both dense construction and row slabs; on CPU
            tensors they run their plain versions

Every impl exposes both a dense form and a row-slab form, so the
planner's bridge choice (dense / stream) is orthogonal to the impl
choice. The reference's kernel kind is named `<metric>.pallas`; that name
is accepted as an alias of `<metric>.cuda`.

The fused registry (`FusedImpl`) holds the single-pass sweeps of the
fused-kernel bridge, two kinds per metric:

  cuda      the hand-written CUDA megakernel (kernels/fused_sw); alias
            `<metric>.fusedk.pallas`
  torch     the plain torch sweep over row blocks x permutation chunks;
            alias `<metric>.fusedk.xla`

The precision tags (`PRECISIONS`, `precision_tag`, `precision_tuning`,
`feat_element_bytes`) name the fused kernels' feature modes, and
`fused_feat_traffic_bytes` / `fused_workset_bytes` model what each mode
moves and holds, for `PipelinePlan.explain()`. The residency tiers
(`RESIDENCY_TIERS`, `tier_bandwidth_gbps`, `residency_tier`,
`ooc_disk_traffic_bytes`) grade where a slab cache's features live during
the sweep and what its out-of-core sweep reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Mapping, Optional, Tuple

from repro_torch.core import distance as _dist
from repro_torch.kernels.fused_sw import ops as _fops


# ---------------------------------------------------------------------------
# Residency tiers: one bandwidth model for every level the features can live
# at, down to disk (out-of-core slab streaming).
# ---------------------------------------------------------------------------

RESIDENCY_TIERS = ("vmem", "hbm", "host", "disk")
TIER_ENV_PREFIX = "REPRO_TORCH_TIER_GBPS_"

# On the card (GB/s). hbm: the STREAM triad kernel's measured rate
# (chip_smoke.py phase 16, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6
# row 10). host: pinned host-to-device copies of one 128 MiB slab by CUDA
# events (chip_smoke.py phase 21, same card and limit: 55.26 on one
# machine, 44.57 on another; pageable memory 5.43 and 4.74). disk: a
# model, not a
# measurement: an NVMe-class sequential read, the rate a cold cache
# streams at (a warm one reads from the page cache at the host rate).
# vmem has no counterpart: it is the TPU's on-chip vector memory, which
# its compiler stages features through; the card's kernels stage their
# tiles in shared memory themselves, and no plan keeps a feature table
# there, so asking for it on 'cuda' raises.
CUDA_TIER_GBPS = {"hbm": 3091.2, "host": 55.26, "disk": 2.0}
# On 'cpu', the reference's model (on-chip SRAM order of magnitude, the
# paper's MI300A CPU STREAM triad, DDR-class staging, NVMe-class disk),
# kept so a CPU plan explains as the reference's does; none of it was
# measured for this port.
CPU_TIER_GBPS = {"vmem": 22e3, "hbm": 209.0, "host": 64.0, "disk": 2.0}


def tier_bandwidth_gbps(tier: str, backend: str = "cuda") -> float:
    """Bandwidth of one residency tier in GB/s on `backend` ('cuda' or
    'cpu'); $REPRO_TORCH_TIER_GBPS_<TIER> overrides any of them."""
    if tier not in RESIDENCY_TIERS:
        raise ValueError(f"unknown residency tier {tier!r}; "
                         f"one of {RESIDENCY_TIERS}")
    override = os.environ.get(TIER_ENV_PREFIX + tier.upper())
    if override:
        return float(override)
    if backend == "cuda":
        if tier not in CUDA_TIER_GBPS:
            raise ValueError(
                "the 'vmem' tier is the TPU's on-chip vector memory; the "
                "card's kernels stage tiles in shared memory themselves "
                "and no plan keeps features there, so it has no bandwidth "
                "on 'cuda'")
        return CUDA_TIER_GBPS[tier]
    return CPU_TIER_GBPS[tier]


def backend_tiers(backend: str = "cuda") -> tuple:
    """The tiers that have a bandwidth on `backend` (no vmem on 'cuda')."""
    return tuple(t for t in RESIDENCY_TIERS
                 if backend != "cuda" or t in CUDA_TIER_GBPS)


def residency_tier(feature_bytes: float, *, device_budget_bytes: float,
                   host_budget_bytes: float) -> str:
    """Where the feature table LIVES during the sweep: 'hbm' while its f32
    form fits the device budget (read the cache once, then run the
    in-memory bridges), 'host' / 'disk' otherwise (out-of-core slab
    streaming; the two differ only in the bandwidth the traffic model
    charges: page-cache-warm against cold reads)."""
    if feature_bytes <= device_budget_bytes:
        return "hbm"
    if feature_bytes <= host_budget_bytes:
        return "host"
    return "disk"


def ooc_disk_traffic_bytes(n_slabs: int, disk_bytes: float) -> float:
    """Bytes read from the slab cache by ONE out-of-core sweep: per row
    slab, the row operand and then every column slab, (n_slabs + 1) passes
    over the on-disk table. Independent of n_perms: every permutation
    chunk consumes the live assembled row slab."""
    return float(disk_bytes) * (int(n_slabs) + 1)


@dataclasses.dataclass(frozen=True)
class DistanceImpl:
    """One distance implementation plus planner-facing metadata.

    make_prepare(**tuning) -> prepare(x) -> xprep        one-off transform
    make_rows(**tuning)    -> rows(xb, xprep) -> (b, n)  row slab
    make_dense(**tuning)   -> dense(x) -> (n, n)         full matrix
    """
    name: str                      # "<metric>.<kind>"
    metric: str
    kind: str                      # 'dense' | 'blocked' | 'cuda'
    backends: Tuple[str, ...]      # backends where this form is performant
    tuning: Mapping[str, int]
    make_prepare: Callable[..., Callable]
    make_rows: Callable[..., Callable]
    make_dense: Callable[..., Callable]
    workset_bytes: Callable[[int, int, int], int]
    # (n, d, row_block) -> peak TRANSIENT bytes beyond inputs/outputs
    description: str = ""

    def bound(self, **overrides):
        """(prepare, rows, dense) callables with tuning resolved (defaults
        <- overrides, unknown keys dropped)."""
        kw = {k: v for k, v in {**self.tuning, **overrides}.items()
              if k in self.tuning}
        key = (self.name, tuple(sorted(kw.items())))
        fns = _BOUND_CACHE.get(key)
        if fns is None:
            fns = _BOUND_CACHE[key] = (self.make_prepare(**kw),
                                       self.make_rows(**kw),
                                       self.make_dense(**kw))
        return fns


_REGISTRY: dict = {}
_BOUND_CACHE: dict = {}
ALIASES: dict = {}          # '<metric>.pallas' -> '<metric>.cuda'


def register(impl: DistanceImpl) -> DistanceImpl:
    if impl.name in _REGISTRY:
        raise ValueError(f"duplicate distance impl {impl.name!r}")
    _REGISTRY[impl.name] = impl
    return impl


def get(name: str) -> DistanceImpl:
    """The impl registered as `name` (or as its `.pallas` alias)."""
    try:
        return _REGISTRY[ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown distance impl {name!r}; registered: "
            f"{sorted(_REGISTRY)}, aliases: {sorted(ALIASES)}") from None


def names(*, metric: Optional[str] = None, backend: Optional[str] = None,
          kind: Optional[str] = None):
    """Registered impl names, optionally filtered by capability."""
    out = []
    for n, impl in _REGISTRY.items():
        if metric is not None and impl.metric != metric:
            continue
        if backend is not None and backend not in impl.backends:
            continue
        if kind is not None and impl.kind != kind:
            continue
        out.append(n)
    return sorted(out)


def metrics():
    return sorted({impl.metric for impl in _REGISTRY.values()})


# ---------------------------------------------------------------------------
# Registration.
# ---------------------------------------------------------------------------

def _const(fn):
    def make(**_tuning):
        return fn
    return make


def _make_true_dense(metric):
    """Single-shot full-matrix form: all rows against all rows in one call
    (O(n*n[*d]) transients, as the workset model charges)."""
    mdef = _dist.ROW_METRICS[metric]

    def make(**_tuning):
        def dense(x):
            xp = mdef.prepare(x)
            return _dist._zero_diag(mdef.rows(xp, xp))
        return dense
    return make


def _make_dense_from_rows(metric):
    mdef = _dist.ROW_METRICS[metric]

    def make(**tuning):
        block = tuning.get("block", 256)

        def dense(x):
            xp = mdef.prepare(x)
            return _dist._zero_diag(
                _dist._blocked_rows(mdef.rows, xp, block))
        return dense
    return make


def _kernel_metric(metric):
    # aitchison is euclidean over clr features (its prepare)
    return "euclidean" if metric == "aitchison" else metric


def _make_cuda_rows(metric):
    def make(**tuning):
        from repro_torch.kernels.distance import ops

        def rows(xb, xprep):
            return ops.pairwise_distance_rows(
                xb, xprep, metric=_kernel_metric(metric), **tuning)
        return rows
    return make


def _make_cuda_dense(metric):
    def make(**tuning):
        from repro_torch.kernels.distance import ops
        prep = _dist.ROW_METRICS[metric].prepare

        def dense(x):
            return ops.pairwise_distance(
                prep(x), metric=_kernel_metric(metric), **tuning)
        return dense
    return make


def _ws_dense_gram(n, d, _block):
    # full Gram product + squared-distance intermediate
    return 8 * n * n


def _ws_dense_broadcast(n, d, block):
    # (block, n, d) broadcast intermediates (x2: |.|, +)
    return 8 * block * n * d


def _ws_rows_gram(n, d, block):
    return 8 * block * n


def _ws_rows_broadcast(n, d, block):
    return 8 * block * n * d


def _ws_kernel(n, d, block):
    # the reference's Pallas model (accumulators at output size), kept so
    # the planner's row blocks match the reference's plans
    return 12 * min(block, n) * n


def _register_metric(metric, *, rows_ws, dense_ws, dense_backends,
                     blocked_backends):
    mdef = _dist.ROW_METRICS[metric]
    register(DistanceImpl(
        name=f"{metric}.dense", metric=metric, kind="dense",
        backends=dense_backends, tuning={},
        make_prepare=_const(mdef.prepare), make_rows=_const(mdef.rows),
        make_dense=_make_true_dense(metric),
        workset_bytes=dense_ws,
        description=f"single full-matrix torch {metric} (maximum parallel "
                    "width, largest transients)",
    ))
    register(DistanceImpl(
        name=f"{metric}.blocked", metric=metric, kind="blocked",
        backends=blocked_backends, tuning={"block": 256},
        make_prepare=_const(mdef.prepare), make_rows=_const(mdef.rows),
        make_dense=_make_dense_from_rows(metric),
        workset_bytes=rows_ws,
        description=f"row-streaming torch {metric} (bounded working set; "
                    "feeds the stream bridge)",
    ))
    register(DistanceImpl(
        name=f"{metric}.cuda", metric=metric, kind="cuda",
        backends=("cuda",),
        # packed=1 switches jaccard to 32-bit presence words + popcount
        # (bit-identical distances, 32x fewer feature bytes)
        tuning={"packed": 0} if metric == "jaccard" else {},
        make_prepare=_const(mdef.prepare),
        make_rows=_make_cuda_rows(metric),
        make_dense=_make_cuda_dense(metric),
        workset_bytes=_ws_kernel,
        description=f"hand-written CUDA {metric} kernel (64 x 64 output "
                    "tiles, feature loop in registers; plain torch on CPU "
                    "tensors)",
    ))
    ALIASES[f"{metric}.pallas"] = f"{metric}.cuda"


# euclidean / aitchison / jaccard: Gram-trick forms are BLAS-native.
for _metric in ("euclidean", "aitchison"):
    _register_metric(_metric, rows_ws=_ws_rows_gram, dense_ws=_ws_dense_gram,
                     dense_backends=("cpu", "cuda"),
                     blocked_backends=("cpu", "cuda"))
# braycurtis: the broadcast form has (block, n, d) transients — blocked is
# the CPU winner, dense the card's (paper Fig. 1 transplanted to stage 1).
_register_metric("braycurtis", rows_ws=_ws_rows_broadcast,
                 dense_ws=_ws_dense_broadcast, dense_backends=("cuda",),
                 blocked_backends=("cpu", "cuda"))
_register_metric("jaccard", rows_ws=_ws_rows_gram, dense_ws=_ws_dense_gram,
                 dense_backends=("cpu", "cuda"),
                 blocked_backends=("cpu", "cuda"))


# ---------------------------------------------------------------------------
# Precision knobs shared by the fused kernels and the traffic models.
# ---------------------------------------------------------------------------

PRECISIONS = ("f32", "bf16", "fp8", "packed")


def precision_tag(tuning) -> str:
    """Canonical precision tag of a fused tuning dict (reporting
    vocabulary; packed > fp8 > bf16 > f32)."""
    t = tuning or {}
    if t.get("feat_packed"):
        return "packed"
    if t.get("feat_fp8"):
        return "fp8"
    if t.get("feat_bf16"):
        return "bf16"
    return "f32"


def precision_tuning(tag: str) -> dict:
    """The fused tuning-knob dict selecting a precision tag."""
    if tag not in PRECISIONS:
        raise ValueError(f"unknown precision {tag!r}; one of {PRECISIONS}")
    return {"feat_bf16": int(tag == "bf16"), "feat_fp8": int(tag == "fp8"),
            "feat_packed": int(tag == "packed")}


def feat_element_bytes(tuning) -> float:
    """Bytes moved per FEATURE element at the tuning dict's precision
    (packed: 32 presence bits per 32-bit word = 1/8 byte each)."""
    return {"f32": 4.0, "bf16": 2.0, "fp8": 1.0,
            "packed": 0.125}[precision_tag(tuning)]


# ---------------------------------------------------------------------------
# Fused-kernel (single-pass distance -> s_W) implementation registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedImpl:
    """One single-pass distance -> s_W implementation (the fused-kernel
    bridge) plus planner-facing metadata.

    Unlike DistanceImpl, a fused impl produces no distance operand at all:
    it runs the whole features -> s_W sweep (pipeline.streaming's
    `fused_kernel_sw` dispatches on `kind`). `workset_bytes(n, d, chunk,
    n_groups, row_block, n_cols=None)` models its peak device residency
    beyond the (n, d) features; n_cols = K for a dense design.
    `chunk_quantum` is the number of permutations the impl applies in one
    pass: a chunk past it costs whole passes, so the planner sizes a
    labels chunk in multiples of it.
    """
    name: str                      # "<metric>.fusedk.<kind>"
    metric: str
    kind: str                      # 'cuda' | 'torch'
    backends: Tuple[str, ...]      # backends where this form is performant
    tuning: Mapping[str, int]
    workset_bytes: Callable[..., int]
    kernel_metric: str             # kernel body (aitchison -> euclidean)
    description: str = ""
    chunk_quantum: int = 1


_FUSED_REGISTRY: dict = {}
FUSED_ALIASES: dict = {}    # the reference's kind names -> the port's


def register_fused(impl: FusedImpl) -> FusedImpl:
    if impl.name in _FUSED_REGISTRY:
        raise ValueError(f"duplicate fused impl {impl.name!r}")
    _FUSED_REGISTRY[impl.name] = impl
    return impl


def get_fused(name: str) -> FusedImpl:
    """The fused impl registered as `name` (or as its reference alias:
    '.fusedk.pallas' -> '.fusedk.cuda', '.fusedk.xla' -> '.fusedk.torch')."""
    try:
        return _FUSED_REGISTRY[FUSED_ALIASES.get(name, name)]
    except KeyError:
        raise KeyError(
            f"unknown fused impl {name!r}; registered: "
            f"{sorted(_FUSED_REGISTRY)}, aliases: "
            f"{sorted(FUSED_ALIASES)}") from None


def fused_names(*, metric: Optional[str] = None,
                backend: Optional[str] = None,
                kind: Optional[str] = None):
    """Registered fused-kernel impl names, filtered by capability."""
    out = []
    for n, impl in _FUSED_REGISTRY.items():
        if metric is not None and impl.metric != metric:
            continue
        if backend is not None and backend not in impl.backends:
            continue
        if kind is not None and impl.kind != kind:
            continue
        out.append(n)
    return sorted(out)


def fused_cuda_workset(n: int, chunk: int, n_cols=None) -> dict:
    """What the card's fused-kernel sweep (a whole-table call) holds at
    `chunk`, by part, in bytes: 'partials', the kernel's workspace (one
    s_W value per (slot, permutation), or one (P, K) row per slot for a
    dense design, at most SW_SLOTS or COLS_SLOTS slots, and the slots'
    f64 totals) and its output; 'labels', the (chunk, n) int32 labels,
    or for a dense design 'index' and 'basis', the (chunk, n) int32
    index permutations and the (chunk, n, K) f32 basis they gather.
    Nothing grows with n^2. The label or index draw comes on top, in
    what the budget leaves (pipeline.planner)."""
    if n_cols is None:
        return {"partials": _fops.workspace_bytes(n, n, chunk,
                                                  symmetric=True),
                "labels": 4 * chunk * n}
    return {"partials": _fops.cols_workspace_bytes(n, n, chunk, n_cols,
                                                   symmetric=True),
            "index": 4 * chunk * n, "basis": 4 * chunk * n * n_cols}


def _ws_fused_cuda(n, d, chunk, n_groups, row_block, n_cols=None):
    return sum(fused_cuda_workset(n, chunk, n_cols).values())


def _ws_fused_torch(n, d, chunk, n_groups, row_block, n_cols=None):
    # one (row_block, n) D^2 slab + the (chunk, n, G) one-hot factor (the
    # (chunk, n, K) basis factor for a dense design)
    cols = n_groups if n_cols is None else n_cols
    return 4 * row_block * n + 4 * chunk * n * (cols + 1)


for _metric in ("euclidean", "aitchison", "braycurtis", "jaccard"):
    _kmetric = _kernel_metric(_metric)
    # the precision knobs (mutually exclusive): feat_bf16 halves the
    # feature bytes, feat_fp8 quarters them (one per-study scale, f32
    # accumulation), feat_packed (jaccard only) cuts them 32x with 32-bit
    # presence words and bit-identical results
    _prec = {"feat_bf16": 0, "feat_fp8": 0}
    if _kmetric == "jaccard":
        _prec["feat_packed"] = 0
    register_fused(FusedImpl(
        name=f"{_metric}.fusedk.cuda", metric=_metric, kind="cuda",
        backends=("cuda",), tuning=dict(_prec),
        workset_bytes=_ws_fused_cuda, kernel_metric=_kmetric,
        chunk_quantum=_fops.SW_PASS,
        description=f"hand-written CUDA megakernel: {_metric} D^2 tiles "
                    "built and contracted in registers, D^2 never in "
                    "device memory (feat_bf16/feat_fp8/feat_packed shrink "
                    "the feature loads 2x/4x/32x; plain torch on CPU "
                    "tensors)",
    ))
    register_fused(FusedImpl(
        name=f"{_metric}.fusedk.torch", metric=_metric, kind="torch",
        backends=("cpu",), tuning=dict(_prec),
        workset_bytes=_ws_fused_torch, kernel_metric=_kmetric,
        description=f"plain torch {_metric} sweep: loops over row blocks x "
                    "permutation chunks (the off-card fused-kernel form; "
                    "precision knobs round-trip the feature table)",
    ))
    FUSED_ALIASES[f"{_metric}.fusedk.pallas"] = f"{_metric}.fusedk.cuda"
    FUSED_ALIASES[f"{_metric}.fusedk.xla"] = f"{_metric}.fusedk.torch"


def fused_feat_traffic_bytes(spec: FusedImpl, n: int, d: int, tuning=None,
                             row_block: int = 256) -> float:
    """Modelled feature bytes loaded for ONE permutation chunk's sweep at
    the tuning dict's precision.

    CUDA megakernel: each 64 x 64 tile it visits stages its 64 rows' and 64
    columns' features (in 32-element chunks) at the mode's element width,
    and the sweep's whole-table call visits the tiles j >= i only, so
    traffic = bpe * d * nt (nt + 1) / 2 * (64 + 64), nt = ceil(n / 64)
    (loads the kernel issues; most are served from L2). The same for the
    dense-design kernel, whose blocks stage the same tiles. Torch sweep
    (the reference's XLA kind): each row block re-reads the full table
    once, 4 * d * n * (ceil(n / row_block) + 1); its precision knobs are
    value round trips (the table stays f32), so no traffic credit. A
    reporting model (plan.explain), not a hardware counter."""
    t = {**dict(spec.tuning), **(tuning or {})}
    if spec.kind == "cuda":
        nt = -(-n // _fops.TILE)
        return (feat_element_bytes(t) * d * nt * (nt + 1) / 2
                * (2 * _fops.TILE))
    return 4.0 * d * n * (-(-n // max(int(row_block), 1)) + 1)


def fused_workset_bytes(spec: FusedImpl, n: int, d: int, chunk: int,
                        n_groups: int, row_block: int, tuning=None,
                        n_cols=None) -> float:
    """Precision-aware device residency: the base workset_bytes plus what
    the precision adds. CUDA megakernel: the feature table quantized once
    at the mode's element width (f32 reads the table in place; the staged
    tiles are f32 in shared memory in every mode). Torch sweep: one
    round-tripped f32 copy of the table when a knob is on."""
    base = spec.workset_bytes(n, d, chunk, n_groups, row_block, n_cols)
    t = {**dict(spec.tuning), **(tuning or {})}
    if precision_tag(t) == "f32":
        return base
    if spec.kind == "cuda":
        return base + feat_element_bytes(t) * n * d
    return base + 4.0 * n * d
