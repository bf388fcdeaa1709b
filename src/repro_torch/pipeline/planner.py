"""Joint two-stage planner: distance construction + s_W under ONE plan.

Twin of `repro/pipeline/planner.py` for in-memory features. It decides,
in one place:

  stage 1   which distance impl (dense / blocked / cuda per backend and
            transient-memory model), and its row-block size
  bridge    the materialization: 'dense' (D then mat2 — two (n, n)
            transients), 'stream' (square row blocks into ONE mat2
            buffer), 'fused' (no (n, n) array: mat2 row slabs feed the
            permutation chunks directly) or, when not even one (n, n)
            buffer fits the matrix budget, 'fused-kernel' (single pass:
            distance tiles built AND contracted inside one kernel, D²
            never in device memory)
  fused     for 'fused-kernel', which single-pass impl runs it and its
            tuning (registry defaults <- caller knobs), the precision
            knobs among them (validated here: mutually exclusive, packed
            for jaccard only, and only on the fused-kernel bridge)
  stage 2   the engine Plan (impl + streaming chunk) for s_W, delegated to
            repro_torch.engine.planner (for a dense design, `design_cols`
            = K basis columns: the per-column companion and a chunk sized
            for the (chunk, n, K) basis factor)

Features in a slab cache (`features_on_disk`) are graded by residency
tier: 'hbm' while the f32 table fits `device_budget_bytes` (the ordinary
resident plan), else 'host' / 'disk', the out-of-core sweep, with the
reference's rules: the row block IS the cache's slab height, 'auto'
becomes the fused-kernel form, which out of core is the torch sweep over
the assembled row slabs (the megakernel needs resident features: pinning
it raises, as do the dense and stream bridges and a precision knob). On
the card the out-of-core plan also models the sweep's device footprint
(`ooc_footprint`: feature slabs in flight, the mat2 row slab, the tiles,
the label chunk's transients; `ooc_peak_bytes` their peak) and raises
where it exceeds the device budget.

On 'cuda' stage 1 is always `<metric>.cuda` and the fused-kernel sweep
`<metric>.fusedk.cuda`: the kernels mask ragged shapes, so the TPU's
tile-viability floor (PALLAS_MIN_N) has no counterpart, just as
engine.planner sends 'cuda' to the brute kernel. Its chunk, for labels and
for a dense design alike, is sized by the kernel's own workset (partials,
labels or index and basis) in whole passes, not by the reference's one-hot
block, which that kernel never builds; the label or index draw shares the
same budget: its sub-blocks get what the workset and a small slack leave
(`draw_budget`), and the chunk is the whole-pass chunk of least modelled
time (launches against draw sub-blocks), so the bridge holds at most
`memory_budget_bytes` beside its features. On 'cpu'
the plans match the reference's field for field (the fused impl under the
port's kind names). `explain()` adds the reference's per-precision table
of feature traffic and workset, and on the card the workset's split.

`plan_pipeline()` is shape/backend arithmetic, like `engine.plan()`; a
persisted stage-1 or fused-kernel shoot-out for this device kind and n
bucket (autotune_stage1 / autotune_fused, in engine.planner's cache)
becomes its default. On 'cuda' each shoot-out has one candidate, the
kernel (`<metric>.cuda`, `<metric>.fusedk.cuda`): the torch forms are its
plain twins, so it measures and persists that entry and changes no plan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import permutations as _perm
from repro_torch.data.slabcache import PREFETCH_DEPTH
from repro_torch.engine import planner as _eplanner
from repro_torch.kernels import ShapeNotSupported
from repro_torch.kernels.fused_sw import ops as _fops
from repro_torch.kernels.fused_sw import ref as _fref
from repro_torch.pipeline import registry as _dreg

PRECISION_KNOBS = ("feat_bf16", "feat_fp8", "feat_packed")

# Matrix-residency budget for the bridge decision. Distinct from the engine's
# label budget: this one governs the O(n^2) distance operands.
DEFAULT_MATRIX_BUDGET_BYTES = 1024 * 1024 ** 2
# Transient slab budget for picking the row block (and the dense/blocked
# stage-1 cut on CPU, standing in for the paper's LLC argument).
DEFAULT_SLAB_BUDGET_BYTES = 128 * 1024 ** 2
MIN_ROW_BLOCK = 8
MAX_ROW_BLOCK = 4096
# What a card's fused-kernel sweep holds beside its workset and draw: the
# (n_total,) results, inv_gs and the fp8 scale, and the caching
# allocator's rounding (a request of more than 1 MiB may take a cached
# block up to 1 MiB larger than it asked for). chip_smoke.py phase 17
# holds the bridge's whole peak under the budget. A budget of a few MiB
# holds only small requests, which the allocator rounds to 512 B: there
# the slack is a sixteenth of the budget (sweep_slack).
SWEEP_SLACK_BYTES = 4 * 1024 ** 2
# The card's fused-kernel plan weighs a chunk's launches against its
# draw's sub-blocks. Each launch repeats the kernel's feature phase, which
# grows with the pairs and the features: `fused_sw` / `fused_sw_cols` at
# P = 1 take 9.881 / 9.754 ms at n = 25,145, d = 128 (chip_smoke.py phases
# 10 and 13), so a launch is modelled as LAUNCH_MS_EMP (n / 25,145)^2 d /
# 128. A draw sub-block takes the longer of the host's dispatch of its ~40
# small launches (DRAW_SUB_BLOCK_MS: the free draw 1.4-2.0 ms at 1 to 107
# rows, one host; 1.8-3.5 on another) and the card's work on its rows
# (DRAW_ROW_MS_EMP a row of 25,145 samples, scaled by n: 54.3 ms for 17
# sub-blocks of 158 rows); chip_smoke.py phase 4. NVIDIA H100 80GB HBM3
# at 700 W.
LAUNCH_MS_EMP, LAUNCH_N, LAUNCH_D = 9.8, 25145, 128
DRAW_SUB_BLOCK_MS, DRAW_ROW_MS_EMP = 1.9, 0.02
DRAW_KINDS = ("labels", "strata")

MATERIALIZE_MODES = ("dense", "stream", "fused", "fused-kernel")
FUSED_MODES = ("fused", "fused-kernel")
# Residency budgets for the out-of-core decision: the f32 feature table
# must fit the device budget to run the resident bridges; the host budget
# only grades the bandwidth model (page-cache-warm against cold reads).
DEFAULT_DEVICE_BUDGET_BYTES = 2 * 1024 ** 3
DEFAULT_HOST_BUDGET_BYTES = 32 * 1024 ** 3


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A resolved features->p-value execution plan."""
    metric: str
    dist_impl: str                # distance registry name
    dist_tuning: Dict[str, int]
    materialize: str              # 'dense' | 'stream' | 'fused' |
                                  # 'fused-kernel'
    row_block: int
    sw: _eplanner.Plan            # stage-2 engine plan
    backend: str
    reason: str
    fused_impl: Optional[str] = None      # fused registry name when the
                                          # bridge is 'fused-kernel'
    fused_tuning: Dict[str, int] = dataclasses.field(default_factory=dict)
    n: int = 0                            # problem shape
    d: int = 0
    n_groups: int = 0
    n_cols: Optional[int] = None          # a dense design's basis width K
    draw_budget: Optional[float] = None   # card's fused-kernel plans: the
                                          # bytes its workset leaves the
                                          # label / index draws
    draw: str = "labels"                  # their kind (a dense design's:
                                          # 'index')
    budget: Optional[float] = None        # the label budget they share
    residency: str = "hbm"                # where the features LIVE during
                                          # the sweep (registry tier)
    slab_rows: int = 0                    # a slab cache's slab height
    disk_bytes: int = 0                   # its on-disk footprint
    ooc_footprint: Optional[Dict[str, int]] = None  # card's out-of-core
                                          # plans: the sweep's device
                                          # footprint by part
    device_budget: Optional[float] = None  # the budget its peak is held to

    @property
    def ooc_peak(self) -> Optional[int]:
        """The out-of-core footprint's peak (ooc_peak_bytes), or None."""
        if self.ooc_footprint is None:
            return None
        return ooc_peak_bytes(self.ooc_footprint)

    def explain(self) -> str:
        """describe() plus, for a slab cache below 'hbm', the residency
        line, the tier bandwidth table, the predicted slab-cache traffic
        and on the card the sweep's device footprint; then the
        precision-aware memory model of a fused-kernel plan: the predicted
        feature bytes per permutation chunk and the workset for each
        precision of the planned fused impl, the planned one marked; on
        the card, the workset's split (partials and their slots, labels or
        index and basis, the draw's sub-blocks) against the budget."""
        lines = [self.describe()]
        if self.residency != "hbm" and self.slab_rows and self.n:
            lines += self.residency_lines()
        if self.materialize != "fused-kernel" or not self.fused_impl \
                or not self.n:
            return "\n".join(lines)
        spec = _dreg.get_fused(self.fused_impl)
        if spec.kind == "cuda" and self.draw_budget is not None:
            lines.append(self.workset_split())
        planned = _dreg.precision_tag(self.fused_tuning)
        lines.append(
            f"predicted feature traffic per permutation chunk "
            f"(n={self.n}, d={self.d}, {spec.kind} kind):")
        for tag in _dreg.PRECISIONS:
            if tag == "packed" and spec.kernel_metric != "jaccard":
                continue
            t = {**self.fused_tuning, **_dreg.precision_tuning(tag)}
            traffic = _dreg.fused_feat_traffic_bytes(
                spec, self.n, self.d, t, self.row_block)
            workset = _dreg.fused_workset_bytes(
                spec, self.n, self.d, self.sw.chunk, self.n_groups,
                self.row_block, t, self.n_cols)
            mark = "  <- planned" if tag == planned else ""
            lines.append(f"  {tag:>6}: {traffic/2**20:9.2f} MiB feat "
                         f"traffic, {workset/2**20:8.3f} MiB workset{mark}")
        return "\n".join(lines)

    def residency_lines(self) -> list:
        """The out-of-core plan's residency, tier bandwidths, predicted
        slab-cache traffic and (on the card) device footprint."""
        n_slabs = -(-self.n // self.slab_rows)
        traffic = _dreg.ooc_disk_traffic_bytes(n_slabs, self.disk_bytes)
        gbps = _dreg.tier_bandwidth_gbps(self.residency, self.backend)
        lines = [
            f"residency: {self.residency} (features "
            f"{4 * self.n * self.d / 2**20:.0f} MiB f32 exceed the "
            f"device budget; {n_slabs} slabs x {self.slab_rows} rows)",
            "tier bandwidth model (GB/s): " + ", ".join(
                f"{t}={_dreg.tier_bandwidth_gbps(t, self.backend):.1f}"
                for t in _dreg.backend_tiers(self.backend)),
            f"predicted slab-cache traffic per sweep: "
            f"{traffic / 2**20:.1f} MiB ({n_slabs + 1} passes over "
            f"{self.disk_bytes / 2**20:.1f} MiB on disk, independent "
            f"of n_perms), ~{traffic / (gbps * 1e9) * 1e3:.1f} ms at "
            f"the {self.residency} tier"]
        if self.ooc_footprint is not None:
            split = ", ".join(f"{k} {v / 2 ** 20:.2f}MiB"
                              for k, v in self.ooc_footprint.items())
            lines.append(
                f"sweep device footprint: {split}; peak (the slab and the "
                f"label phase never overlap) {self.ooc_peak / 2 ** 20:.2f}"
                f"MiB of {self.device_budget / 2 ** 20:.2f}MiB")
        return lines

    def workset_split(self) -> str:
        """The card's fused-kernel workset at the plan's chunk, by part,
        with the draw's sub-blocks (beside what the sweep holds while it
        draws: all but a dense design's basis), the sweep's slack and the
        peak they make against the budget."""
        parts = _dreg.fused_cuda_workset(self.n, self.sw.chunk, self.n_cols)
        slots = _fops.n_slots(self.n, self.n, True, "fused_sw"
                              if self.n_cols is None else "fused_sw_cols")
        rows = min(_perm.draw_rows(self.n, self.draw_budget, self.draw),
                   self.sw.chunk)
        draw = _perm.draw_transient_bytes(rows, self.n, self.draw)
        slack = sweep_slack(self.budget)
        peak = max(sum(parts.values()), _at_draw(parts) + draw) + slack
        split = ", ".join(f"{k} {v / 2 ** 20:.2f}MiB"
                          for k, v in parts.items())
        return (f"kernel workset at chunk {self.sw.chunk}: {split} "
                f"({slots} slots); {self.draw} draw {draw / 2 ** 20:.2f}MiB "
                f"({rows} rows of {self.n}) beside "
                f"{_at_draw(parts) / 2 ** 20:.2f}MiB of it; slack "
                f"{slack / 2 ** 20:.2f}MiB; peak {peak / 2 ** 20:.2f}MiB of "
                f"{self.budget / 2 ** 20:.2f}MiB")

    def describe_stage1(self) -> str:
        """Stage 1 + bridge only — what the pipeline itself executes; the
        dense/stream bridges delegate stage 2 to engine.run, whose plan
        record is authoritative there."""
        if self.materialize == "fused-kernel":
            t = ",".join(f"{k}={v}"
                         for k, v in sorted(self.fused_tuning.items()))
            return (f"{self.fused_impl}[{t}] -> fused-kernel"
                    f"(rows={self.row_block})")
        t = ",".join(f"{k}={v}" for k, v in sorted(self.dist_tuning.items()))
        return (f"{self.dist_impl}[{t}] -> {self.materialize}"
                f"(rows={self.row_block})")

    def describe(self) -> str:
        return (f"{self.describe_stage1()} -> {self.sw.describe()}"
                f" | {self.reason}")


def _pick_dist_impl(metric: str, backend: str, n: int, d: int,
                    slab_budget: float):
    """Stage-1 impl by capability + transient model (Fig. 1 transplanted:
    bounded-working-set forms on CPU, the hand-written kernel on the
    card). A persisted stage-1 shoot-out overrides the model."""
    if metric not in _dreg.metrics():
        raise KeyError(f"unknown metric {metric!r}; "
                       f"registered: {_dreg.metrics()}")
    measured = measured_stage1(backend, metric, n)
    if measured is not None:
        return measured, ("persisted stage-1 autotune measurement "
                          f"({_eplanner.autotune_cache_path()})")
    if backend == "cuda":
        return (f"{metric}.cuda",
                "hand-written CUDA kernel (masks ragged shapes, so no "
                "tile-viability floor)")
    dense = _dreg.get(f"{metric}.dense")
    # only consider the dense form where it is registered as performant
    dense_ok = backend in dense.backends
    dense_ws = dense.workset_bytes(n, d, n)
    if dense_ok and dense_ws <= min(slab_budget, _eplanner.CPU_LLC_BYTES):
        return (f"{metric}.dense",
                f"dense transients {dense_ws/2**20:.0f}MiB fit the cache "
                "model; single full-matrix form")
    why = (f"dense transients {dense_ws/2**20:.0f}MiB spill the slab/cache "
           "budget" if dense_ok else
           f"dense form not registered for backend {backend!r}")
    return (f"{metric}.blocked",
            f"{why}; row-streaming form (Fig. 1 tiled analogue)")


def _pick_materialize(n: int, matrix_budget: float, metric: str):
    dense_bytes = 8 * n * n      # D + mat2 both live transiently
    mat2_bytes = 4 * n * n
    if dense_bytes <= matrix_budget:
        return "dense", (f"D+mat2 {dense_bytes/2**20:.0f}MiB fit the "
                         "matrix budget")
    if mat2_bytes <= matrix_budget:
        return "stream", (f"mat2 {mat2_bytes/2**20:.0f}MiB fits but D+mat2 "
                          "would not; stream row blocks into one buffer")
    why = (f"even one (n,n) buffer {mat2_bytes/2**20:.0f}MiB exceeds the "
           "matrix budget")
    if _dreg.fused_names(metric=metric):
        return "fused-kernel", (f"{why}; single-pass sweep (distance tiles "
                                "contracted in-kernel, D² never resident)")
    return "fused", f"{why}; fuse row slabs into the permutation sweep"


def _pick_fused_impl(metric: str, backend: str, n: int,
                     tuning: Optional[Dict[str, int]] = None):
    """Fused-kernel impl: a persisted shoot-out winner (at the requested
    precision), else the CUDA megakernel on the card (it masks ragged
    shapes, so for every n), the plain torch sweep elsewhere."""
    measured = measured_fused(backend, metric, n, tuning)
    if measured is not None:
        return measured, "persisted fused-kernel autotune measurement"
    if backend == "cuda":
        return (f"{metric}.fusedk.cuda",
                "hand-written CUDA megakernel (masks ragged shapes, so no "
                "tile-viability floor)")
    return (f"{metric}.fusedk.torch",
            "one-pass torch sweep (no kernel path on this backend)")


def _resolve_fused(metric: str, backend: str, fused_impl: Optional[str],
                   n: int, tuning: Optional[Dict[str, int]] = None):
    """(fused registry name or alias, reason): the backend's pick for
    'auto' / None, else the caller's impl ('cuda', 'torch', the
    reference's 'pallas' / 'xla', or a registry name)."""
    if fused_impl in (None, "auto"):
        return _pick_fused_impl(metric, backend, n, tuning)
    name = (fused_impl if "." in fused_impl
            else f"{metric}.fusedk.{fused_impl}")
    return name, "caller-pinned fused impl"


def _onehot_chunk(n: int, cols: int, n_perms: int, budget: float) -> int:
    """The reference's fused chunk: its working set is the one-hot block
    (chunk, n, G) and its (n, chunk*G) reshape; a dense design's basis
    factor swaps G for K."""
    per_perm = 4.0 * n * (2 * cols + 1)
    return int(max(1, min(budget // per_perm, n_perms)))


def sweep_slack(budget: float) -> float:
    """The bytes a card's fused-kernel plan keeps from `budget` for what
    its sweep holds beside the workset and the draw."""
    return min(SWEEP_SLACK_BYTES, budget / 16)


def _pass_chunks(n_perms: int, quantum: int, n_cols: Optional[int]):
    """The whole-pass chunks below n_perms, ascending, then n_perms: a
    labels chunk is a multiple of `quantum` permutations; a design chunk
    the most permutations whose n_cols columns fill m passes of Q_PASS
    (at least one pass's worth)."""
    if n_cols is None:
        return list(range(quantum, n_perms, quantum)) + [n_perms]
    need = -(-_fops.Q_PASS // n_cols)
    out, m = [], 1
    while True:
        c = max(need, m * _fops.Q_PASS // n_cols)
        if c >= n_perms:
            return sorted(set(out)) + [n_perms]
        out.append(c)
        m += 1


def _draw_sub_blocks(n_perms: int, chunk: int, rows: int) -> int:
    """Sub-blocks the draws of n_perms permutations take in chunks of
    `chunk`, `rows` a sub-block."""
    full, last = divmod(n_perms, chunk)
    return full * -(-chunk // rows) + -(-last // rows)


def _draw_ms(n: int, n_perms: int, chunk: int, rows: int) -> float:
    """Modelled time of those draws: each sub-block the longer of
    DRAW_SUB_BLOCK_MS and its rows at DRAW_ROW_MS_EMP (scaled by n)."""
    row_ms = DRAW_ROW_MS_EMP * n / LAUNCH_N

    def chunk_ms(c):
        q, r = divmod(c, rows)
        return (q * max(DRAW_SUB_BLOCK_MS, rows * row_ms)
                + (max(DRAW_SUB_BLOCK_MS, r * row_ms) if r else 0.0))
    full, last = divmod(n_perms, chunk)
    return full * chunk_ms(chunk) + (chunk_ms(last) if last else 0.0)


def _at_draw(parts: dict) -> int:
    """What a fused-kernel sweep holds while it draws: all its workset but
    a dense design's basis, which is gathered after the index draw (and
    the previous chunk's freed before it)."""
    return sum(parts.values()) - parts.get("basis", 0)


def _kernel_chunk(spec: _dreg.FusedImpl, n: int, d: int, n_perms: int,
                  budget: float, n_cols: Optional[int] = None,
                  draw: str = "labels"):
    """(chunk, draw_budget, reason) of the card's fused kernel. Its
    workset (registry.fused_cuda_workset: the partials and the (chunk, n)
    labels, or a dense design's index and basis) and the sweep's slack
    fit the budget, and so do the draw's sub-blocks beside what the sweep
    holds while it draws (_at_draw): draw_budget = budget -
    sweep_slack(budget) - _at_draw. Among the whole-pass chunks
    (_pass_chunks) that leave room for one draw row, the one of least
    modelled time: a launch's feature phase (LAUNCH_MS_EMP, scaled by the
    pairs and the features) and the draw's sub-blocks (_draw_ms; fewer
    launches on a tie). A bigger chunk saves launches and leaves the
    draw fewer rows a sub-block. Where not even one pass fits, ValueError
    names the least budget that would."""
    kind = "index" if n_cols is not None else draw
    slack = sweep_slack(budget)
    row = _perm.draw_transient_bytes(1, n, kind)

    def parts(c):
        return _dreg.fused_cuda_workset(n, c, n_cols)

    def need(c):     # the budget less its slack that chunk c takes
        p = parts(c)
        return max(sum(p.values()), _at_draw(p) + row)

    chunks = _pass_chunks(n_perms, spec.chunk_quantum, n_cols)
    fits = [c for c in chunks if need(c) <= budget - slack]
    if not fits:
        base = need(chunks[0])
        least = (base + SWEEP_SLACK_BYTES if base >= 15 * SWEEP_SLACK_BYTES
                 else base * 16 / 15)       # the budget less its slack
        raise ValueError(
            f"the fused kernel's workset at n={n} takes {base / 2 ** 20:.1f}"
            f"MiB for one pass of {chunks[0]} permutations (with one {kind} "
            f"draw row; + the slack) and the budget is "
            f"{budget / 2 ** 20:.1f}MiB; pass memory_budget_bytes >= "
            f"{int(-(-least // 1))}")

    launch_ms = LAUNCH_MS_EMP * (n / LAUNCH_N) ** 2 * d / LAUNCH_D

    def rows_at(c):
        return _perm.draw_rows(n, budget - slack - _at_draw(parts(c)), kind)

    def cost(c):
        launches = -(-n_perms // c)
        return (launches * launch_ms + _draw_ms(n, n_perms, c, rows_at(c)),
                launches)

    chunk = min(fits, key=cost)
    at_draw = _at_draw(parts(chunk))
    draw_budget = budget - slack - at_draw
    rows = min(rows_at(chunk), chunk)
    return chunk, draw_budget, (
        f"kernel workset {sum(parts(chunk).values()) / 2 ** 20:.0f}MiB, "
        f"{kind} draw {_perm.draw_transient_bytes(rows, n, kind) / 2 ** 20:.0f}"
        f"MiB beside {at_draw / 2 ** 20:.0f}MiB of it, slack "
        f"{slack / 2 ** 20:.1f}MiB, of {budget / 2 ** 20:.0f}MiB; chunk "
        f"{chunk} of least modelled time ({-(-n_perms // chunk)} launches, "
        f"{_draw_sub_blocks(n_perms, chunk, rows)} draws of {rows} rows)")


def _pick_row_block(n: int, d: int, impl: _dreg.DistanceImpl,
                    slab_budget: float) -> int:
    """Largest power-of-two row block whose transient working set fits."""
    block = MAX_ROW_BLOCK
    while block > MIN_ROW_BLOCK and \
            impl.workset_bytes(n, d, block) > slab_budget:
        block //= 2
    return max(MIN_ROW_BLOCK, min(block, n))


def plan_slab_rows(n: int, d: int, *,
                   device_budget_bytes: Optional[float] = None) -> int:
    """Slab height for BUILDING a cache destined for the out-of-core
    sweep: the largest power-of-two block whose live footprint (a row slab
    and a column slab of features, and the assembled (slab, n) mat2 row
    slab) stays a sixteenth of the device budget, leaving the rest to the
    permutation chunks."""
    budget = (DEFAULT_DEVICE_BUDGET_BYTES if device_budget_bytes is None
              else device_budget_bytes)
    per_slab = budget / 16.0
    block = MAX_ROW_BLOCK
    while block > MIN_ROW_BLOCK and 4.0 * block * (2 * d + n) > per_slab:
        block //= 2
    return max(MIN_ROW_BLOCK, min(block, n))


def _ooc_label_bytes(n: int, slab_rows: int, chunk: int, n_groups: int,
                     n_cols: Optional[int], draw: str, draw_rows: int,
                     sparse: bool) -> int:
    """Peak bytes of one permutation chunk of the out-of-core sweep (the
    plain one-hot step, pipeline.streaming._sweep / _sweep_cols), beside
    the mat2 row slab: labels, the (chunk, n) int32 labels and the
    largest of their draw's sub-block (core.permutations' model), the
    int64 labels and one-hot in core.fstat.onehot_perm_factors (8 P n +
    8 P n G, then 8 + 4 P n G while it casts), and the one-hot with its
    (n, P G) copy and the (slab, P G) product and its weighting
    (sw_matmul_contract); a dense design, the (chunk, n) index and its
    draw or the (chunk, n, K) gathered basis, plus for a block-sparse
    design a group's column gather of the slab and of the basis."""
    p = int(chunk)
    if n_cols is None:
        g = int(n_groups)
        body = max(8 * p * n + 8 * p * n * g, 12 * p * n * g,
                   8 * p * n * g + 8 * slab_rows * p * g)
        return 4 * p * n + max(_perm.draw_transient_bytes(draw_rows, n,
                                                          draw), body)
    k = int(n_cols)
    body = 4 * p * n * k
    if sparse:
        body += 4 * slab_rows * n + 8 * p * n * k
    return 4 * p * n + max(_perm.draw_transient_bytes(draw_rows, n,
                                                      "index"), body)


# The parts of the out-of-core footprint that only one phase of the sweep
# holds: the slab phase builds a row slab's tiles, the label phase
# contracts it chunk by chunk, and the two never overlap.
OOC_SLAB_PHASE = ("prepared slabs", "tiles")
OOC_LABEL_PHASE = ("labels",)


def ooc_footprint(n: int, d: int, slab_rows: int, chunk: int,
                  n_groups: int, *,
                  n_cols: Optional[int] = None, draw: str = "labels",
                  packed: bool = False, sparse: bool = False,
                  label_budget: Optional[float] = None) -> Dict[str, int]:
    """The card's out-of-core sweep (pipeline.streaming.fused_sw_ooc) by
    part, in bytes (ooc_peak_bytes: their peak):

      feature slabs   (PREFETCH_DEPTH + 3) f32 slabs of (slab_rows, d):
                      those fetched ahead of the sweep, the row slab, the
                      column slab being contracted, and the previous
                      column slab, whose tile may still run (the sweep
                      waits for it before it takes the next)
      prepared slabs  packed jaccard's words and their int64 transients
                      (a quarter slab); clr and presence run in place on
                      the fetched slabs (core.distance.inplace_prepare)
      mat2 row slab   the one (slab_rows, n) f32 buffer the tiles fill
      tiles           the (slab, slab) distance tile and the previous one
      labels          one permutation chunk's transients (_ooc_label_bytes)
      slack           what the caching allocator rounds up (sweep_slack)
    """
    slab = 4 * slab_rows * d
    parts = {"feature slabs": (PREFETCH_DEPTH + 3) * slab}
    if packed:
        parts["prepared slabs"] = slab // 4
    parts["mat2 row slab"] = 4 * slab_rows * n
    parts["tiles"] = 2 * 4 * slab_rows * slab_rows
    budget = _eplanner.label_budget(label_budget)
    kind = "index" if n_cols is not None else draw
    rows = min(_perm.draw_rows(n, budget, kind), int(chunk))
    parts["labels"] = _ooc_label_bytes(n, slab_rows, chunk, n_groups,
                                       n_cols, draw, rows, sparse)
    parts["slack"] = int(sweep_slack(budget))
    return parts


def ooc_peak_bytes(parts: Dict[str, int]) -> int:
    """The out-of-core footprint's peak on the card: every part both
    phases keep, and the larger of the slab phase (OOC_SLAB_PHASE) and
    the label phase (OOC_LABEL_PHASE). The feature slabs count in whole
    through both phases: the prefetcher allocates them on its own stream,
    and the caching allocator keeps what a stream frees for that stream,
    so the label chunks, on the compute stream, cannot take their memory
    (only PREFETCH_DEPTH of them stay allocated through the label phase,
    but all stay reserved)."""
    slab_phase = sum(parts.get(k, 0) for k in OOC_SLAB_PHASE)
    label_phase = sum(parts.get(k, 0) for k in OOC_LABEL_PHASE)
    both = sum(v for k, v in parts.items()
               if k not in OOC_SLAB_PHASE + OOC_LABEL_PHASE)
    return both + max(slab_phase, label_phase)


def plan_pipeline(n: int, d: int, n_perms: int, n_groups: int, *,
                  backend: str,
                  metric: str = "braycurtis",
                  dist_impl: Optional[str] = None,
                  materialize: Optional[str] = None,
                  row_block: Optional[int] = None,
                  matrix_budget_bytes: Optional[float] = None,
                  slab_budget_bytes: Optional[float] = None,
                  memory_budget_bytes: Optional[float] = None,
                  sw_impl: Optional[str] = None,
                  chunk: Optional[int] = None,
                  fused_impl: Optional[str] = None,
                  fused_tuning: Optional[Dict[str, int]] = None,
                  design_cols: Optional[int] = None,
                  draw: str = "labels",
                  features_on_disk: bool = False,
                  slab_rows: Optional[int] = None,
                  features_disk_bytes: Optional[int] = None,
                  device_budget_bytes: Optional[float] = None,
                  host_budget_bytes: Optional[float] = None,
                  dist_tuning: Optional[Dict[str, int]] = None,
                  sparse_design: bool = False
                  ) -> PipelinePlan:
    """Resolve the full two-stage plan for one problem.

    n_perms counts TOTAL permutation slots (requested + 1 observed), as in
    engine.plan(). Caller-pinned fields (dist_impl, materialize,
    row_block, sw_impl, chunk, fused_impl) are respected; the planner
    fills in the rest. backend: 'cuda' or 'cpu'. fused_impl: 'auto',
    'cuda' / 'torch' (or the reference's 'pallas' / 'xla'), or a fused
    registry name. fused_tuning: caller overrides of the fused impl's
    knobs, the precision knobs (feat_bf16 / feat_fp8 / feat_packed)
    among them: mutually exclusive, packed only where the kernel metric
    is jaccard, and only on the fused-kernel bridge (ValueError
    otherwise; the reference's planner drops what it cannot run).
    design_cols: the dense-design basis width K (covariates / weights /
    several factors); the fused chunk and the engine plan are sized for K
    basis columns instead of G one-hot groups. draw: the kind of label
    draw the sweep makes ('labels', or 'strata' for labels within strata
    blocks; a dense design's index draw is implied by design_cols), which
    the card's fused-kernel plan charges to the budget.

    features_on_disk: the features come from a slab cache (slab_rows its
    slab height, features_disk_bytes its size on disk). The residency
    tier is graded from the f32 table against device_budget_bytes and
    host_budget_bytes (defaults 2 and 32 GiB); below 'hbm' the plan is
    the out-of-core sweep: row_block = slab_rows, 'auto' -> fused-kernel
    in its torch form (a pinned 'cuda' / 'pallas' megakernel, the dense
    and stream bridges and a precision knob raise). On 'cuda' it also
    models the sweep's device footprint (ooc_footprint; dist_tuning: the
    caller's stage-1 knobs, whose packed=1 adds jaccard's word packing;
    sparse_design: a design contracted block-sparsely) and raises
    ValueError, naming the least device budget, where it does not fit.
    """
    if draw not in DRAW_KINDS:
        raise ValueError(f"draw={draw!r}; expected one of {DRAW_KINDS}")
    matrix_budget = (DEFAULT_MATRIX_BUDGET_BYTES
                     if matrix_budget_bytes is None else matrix_budget_bytes)
    slab_budget = (DEFAULT_SLAB_BUDGET_BYTES
                   if slab_budget_bytes is None else slab_budget_bytes)
    device_budget = (DEFAULT_DEVICE_BUDGET_BYTES if device_budget_bytes is None
                     else device_budget_bytes)

    residency = "hbm"
    if features_on_disk:
        if not slab_rows:
            raise ValueError("features_on_disk=True requires slab_rows "
                             "(the cache's slab height)")
        residency = _dreg.residency_tier(
            4.0 * n * d, device_budget_bytes=device_budget,
            host_budget_bytes=(DEFAULT_HOST_BUDGET_BYTES
                               if host_budget_bytes is None
                               else host_budget_bytes))
    ooc = residency != "hbm"
    ooc_auto = False
    if ooc:
        if materialize not in (None, "auto", "fused", "fused-kernel"):
            raise ValueError(
                f"features exceed the device budget (residency="
                f"{residency!r}); the {materialize!r} bridge needs a "
                "resident (n,n) operand — use materialize='auto'/'fused'/"
                "'fused-kernel' or raise device_budget_bytes")
        ooc_auto = materialize in (None, "auto")
        if ooc_auto:
            materialize = "fused-kernel"
        # the disk slab IS the unit of streaming: the sweep assembles one
        # (slab_rows, n) mat2 row slab at a time
        row_block = int(slab_rows)

    if dist_impl is None or dist_impl == "auto":
        dname, dreason = _pick_dist_impl(metric, backend, n, d, slab_budget)
    else:
        dname = dist_impl if "." in dist_impl else f"{metric}.{dist_impl}"
        dreason = "caller-pinned distance impl"
    dspec = _dreg.get(dname)
    dname = dspec.name                    # '.pallas' aliases resolve
    if dspec.metric != metric:
        raise ValueError(f"distance impl {dname!r} computes "
                         f"{dspec.metric!r}, not {metric!r}")

    mat_pinned = materialize not in (None, "auto")
    if not mat_pinned:
        mat, mreason = _pick_materialize(n, matrix_budget, metric)
    else:
        if materialize not in MATERIALIZE_MODES:
            raise ValueError(f"materialize={materialize!r}; expected one of "
                             f"{MATERIALIZE_MODES}")
        mat, mreason = materialize, "caller-pinned materialization"
        if ooc_auto:
            mreason = (f"features exceed the device budget (residency="
                       f"{residency}); out-of-core slab sweep")

    if row_block is None:
        # size the block against the ROWS working set: the stream bridge
        # consumes make_rows, whose transients scale with the block
        rows_spec = (dspec if dspec.kind != "dense"
                     else _dreg.get(f"{metric}.blocked"))
        row_block = _pick_row_block(n, d, rows_spec, slab_budget)
    row_block = max(1, min(int(row_block), n))

    # Stage 2 via the engine planner. The fused bridges compute s_W in the
    # one-hot matmul form, so the engine plan is pinned to 'matmul' there
    # (a caller-pinned sw_impl they cannot honor is an error when the
    # bridge was pinned too, a downgrade to 'stream' when it was ours),
    # and the chunk is sized against the one-hot block (chunk, n, G),
    # except on the card's fused kernels, which hold only their partials
    # and the labels or the index and basis (_kernel_chunk).
    pinned_sw = sw_impl if sw_impl not in (None, "auto") else None
    if mat in FUSED_MODES and pinned_sw not in (None, "matmul"):
        if mat_pinned:
            raise ValueError(
                f"the {mat} bridge computes s_W in the one-hot matmul form "
                f"and cannot honor sw_impl={pinned_sw!r}; use "
                "sw_impl='auto'/'matmul' or materialize='stream'")
        mat = "stream"
        mreason += (f"; downgraded fused->stream to honor "
                    f"sw_impl={pinned_sw!r} (over matrix budget)")
    if mat in FUSED_MODES and pinned_sw is None:
        pinned_sw = "matmul"
    draw_budget = None   # a caller's chunk: the draws keep the label budget
    if mat in FUSED_MODES and chunk is None:
        budget = (_eplanner.DEFAULT_STREAM_BUDGET_BYTES
                  if memory_budget_bytes is None else memory_budget_bytes)
        kspec = None
        if mat == "fused-kernel" and backend == "cuda" and not ooc:
            kspec = _dreg.get_fused(_resolve_fused(
                metric, backend, fused_impl, n, fused_tuning)[0])
        if kspec is not None and kspec.kind == "cuda":
            # the card's kernels hold their partials and the labels (or
            # index and basis) only; the draw takes what is left
            chunk, draw_budget, why = _kernel_chunk(
                kspec, n, d, n_perms, budget, design_cols, draw)
            mreason += f"; {why}"
        else:
            cols = n_groups if design_cols is None else design_cols
            chunk = _onehot_chunk(n, cols, n_perms, budget)
    sw = _eplanner.plan(n, n_perms, backend=backend, impl=pinned_sw,
                        memory_budget_bytes=memory_budget_bytes,
                        chunk=chunk, n_cols=design_cols, n_groups=n_groups)
    if mat in FUSED_MODES:
        # the fused bridges contract s_W themselves: no s_W kernel runs
        sw = dataclasses.replace(sw, kernel=None)

    caller_prec = {k: v for k, v in (fused_tuning or {}).items()
                   if k in PRECISION_KNOBS}
    if any(int(v or 0) for v in caller_prec.values()) \
            and mat != "fused-kernel":
        raise ValueError(
            f"precision knobs {caller_prec} apply to the fused-kernel "
            f"bridge, and this plan's bridge is {mat!r}; pass "
            "materialize='fused-kernel'")

    # Fused-kernel: which single-pass impl runs the sweep and its tuning
    # (registry defaults <- caller knobs).
    f_impl = None
    f_tuning: Dict[str, int] = {}
    if mat == "fused-kernel":
        if ooc and fused_impl in (None, "auto"):
            # the megakernel reads the whole resident table; out of core
            # the torch sweep consumes the assembled mat2 row slabs
            f_impl, freason = (f"{metric}.fusedk.torch",
                               "one-pass torch sweep over disk slabs")
        else:
            f_impl, freason = _resolve_fused(metric, backend, fused_impl,
                                             n, fused_tuning)
        fspec = _dreg.get_fused(f_impl)
        f_impl = fspec.name                   # reference aliases resolve
        if fspec.metric != metric:
            raise ValueError(f"fused impl {f_impl!r} computes "
                             f"{fspec.metric!r}, not {metric!r}")
        if ooc and fspec.kind != "torch":
            raise ValueError(
                f"fused impl {f_impl!r} ({fspec.kind} kind) needs the "
                "resident feature table; out-of-core sweeps require the "
                "torch form")
        # validated before the registry's keys filter them: packed asked
        # of a non-jaccard impl (no feat_packed key) must not be dropped
        _fref.feature_mode(fspec.kernel_metric, *(
            caller_prec.get(k) for k in PRECISION_KNOBS))
        f_tuning = dict(fspec.tuning)
        f_tuning.update({k: v for k, v in (fused_tuning or {}).items()
                         if k in f_tuning})
        mreason += f"; {freason}"

    # the planned row block IS the blocked impls' working-set knob
    caller_dist = dict(dist_tuning or {})
    dist_tuning = dict(dspec.tuning)
    if "block" in dist_tuning:
        dist_tuning["block"] = row_block
    if ooc and _dreg.precision_tag(f_tuning) != "f32":
        raise ValueError(
            "out-of-core sweeps run f32 only: the reduced-precision slabs "
            "need a global calibration pass over the resident table")
    footprint = None
    if ooc and backend == "cuda":
        footprint = ooc_footprint(
            n, d, row_block, sw.chunk, n_groups,
            n_cols=design_cols, draw=draw,
            packed=bool({**dist_tuning, **caller_dist}.get("packed")),
            sparse=sparse_design, label_budget=memory_budget_bytes)
        need = ooc_peak_bytes(footprint)
        if need > device_budget:
            raise ValueError(
                f"the out-of-core sweep's device footprint at slab_rows="
                f"{row_block} peaks at {need / 2 ** 20:.1f}MiB ("
                + ", ".join(f"{k} {v / 2 ** 20:.1f}MiB"
                            for k, v in footprint.items())
                + f"; the slab and the label phase never overlap) and "
                f"the device budget is "
                f"{device_budget / 2 ** 20:.1f}MiB; pass "
                f"device_budget_bytes >= {need}, a smaller label budget, or "
                "a cache of fewer rows a slab")
    return PipelinePlan(
        metric=metric, dist_impl=dname, dist_tuning=dist_tuning,
        materialize=mat, row_block=row_block, sw=sw, backend=backend,
        reason=f"{dreason}; {mreason}", fused_impl=f_impl,
        fused_tuning=f_tuning, n=n, d=d, n_groups=n_groups,
        n_cols=design_cols, draw_budget=draw_budget,
        draw="index" if design_cols is not None else draw,
        budget=None if draw_budget is None else budget,
        residency=residency, slab_rows=int(slab_rows or 0),
        disk_bytes=int(features_disk_bytes or 0), ooc_footprint=footprint,
        device_budget=device_budget if footprint is not None else None)


# ---------------------------------------------------------------------------
# Persisted stage-1 / fused-kernel autotuning. Candidate timings live in
# engine.planner's cache beside the s_W shoot-outs, one entry per (device
# kind, metric, impl), so a host measures each candidate once and
# plan_pipeline() reads the winners back as its defaults.
# ---------------------------------------------------------------------------

def _stage1_key(kind: str, metric: str, impl: str) -> str:
    return f"dist|{kind}|{metric}|{impl}"


def _fused_key(kind: str, metric: str, impl: str,
               tuning: Optional[Dict[str, int]] = None) -> str:
    """Fused-kernel cache key: the precision knobs are part of it (an fp8
    timing never feeds an f32 plan); f32 keeps the untagged form."""
    tag = _dreg.precision_tag(tuning)
    base = f"fusedk|{kind}|{metric}|{impl}"
    return base if tag == "f32" else f"{base}|{tag}"


def _stage1_candidates(metric: str, backend: str):
    """The distance kernel on the card (the dense and blocked torch forms
    are its plain twins there), the dense and blocked forms elsewhere."""
    if backend == "cuda":
        return [f"{metric}.cuda"]
    return (_dreg.names(metric=metric, kind="dense")
            + _dreg.names(metric=metric, kind="blocked"))


def _fused_candidates(metric: str, backend: str):
    return _dreg.fused_names(metric=metric, backend=backend)


def _argmin_measured(keys_by_name, n: int):
    """Winner among candidates whose persisted entry matches n's bucket;
    None unless EVERY candidate was measured (a partial shoot-out does
    not replace the heuristics)."""
    bucket = _eplanner._bucket(n)
    times = {}
    for name, key in keys_by_name.items():
        entry = _eplanner.measured_entry(key)
        if not entry or entry.get("bucket") != bucket or "ms" not in entry:
            return None
        times[name] = entry["ms"]
    return min(times, key=times.get) if times else None


def measured_stage1(backend: str, metric: str, n: int) -> Optional[str]:
    """Persisted stage-1 winner for this (device kind, metric, n bucket)."""
    kind = _eplanner.device_kind(backend)
    if kind is None:
        return None
    return _argmin_measured(
        {c: _stage1_key(kind, metric, c)
         for c in _stage1_candidates(metric, backend)}, n)


def measured_fused(backend: str, metric: str, n: int,
                   tuning: Optional[Dict[str, int]] = None) -> Optional[str]:
    """Persisted fused-kernel winner for this (device kind, metric, n
    bucket) at the precision the tuning knobs select (default f32)."""
    kind = _eplanner.device_kind(backend)
    if kind is None:
        return None
    return _argmin_measured(
        {c: _fused_key(kind, metric, c, tuning)
         for c in _fused_candidates(metric, backend)}, n)


def autotune_stage1(x: torch.Tensor, metric: str) -> str:
    """Time each stage-1 candidate's dense build on the real table, on
    its device (engine.planner.time_call: a warm-up call, then the median
    of its timed calls), persist one entry per (device kind, metric,
    impl) and return the winner; a winner already persisted for this
    device kind and n bucket is returned unmeasured. A candidate whose
    kernel does not apply to the shape is skipped; any other failure
    raises."""
    backend = x.device.type
    kind = _eplanner.device_kind(backend)
    n, d = (int(v) for v in x.shape)
    known = measured_stage1(backend, metric, n)
    if known is not None:
        return known
    times = {}
    for name in _stage1_candidates(metric, backend):
        _, _, dense_fn = _dreg.get(name).bound()
        try:
            times[name] = _eplanner.time_call(lambda: dense_fn(x), x.device)
        except ShapeNotSupported:
            continue
        _eplanner.record_entry(_stage1_key(kind, metric, name), {
            "impl": name, "ms": times[name], "n": n, "d": d,
            "bucket": _eplanner._bucket(n)})
    if not times:
        raise RuntimeError("autotune_stage1: no candidate applies to "
                           f"({n}, {d})")
    _eplanner.MEASURED["stage1"] += 1
    return min(times, key=times.get)


def autotune_fused(x: torch.Tensor, grouping: torch.Tensor, *,
                   metric: str = "braycurtis",
                   n_groups: Optional[int] = None,
                   sample_perms: int = _eplanner.SAMPLE_PERMS,
                   seed: int = 0) -> str:
    """Time each fused-kernel candidate on `sample_perms` of the port's
    draws from `seed` over the real table (one chunk of that size, f32),
    on its device; persist one entry per (device kind, metric, impl)
    with the tuning it ran and return the winner (an f32 winner already
    persisted for this device kind and n bucket, unmeasured). On the
    card the one candidate is the megakernel."""
    from repro_torch.core import distance as _dist      # deferred: cycles
    from repro_torch.core import permutations as _perms
    from repro_torch.pipeline import streaming as _streaming
    backend = x.device.type
    kind = _eplanner.device_kind(backend)
    n, d = (int(v) for v in x.shape)
    known = measured_fused(backend, metric, n)
    if known is not None:
        return known
    grouping = grouping.to(x.device, torch.int32)
    if n_groups is None:
        n_groups = int(grouping.max()) + 1
    inv_gs = _perms.inv_group_sizes(grouping, n_groups)
    mdef = _dist.ROW_METRICS[metric]
    xprep = mdef.prepare(x)
    row_block = _pick_row_block(n, d, _dreg.get(f"{metric}.blocked"),
                                DEFAULT_SLAB_BUDGET_BYTES)
    times = {}
    for name in _fused_candidates(metric, backend):
        spec = _dreg.get_fused(name)
        tuning = dict(spec.tuning)

        def run(spec=spec, tuning=tuning):
            return _streaming.fused_kernel_sw(
                xprep, mdef.rows, grouping, inv_gs, sample_perms,
                impl=spec.kind, kernel_metric=spec.kernel_metric,
                row_block=row_block, chunk=sample_perms, tuning=tuning,
                seed=seed)

        try:
            times[name] = _eplanner.time_call(run, x.device)
        except ShapeNotSupported:
            continue
        _eplanner.record_entry(_fused_key(kind, metric, name, tuning), {
            "impl": name, "ms": times[name], "n": n, "d": d,
            "bucket": _eplanner._bucket(n), "tuning": tuning,
            "sample_perms": sample_perms})
    if not times:
        raise RuntimeError("autotune_fused: no candidate applies to "
                           f"({n}, {d})")
    _eplanner.MEASURED["fused"] += 1
    return min(times, key=times.get)
