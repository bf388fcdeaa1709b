"""Roofline terms of a dry-run cell from its counted step (twin of
`repro/roofline/analysis.py`).

Three terms per (arch x shape x mesh) cell, seconds per step if the card
ran at its datasheet peak on each subsystem:

  compute    = FLOPs / peak FLOP/s
  memory     = HBM bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

The counts are one rank's (`roofline.op_cost`), so dividing by one card's
peaks gives the per-step bound, as the reference's per-device HLO does.
Collective bytes divide by NVLink's rate where the group stays within a
node and by InfiniBand's otherwise (`hw.ChipSpec`); the reference's
one ICI link rate is this split's single-link case.

MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active params,
D = tokens; the ratio MODEL_FLOPS / (FLOPs * chips) exposes remat /
redundant-compute waste.
"""

from __future__ import annotations

import dataclasses

from repro_torch import hw
from repro_torch.roofline.op_cost import OpCost


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device FLOPs (counted)
    hbm_bytes: float             # per-device HBM bytes (unfused count)
    collective_bytes: float      # per-device collective operand bytes
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    collective_detail: dict
    model_flops_total: float = 0.0
    useful_flops_ratio: float = 0.0
    hbm_bytes_model: str = "unfused: operands + results of every op"
    collective_links: dict = dataclasses.field(default_factory=dict)

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze_cell(cost: OpCost, *, chips: int,
                 chip: hw.ChipSpec = hw.TARGET,
                 dtype_flops: str = "bf16",
                 model_flops_total: float = 0.0) -> RooflineTerms:
    """The roofline terms of one rank's counted step (`op_cost.counting`);
    stands in for the reference's `analyze_compiled`."""
    flops = float(cost.flops)
    hbm_bytes = float(cost.hbm_bytes)
    coll_bytes = float(cost.coll_bytes)
    coll = dict(cost.coll_by_kind)
    coll["_counts"] = dict(cost.coll_counts)

    peak = (chip.peak_flops_bf16 if dtype_flops == "bf16"
            else chip.peak_flops_f32)
    compute_s = flops / peak
    memory_s = hbm_bytes / chip.hbm_bandwidth
    collective_s = (cost.coll_by_link.get("nvlink", 0) / chip.nvlink_bandwidth
                    + cost.coll_by_link.get("ib", 0) / chip.ib_bandwidth)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    ratio = 0.0
    if flops > 0 and model_flops_total > 0:
        ratio = model_flops_total / (flops * chips)
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm_bytes, collective_bytes=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, collective_detail=coll,
        model_flops_total=model_flops_total, useful_flops_ratio=ratio,
        collective_links=dict(cost.coll_by_link))


def _leaves(tree, is_leaf):
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    return [x for t in tree for x in _leaves(t, is_leaf)]


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def active_param_fraction_tree(param_axes, cfg):
    """Per-leaf activity factor: MoE expert weights count top_k/E."""
    if cfg.moe_n_experts == 0:
        return None
    frac = cfg.moe_top_k / cfg.moe_n_experts

    def one(axes):
        return frac if "expert" in axes else 1.0

    def walk(t):
        if _is_axes(t):
            return one(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return [walk(v) for v in t]

    return walk(param_axes)


def model_flops(cfg, params_abs, param_axes, *, tokens: int,
                kind: str) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference). `params_abs` is a
    tree of anything with a `.shape` (the stacked spec tree
    `models.model.param_specs(cfg)` gives the reference's leaves, in its
    order, so the sum is the reference's to the bit); `param_axes` its
    axes tree."""
    import numpy as np

    fracs = active_param_fraction_tree(param_axes, cfg)
    leaves = _leaves(params_abs, lambda x: hasattr(x, "shape"))
    if fracs is None:
        frac_leaves = [1.0] * len(leaves)
    else:
        frac_leaves = _leaves(fracs, lambda x: isinstance(x, float))
    total = 0.0
    for p, f in zip(leaves, frac_leaves):
        total += float(np.prod(p.shape)) * f
    factor = 6.0 if kind == "train" else 2.0
    return factor * total * tokens
