"""Predicted-vs-measured reconciliation report.

Twin of `repro/obs/report.py`. The planners' traffic models (the engine's
per-impl s_W traffic, pipeline.registry's stage-1 and fused models; on
'cuda' what the card's kernels load, on 'cpu' the reference's numbers)
predict how many bytes each stage should move; the span buffer records
how long each stage actually took. `report()` pairs the two — predicted
bytes / measured wall-time = achieved GB/s — and flags stages whose
achieved bandwidth falls below a configurable fraction of a reference
bandwidth: on 'cuda' the card's measured STREAM triad
(`pipeline.registry.CUDA_TIER_GBPS["hbm"]`), on 'cpu' the paper's MI300A
CPU triad (the reference's number), or $REPRO_TORCH_OBS_PEAK_GBPS / the
`peak_gbps=` argument. Rendered through roofline.report's table helper.
"""

from __future__ import annotations

import fnmatch
import os
import sys
from typing import Dict, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

PEAK_GBPS_ENV = "REPRO_TORCH_OBS_PEAK_GBPS"


def budget_violations(budgets: Dict[str, float]) -> list:
    """Check traced span totals against a wall-clock SLO budget table.

    budgets maps an fnmatch pattern over span NAMES (e.g. 'stage1.*',
    'fusedk.chunk') to the maximum TOTAL seconds all matching spans may
    have spent together. Returns one dict per violated entry — empty
    list = every budget held. A pattern matching no spans is not a
    violation (the stage may legitimately not have run)."""
    table = _trace.stage_table()
    out = []
    for pattern, limit_s in budgets.items():
        names = [n for n in table if fnmatch.fnmatch(n, pattern)]
        if not names:
            continue
        total = sum(table[n]["total_s"] for n in names)
        if total > float(limit_s):
            out.append({
                "pattern": pattern,
                "budget_s": float(limit_s),
                "measured_s": total,
                "stages": sorted(names),
            })
    out.sort(key=lambda v: -(v["measured_s"] - v["budget_s"]))
    return out


def reference_gbps(backend: Optional[str] = None) -> float:
    """Reference bandwidth (GB/s) for the below-fraction flag: the env
    override when set, else the card's measured triad on 'cuda' (the
    default where a card is present) and the paper's CPU triad on
    'cpu'."""
    override = os.environ.get(PEAK_GBPS_ENV)
    if override:
        return float(override)
    from repro_torch import hw
    if backend is None:
        import torch
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if backend == "cuda":
        from repro_torch.pipeline import registry   # deferred: cycle
        return registry.CUDA_TIER_GBPS["hbm"]
    return hw.MI300A_CPU_STREAM_TRIAD / 1e9


def stage_rows(*, peak_gbps: Optional[float] = None,
               flag_fraction: float = 0.5,
               backend: Optional[str] = None) -> list:
    """One dict per span name carrying a predicted-bytes attr: predicted
    MiB, measured seconds, achieved GB/s, fraction of the reference, and
    the below-fraction flag. Sorted by measured time, slowest first."""
    ref = peak_gbps if peak_gbps is not None else reference_gbps(backend)
    rows = []
    for name, agg in _trace.stage_table().items():
        if agg["predicted_bytes"] <= 0.0:
            continue
        gbps = (agg["predicted_bytes"] / agg["total_s"] / 1e9
                if agg["total_s"] > 0 else 0.0)
        frac = gbps / ref if ref > 0 else 0.0
        rows.append({
            "stage": name,
            "calls": agg["calls"],
            "predicted_mib": agg["predicted_bytes"] / 2**20,
            "measured_s": agg["total_s"],
            "achieved_gbps": gbps,
            "ref_fraction": frac,
            "flagged": frac < flag_fraction,
        })
    rows.sort(key=lambda r: -r["measured_s"])
    return rows


def report(*, peak_gbps: Optional[float] = None, flag_fraction: float = 0.5,
           backend: Optional[str] = None,
           budgets: Optional[Dict[str, float]] = None,
           file=sys.stdout) -> str:
    """Render (and print, unless file=None) the per-stage
    predicted-vs-measured table plus the counter/gauge snapshot.

    budgets: optional SLO table (fnmatch span pattern -> max total
    seconds, see budget_violations) — appends a budget-status section,
    flagging every entry over its limit."""
    from repro_torch.roofline.report import render_table
    ref = peak_gbps if peak_gbps is not None else reference_gbps(backend)
    rows = stage_rows(peak_gbps=ref, flag_fraction=flag_fraction,
                      backend=backend)
    lines = [f"predicted-vs-measured per stage "
             f"(reference {ref:.1f} GB/s, flag below "
             f"{flag_fraction:.0%} of it):"]
    if rows:
        lines.append(render_table(
            ["stage", "calls", "pred MiB", "measured s", "GB/s",
             "of ref", "flag"],
            [[r["stage"], str(r["calls"]), f"{r['predicted_mib']:.2f}",
              f"{r['measured_s']:.4f}", f"{r['achieved_gbps']:.2f}",
              f"{r['ref_fraction']:.1%}",
              "BELOW" if r["flagged"] else ""] for r in rows]))
    else:
        lines.append("  (no traced stages carry a traffic model — run "
                     "with tracing enabled)")

    # untimed spans (no traffic model) still show wall-time
    other = [(n, a) for n, a in sorted(_trace.stage_table().items())
             if a["predicted_bytes"] <= 0.0]
    if other:
        lines.append("")
        lines.append(render_table(
            ["stage (no traffic model)", "calls", "measured s"],
            [[n, str(a["calls"]), f"{a['total_s']:.4f}"]
             for n, a in other]))

    if budgets:
        viol = budget_violations(budgets)
        bad = {v["pattern"]: v for v in viol}
        table = _trace.stage_table()
        lines.append("")
        lines.append("wall-clock SLO budgets:")
        for pattern, limit_s in sorted(budgets.items()):
            names = [n for n in table if fnmatch.fnmatch(n, pattern)]
            total = sum(table[n]["total_s"] for n in names)
            status = ("OVER" if pattern in bad
                      else ("ok" if names else "not run"))
            lines.append(f"  {pattern}: {total:.4f}s of {limit_s:g}s "
                         f"budget [{status}]")

    snap = _metrics.snapshot()
    if snap["counters"] or snap["gauges"] or snap["histograms"]:
        lines.append("")
        lines.append("counters:")
        for k, v in snap["counters"].items():
            lines.append(f"  {k} = {v:g}")
        for k, v in snap["gauges"].items():
            lines.append(f"  {k} = {v:g} (gauge)")
        for k, h in snap["histograms"].items():
            lines.append(f"  {k}: n={h['count']} "
                         f"mean={h['total']/max(h['count'],1):.4g} "
                         f"max={h['max']:.4g}")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text
