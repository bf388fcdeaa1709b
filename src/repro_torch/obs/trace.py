"""Trace-buffer consumers: Chrome/Perfetto export + flat per-stage table.

Twin of `repro/obs/trace.py`. `export(path)` writes the span buffer in the
`trace_event` JSON format (chrome://tracing and https://ui.perfetto.dev
open it directly); `stage_table()` collapses the same buffer into one row
per span name — the flat view obs.report() reconciles against the
predicted-bytes models.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.obs import core as _core

events = _core.events
clear = _core.clear


def export(path: str, *, extra_metadata: Optional[dict] = None) -> str:
    """Write the span buffer as Chrome trace_event JSON; returns `path`."""
    payload = {
        "traceEvents": _core.events(),
        "displayTimeUnit": "ms",
        "otherData": {"source": "repro_torch.obs",
                      **(extra_metadata or {})},
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def stage_table() -> dict:
    """Aggregate completed spans by name.

    Returns {name: {"calls", "total_s", "mean_s", "predicted_bytes"}} —
    predicted_bytes summed from span attrs (0.0 for spans whose call
    sites attach no traffic model).
    """
    table: dict = {}
    for ev in _core.events():
        if ev.get("ph") != "X":
            continue
        row = table.setdefault(ev["name"], {
            "calls": 0, "total_s": 0.0, "predicted_bytes": 0.0})
        row["calls"] += 1
        row["total_s"] += ev.get("dur", 0.0) / 1e6
        row["predicted_bytes"] += float(
            (ev.get("args") or {}).get("predicted_bytes", 0.0))
    for row in table.values():
        row["mean_s"] = row["total_s"] / row["calls"]
    return table
