"""obs/ — zero-dependency tracing + metrics for the port's layers.

Twin of `repro/obs`:

- `span("stage1.braycurtis")` — contextvar-stacked wall-time spans,
  exported as Chrome/Perfetto trace_event JSON (`obs.trace.export`), each
  also a `torch.profiler` range.
- `metrics` — process-wide counters/gauges/histograms: kernel builds,
  loads and launches (`cudahooks`), autotune cache hits, predicted
  traffic bytes, permutation chunks, device peak memory.
- `report()` — predicted-vs-measured reconciliation table pairing the
  traffic models with measured span times.

Everything is OFF by default; the disabled hot path is one bool check
returning a shared no-op span.
"""

from repro_torch.obs import core, cudahooks, metrics, trace
from repro_torch.obs.core import (
    buffer_cap,
    clear,
    disable,
    dropped_events,
    emit_complete,
    enable,
    enabled,
    events,
    maybe_block,
    metrics_enabled,
    session,
    set_buffer_cap,
    span,
    trace_enabled,
)
from repro_torch.obs.cudahooks import record_device_memory
from repro_torch.obs.report import budget_violations, report, stage_rows

__all__ = [
    "core", "cudahooks", "metrics", "trace",
    "span", "enable", "disable", "enabled", "session",
    "trace_enabled", "metrics_enabled", "events", "clear",
    "set_buffer_cap", "buffer_cap", "dropped_events", "emit_complete",
    "maybe_block", "record_device_memory",
    "report", "stage_rows", "budget_violations",
]
