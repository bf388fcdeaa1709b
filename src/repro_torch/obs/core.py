"""Span core: context-var span stack -> Chrome trace_event buffer.

Twin of `repro/obs/core.py`. Zero-dependency tracing for the port's
layers. OFF by default with near-zero overhead: while disabled, `span()`
returns one shared no-op context manager — no dict, no object, no event
is allocated on the hot path (the scheduler's chunk loop runs through
here), no profiler range is entered and no device is synchronised.

When enabled, every completed span is buffered as a Chrome/Perfetto
`trace_event` dict (`ph: "X"`, microsecond ts/dur) with its nesting depth
and parent recorded from a contextvar span stack, so `obs.trace.export`
writes a file chrome://tracing and Perfetto load directly. Each span also
enters `torch.profiler.record_function(name)` (resolved at the first
enable()), so under `torch.profiler.profile` the spans show as ranges
beside the card's kernels. A new thread starts with an empty stack: its
spans (the prefetcher's `prefetch.fetch`) sit at depth 0 on their own
`tid`.

An event's `ts` is on the profiler's clock: microseconds since the Unix
epoch, as `torch.profiler`'s events carry them, so an exported obs trace
and a device trace of the same run lie over each other. Durations come
from `perf_counter_ns`; a stamp is that counter plus an offset to the
epoch taken once at import.

`maybe_block` is the sync point: while tracing, outside a
`torch.profiler` session, it waits for the device of the given tensors
(`torch.cuda.synchronize`), so a span's wall time covers completed device
work. Under a profiler it does not wait: the device trace times the card,
and the traced run keeps the untraced schedule. CPU tensors need nothing;
with tracing off it never syncs.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Optional

# Module-level fast flags: checked on every span()/inc() call, so they are
# plain bools rather than attribute lookups through a config object.
_trace_on = False
_metrics_on = False

_events: list = []                 # completed spans (trace_event dicts)
_events_lock = threading.Lock()
# perf_counter_ns + _EPOCH_NS = nanoseconds since the Unix epoch
_EPOCH_NS = time.time_ns() - time.perf_counter_ns()


def _stamp_us(counter_ns: int) -> float:
    """A perf_counter_ns reading as the profiler's microseconds since the
    Unix epoch (int true division: correctly rounded)."""
    return (int(counter_ns) + _EPOCH_NS) / 1000


def _bounds_us(start_ns: int, end_ns: int):
    """(ts, dur) in microseconds of [start_ns, end_ns] (perf_counter_ns),
    dur taken as the difference of the two stamps, so ts + dur is the end's
    stamp exactly and nested spans stay nested."""
    ts = _stamp_us(start_ns)
    return ts, max(0.0, _stamp_us(end_ns) - ts)


# Span-buffer ring cap: a long-running process traces indefinitely, so the
# buffer keeps only the most recent `_max_events` COMPLETE spans (oldest
# dropped first; drops are counted). $REPRO_TORCH_OBS_MAX_EVENTS overrides
# the default; set_buffer_cap() adjusts at runtime (0/None = unbounded).
MAX_EVENTS_ENV = "REPRO_TORCH_OBS_MAX_EVENTS"
_max_events: Optional[int] = int(
    os.environ.get(MAX_EVENTS_ENV, "100000")) or None
_dropped_events = 0


def set_buffer_cap(n: Optional[int]) -> None:
    """Cap the completed-span ring buffer at `n` events (None or 0 =
    unbounded). Shrinking below the current buffer length drops the
    oldest spans immediately."""
    global _max_events
    with _events_lock:
        _max_events = int(n) if n else None
        _trim_events_locked()


def buffer_cap() -> Optional[int]:
    return _max_events


def dropped_events() -> int:
    """Spans dropped by the ring cap since the last clear()."""
    return _dropped_events


def _trim_events_locked() -> None:
    global _dropped_events
    if _max_events is not None and len(_events) > _max_events:
        overflow = len(_events) - _max_events
        del _events[:overflow]
        _dropped_events += overflow


_stack: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_span_stack", default=())

_record_function = None            # resolved lazily at first enable()
_profiler_enabled = None           # likewise: is a torch.profiler recording?


class _NoopSpan:
    """Shared do-nothing span for disabled mode (allocation-free)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()
NOOP_SPAN = _NOOP   # what span() returns while tracing is off; a caller
                    # that sometimes wants no span at all takes it too


class _Span:
    __slots__ = ("name", "attrs", "_start_ns", "_token", "_range")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._token = _stack.set(_stack.get() + (self.name,))
        self._range = None
        if _record_function is not None:
            try:
                self._range = _record_function(self.name)
                self._range.__enter__()
            except Exception:       # the profiler range is decoration
                self._range = None
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _stack.get()
        _stack.reset(self._token)
        args = {"depth": len(stack) - 1}
        if len(stack) > 1:
            args["parent"] = stack[-2]
        if self.attrs:
            args.update(self.attrs)
        ts, dur = _bounds_us(self._start_ns, end_ns)
        ev = {
            "name": self.name,
            "cat": "repro_torch",
            "ph": "X",
            "ts": ts,
            "dur": dur,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": args,
        }
        with _events_lock:
            _events.append(ev)
            _trim_events_locked()
        return False


def span(name: str, attrs: Optional[dict] = None):
    """Context manager timing one stage.

    attrs: optional dict recorded into the trace event's `args` (e.g.
    `{"predicted_bytes": ...}` feeds the predicted-vs-measured report); it
    is read at exit, so a caller may add measured fields inside the span.
    While tracing is disabled this returns a shared no-op object — hot
    call sites (per-chunk loops) pay one bool check and nothing else.
    """
    if not _trace_on:
        return _NOOP
    return _Span(name, attrs)


def enable(*, trace: bool = True, metrics: bool = True) -> None:
    """Turn telemetry on (idempotent). The first enable with tracing
    resolves torch.profiler.record_function, so every span is also a
    profiler range, and the probe of a recording profiler that
    maybe_block asks."""
    global _trace_on, _metrics_on, _record_function, _profiler_enabled
    _trace_on = bool(trace)
    _metrics_on = bool(metrics)
    if _trace_on and _record_function is None:
        try:
            from torch.profiler import record_function as _rf
            _record_function = _rf
        except Exception:           # torch without profiler: spans work
            pass
    if _trace_on and _profiler_enabled is None:
        try:
            from torch._C._autograd import _profiler_enabled as _pe
            _profiler_enabled = _pe
        except ImportError:         # no probe: no profiler to defer to
            _profiler_enabled = bool
    _sync_metrics_flag()


def disable() -> None:
    """Turn telemetry off (buffers/counters are kept; see trace.clear /
    metrics.reset)."""
    global _trace_on, _metrics_on
    _trace_on = False
    _metrics_on = False
    _sync_metrics_flag()


def _sync_metrics_flag() -> None:
    from repro_torch.obs import metrics as _metrics
    _metrics.set_active(_metrics_on)


def trace_enabled() -> bool:
    return _trace_on


def metrics_enabled() -> bool:
    return _metrics_on


def enabled() -> bool:
    return _trace_on or _metrics_on


@contextlib.contextmanager
def session(export_path: Optional[str] = None, *, metrics: bool = True):
    """Scoped telemetry: enable for the body, restore the previous state
    after, exporting the trace buffer to `export_path` when given
    (`pipeline(..., trace="out.json")` routes through here)."""
    prev = (_trace_on, _metrics_on)
    enable(trace=True, metrics=metrics)
    try:
        yield
    finally:
        if export_path:
            from repro_torch.obs import trace as _trace
            _trace.export(export_path)
        if prev == (False, False):
            disable()
        else:
            enable(trace=prev[0], metrics=prev[1])


def _cuda_devices(x) -> set:
    """The CUDA devices of a tensor, or of the tensors in a (nested)
    tuple / list; CPU tensors and anything else add none."""
    import torch
    if isinstance(x, torch.Tensor):
        return {x.device} if x.device.type == "cuda" else set()
    if isinstance(x, (tuple, list)):
        out = set()
        for item in x:
            out |= _cuda_devices(item)
        return out
    return set()


def _synchronize(x) -> None:
    import torch
    for dev in _cuda_devices(x):
        torch.cuda.synchronize(dev)


def maybe_block(x):
    """Device sync point: wait for the device of x (a tensor or a tuple /
    list of them) only while tracing and no torch.profiler records, so
    span wall-times measure completed device work without perturbing the
    untraced asynchronous launches; under a profiler the device trace
    times the card and the launches keep their untraced schedule.
    Returns x."""
    if _trace_on and x is not None and not _profiler_enabled():
        _synchronize(x)
    return x


def emit_complete(name: str, start_ns: int, end_ns: int,
                  attrs: Optional[dict] = None) -> None:
    """Append a complete (`ph: "X"`) trace event with caller-supplied
    wall-clock bounds (perf_counter_ns values), stamped as spans are.

    Batched serving uses this to record one event per request of a
    coalesced dispatch: the requests overlap in time, so they cannot be
    expressed as nested `span()` context managers on the contextvar
    stack. No-op while tracing is disabled.
    """
    if not _trace_on:
        return
    ts, dur = _bounds_us(start_ns, end_ns)
    ev = {
        "name": name,
        "cat": "repro_torch",
        "ph": "X",
        "ts": ts,
        "dur": dur,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": dict(attrs) if attrs else {},
    }
    with _events_lock:
        _events.append(ev)
        _trim_events_locked()


def events() -> list:
    """Snapshot of the completed-span buffer (trace_event dicts)."""
    with _events_lock:
        return list(_events)


def clear() -> None:
    global _dropped_events
    with _events_lock:
        _events.clear()
        _dropped_events = 0
