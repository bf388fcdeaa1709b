"""The traced run: torch.profiler over the window, read from its events.

The window runs under `torch.profiler.profile` (CPU and CUDA activities)
with the program's own spans on, which enter `record_function` ranges.
The profiler's events are read in the process (no Chrome export: at some
hundred thousand kernels a window it would write gigabytes), and a
compact trace of the card's activity and the host ranges is written,
gzipped, under $TMPDIR for a reader of the run:

  * device activity: every kernel, copy and set event on the card;
  * a kernel belongs to a span when the runtime call that launched it
    (joined by its correlation id) lies inside one of that span's ranges;
  * the window is the harness's own `bench.window` range.

What the per-layer readers and the result's `device` and `breakdown`
keys take comes from `Trace`.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")


def trace_path(cell: str, seed: int) -> str:
    """Where a traced run writes its compact trace: under $TMPDIR."""
    return os.path.join(tempfile.gettempdir(),
                        f"bench-trace-{cell}-{seed}.json.gz")


def _category(e) -> str:
    """The Kineto activity type of an event: read where the profiler
    gives it, else told apart by device, annotation flag and name (a
    runtime call's name starts with 'cuda' or 'cuLaunch')."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    user = e.is_user_annotation() if hasattr(e, "is_user_annotation") \
        else None
    if str(e.device_type()).endswith("CUDA"):
        if user:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if user:
        return "user_annotation"
    if name.startswith(("cuda", "cuLaunch")):
        return "cuda_runtime"
    return "cpu_op"


def kineto_events(prof) -> List[tuple]:
    """(category, name, start us, duration us, thread, correlation) of
    the events a finished torch.profiler.profile recorded that the
    readers use."""
    keep = DEVICE_CATS + LAUNCH_CATS + HOST_CATS
    out = []
    for e in prof.profiler.kineto_results.events():
        cat = _category(e)
        if cat in keep:
            out.append((cat, e.name(), e.start_ns() / 1e3,
                        e.duration_ns() / 1e3, e.start_thread_id(),
                        e.correlation_id()))
    return out


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The window's device activity and host ranges, in microseconds."""

    def __init__(self, events: List[tuple]):
        win = [e for e in events if e[1] == WINDOW
               and e[0] == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} range")
        _, _, ts, dur, self.main_tid, _ = win[0]
        self.t0, self.t1 = ts, ts + dur
        self._launch: Dict[object, float] = {}
        self.ranges: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self.host_ops: List[Tuple[float, float, str]] = []
        self.device: List[Tuple[float, float, str, str, object]] = []
        for cat, name, ts, dur, tid, corr in events:
            if cat in DEVICE_CATS:
                if self.t0 <= ts <= self.t1:
                    self.device.append((ts, dur, name, cat, corr))
            elif cat in LAUNCH_CATS:
                self._launch[corr] = ts
            elif cat in HOST_CATS:
                if cat == "user_annotation":
                    self.ranges[name].append((ts, ts + dur))
                if tid == self.main_tid:
                    self.host_ops.append((ts, ts + dur, name))
        self.host_ops.sort(key=lambda h: (h[0], -h[1]))   # outer first
        self.busy = _merge([(ts, min(ts + dur, self.t1))
                            for ts, dur, *_ in self.device])

    def save(self, path: str) -> None:
        """The card's activity and the span ranges as a gzipped Chrome
        trace (microseconds), for Perfetto or chrome://tracing."""
        ev = [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
               "pid": 1, "tid": cat} for ts, dur, name, cat, _ in self.device]
        ev += [{"ph": "X", "cat": "span", "name": name, "ts": a,
                "dur": b - a, "pid": 0, "tid": "host"}
               for name, rs in self.ranges.items() for a, b in rs]
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": ev}, f)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def kernel_s_in(self, span: str) -> Optional[float]:
        """Seconds of the kernels launched inside any `span` range, or
        None when no kernel was."""
        rs = _merge(self.ranges.get(span, []))
        starts = [r[0] for r in rs]
        total, hit = 0.0, False
        for _ts, dur, _name, _cat, corr in self.kernels():
            at = self._launch.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= rs[i][1]:
                total += dur
                hit = True
        return total * 1e-6 if hit else None

    def top_device_ops(self, k: int = 10) -> List[list]:
        by = collections.Counter()
        for ts, dur, name, _cat, _corr in self.device:
            by[name] += dur
        return [[name, us * 1e-6] for name, us in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle seconds of the card in the window, summed by what the main
        host thread was doing at each gap's middle (its innermost range:
        an op or a span); the k largest."""
        by = collections.Counter()
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        ops, j, stack = self.host_ops, 0, []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            t = 0.5 * (a + b)
            while j < len(ops) and ops[j][0] <= t:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            by[stack[-1][2] if stack else "host (no range)"] += b - a
        return [[name, us * 1e-6] for name, us in by.most_common(k)]
