"""What the span readers share: kernels by the span their launch lies in,
the card's idle time inside or outside a span's ranges, and a span's host
time, all read from `ctx.trace` (microseconds). No per-layer metric of
BENCHMARK.json is named after this file."""

from __future__ import annotations

import bisect

from bench.tracing import _merge as merged


def ranges(trace, span: str):
    """The span's ranges, merged, cut to the window."""
    return merged((max(a, trace.t0), min(b, trace.t1))
                  for a, b in trace.ranges.get(span, [])
                  if b > trace.t0 and a < trace.t1)


def _inside(rs, starts, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= rs[i][1]


def kernels_in(trace, span: str, without: str = None) -> list:
    """The window's kernels whose launch lies inside a `span` range (and
    outside every `without` range), joined by correlation id as
    `Trace.kernel_s_in` joins them; a kernel with no launch is left out."""
    rs = merged(trace.ranges.get(span, []))
    starts = [r[0] for r in rs]
    out_rs = merged(trace.ranges.get(without, [])) if without else []
    out_starts = [r[0] for r in out_rs]
    found = []
    for k in trace.kernels():
        at = trace._launch.get(k[4])
        if at is None or not _inside(rs, starts, at):
            continue
        if out_rs and _inside(out_rs, out_starts, at):
            continue
        found.append(k)
    return found


def kernel_s(kernels) -> float:
    return sum(k[1] for k in kernels) * 1e-6


def overlap_us(a, b) -> float:
    """The length of the intersection of two merged, sorted lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_us(trace, rs) -> float:
    """Microseconds of `rs` (merged, inside the window) in which nothing
    ran on the card."""
    return sum(b - a for a, b in rs) - overlap_us(rs, trace.busy)


def outside(trace, rs):
    """The window less `rs` (merged, inside the window)."""
    out, t = [], trace.t0
    for a, b in rs:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if trace.t1 > t:
        out.append((t, trace.t1))
    return out
