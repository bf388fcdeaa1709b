"""plan_host_ms: the host's time in the program's `engine.plan` ranges
(every step of a call before its sweep: the design, the matrix squared,
the group sizes, the planner, the bound impl) over the window's tests, in
ms a test. Nothing to read where the window holds no such range."""

from bench.metrics import _spans


def read(ctx):
    rs = _spans.ranges(ctx.trace, "engine.plan")
    if not rs or not ctx.tests:
        return None
    return 1e-3 * sum(b - a for a, b in rs) / ctx.tests
