"""idle_outside_ms: the card's idle time while no `engine.run` range of
the program is open (the harness between tests, F and p to the host),
over the window's tests, in ms a test. Nothing to read where the window
holds no such range, or where nothing ran on a card (a CPU run)."""

from bench.metrics import _spans


def read(ctx):
    rs = _spans.ranges(ctx.trace, "engine.run")
    if not rs or not ctx.tests or not ctx.trace.busy:
        return None
    gaps = _spans.outside(ctx.trace, rs)
    return 1e-3 * _spans.idle_in_us(ctx.trace, gaps) / ctx.tests
