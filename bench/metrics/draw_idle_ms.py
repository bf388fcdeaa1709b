"""draw_idle_ms: the card's idle time (the window less its busy
intervals) inside the program's `engine.draw` ranges, over the window's
tests, in ms a test: how long the card waits on the draws' dispatch.
Nothing to read where the window holds no such range, or where nothing
ran on a card (a CPU run)."""

from bench.metrics import _spans


def read(ctx):
    rs = _spans.ranges(ctx.trace, "engine.draw")
    if not rs or not ctx.tests or not ctx.trace.busy:
        return None
    return 1e-3 * _spans.idle_in_us(ctx.trace, rs) / ctx.tests
