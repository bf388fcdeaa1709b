"""draw_launches_per_test: kernels launched inside the program's
`engine.draw` spans over the window's tests: the label draws' share of
the host's dispatch. Nothing to read where no kernel ran in such a
span."""

from bench.metrics import _spans


def read(ctx):
    kernels = _spans.kernels_in(ctx.trace, "engine.draw")
    if not kernels or not ctx.tests:
        return None
    return len(kernels) / ctx.tests
