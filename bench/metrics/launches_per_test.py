"""launches_per_test: kernels the card ran in the traced window over the
tests of the window (every test started in it also ended in it)."""


def read(ctx):
    kernels = len(ctx.trace.kernels())
    if not ctx.tests or not kernels:
        return None
    return kernels / ctx.tests
