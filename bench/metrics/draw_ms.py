"""draw_ms: device time of the kernels launched inside the program's
`engine.draw` spans (each chunk's label draw, `core/permutations` through
`engine/scheduler`) over the window's tests, in ms a test. Nothing to read
where no kernel ran in such a span."""


def read(ctx):
    busy = ctx.trace.kernel_s_in("engine.draw")
    if busy is None or not ctx.tests:
        return None
    return 1e3 * busy / ctx.tests
