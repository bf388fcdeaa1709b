"""engine_sweep_roofline: the least time of the tests' s_W sweeps on a
resident matrix (bench.roofline.sw_labels_s, P = n_perms + 1) over the
device time of every kernel launched inside the program's `engine.sw`
spans, in percent. Nothing to read where no kernel ran in such a span."""


def read(ctx):
    busy = ctx.trace.kernel_s_in("engine.sw")
    if busy is None or ctx.traffic.get("covariates"):
        return None
    bound = ctx.roofline.sw_labels_s(ctx.n, ctx.n_total, ctx.group_sizes)
    return 100.0 * ctx.tests * bound / busy
