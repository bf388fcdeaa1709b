"""sw_kernel_roofline: the least time of the tests' s_W sweeps on a
resident matrix (bench.roofline.sw_labels_s, P = n_perms + 1) over the
device time of the kernels launched inside the program's `engine.sw`
spans and outside its `engine.draw` spans (the s_W kernel without the
label draws), in percent. Nothing to read with covariates (as
engine_sweep_roofline), where the program marks no draw (a program
without `engine.draw` spans cannot tell the draws from the kernel), or
where no such kernel ran."""

from bench.metrics import _spans


def read(ctx):
    if ctx.traffic.get("covariates") or not ctx.trace.ranges.get(
            "engine.draw"):
        return None
    kernels = _spans.kernels_in(ctx.trace, "engine.sw", without="engine.draw")
    if not kernels:
        return None
    bound = ctx.roofline.sw_labels_s(ctx.n, ctx.n_total, ctx.group_sizes)
    return 100.0 * ctx.tests * bound / _spans.kernel_s(kernels)
