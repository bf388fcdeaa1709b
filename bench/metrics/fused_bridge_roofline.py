"""fused_bridge_roofline: the least time of the tests' sweeps from
features (bench.roofline.fused_labels_s for a factor, fused_cols_s for a
design of K basis columns; P = n_perms + 1) over the device time of every
kernel launched inside the program's `bridge.fused-kernel` spans, in
percent. Nothing to read where no kernel ran in such a span."""


def read(ctx):
    busy = ctx.trace.kernel_s_in("bridge.fused-kernel")
    if busy is None:
        return None
    d = int(ctx.config["n_features"])
    if ctx.traffic.get("covariates"):
        bound = ctx.roofline.fused_cols_s(ctx.n, d, ctx.n_total,
                                          ctx.basis_cols)
    else:
        bound = ctx.roofline.fused_labels_s(ctx.n, d, ctx.n_total,
                                            ctx.group_sizes)
    return 100.0 * ctx.tests * bound / busy
