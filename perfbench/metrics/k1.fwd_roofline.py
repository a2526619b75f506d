"""The attention forward kernel's (K1) share of its roofline: the least time
of its traced launches (larger of operations over the dtype's peak and bytes
over HBM bandwidth, at the cell's shape) over their summed kernel time."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    seconds, launches = ctx.trace.kernels("flash_fwd_kernel")
    if not launches:
        return None
    ops, nbytes = ctx.flops.k1_forward(ctx.config, ctx.mix["batch"], ctx.mix["seq"])
    return ctx.flops.roofline_share(ops * launches, nbytes * launches, seconds,
                                    ctx.config["torch_dtype"])
