"""The attention backward kernels' share of their roofline: the least time
of the traced backward calls (each launches flash_bwd_delta_kernel and
flash_bwd_kernel) over the two kernels' summed time."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    seconds, _ = ctx.trace.kernels("flash_bwd_kernel", "flash_bwd_delta_kernel")
    _, calls = ctx.trace.kernels("flash_bwd_kernel")
    if not calls:
        return None
    ops, nbytes = ctx.flops.k1_backward(ctx.config, ctx.mix["batch"], ctx.mix["seq"])
    return ctx.flops.roofline_share(ops * calls, nbytes * calls, seconds, ctx.config["torch_dtype"])
