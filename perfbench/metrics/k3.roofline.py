"""The int8 dequantize kernel's (K3) share of its bandwidth roofline in the
traced window's restore."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "migrate" or not ctx.notes.get("int8_leaves"):
        return None
    seconds, launches = ctx.trace.kernels("dequantize_int8_kernel")
    sizes = ctx.notes["int8_leaves"]
    if launches != len(sizes) or not seconds:
        return None
    nbytes = sum(ctx.flops.k3_bytes(n) for n in sizes)
    return ctx.flops.roofline_share(0.0, nbytes, seconds, "float32")
