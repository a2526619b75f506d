"""The int8 quantize kernel's (K2) share of its bandwidth roofline in the
traced window's save: the bytes of every int8 leaf of the checkpoint (from
its manifest) over their launches' summed time."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "migrate" or not ctx.notes.get("int8_leaves"):
        return None
    seconds, launches = ctx.trace.kernels("quantize_int8_kernel")
    sizes = ctx.notes["int8_leaves"]
    if launches != len(sizes) or not seconds:
        return None
    nbytes = sum(ctx.flops.k2_bytes(n) for n in sizes)
    return ctx.flops.roofline_share(0.0, nbytes, seconds, "float32")
