"""Device milliseconds a traced step spends in the MoE blocks: kernels
launched inside the benchmark's ranges around each block's forward call and
between the marks its backward pass crosses, less the attention that the
remat rerun of the layer group's forward launches inside the latter."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    t = ctx.trace.in_range("perfbench.moe", exclude=("perfbench.attn",))
    return None if not t else 1e3 * t / ctx.host["steps_traced"]
