"""Device milliseconds a traced step spends in the kernels launched inside
the benchmark's range around the AdamW update."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    t = ctx.trace.in_range("perfbench.optimizer")
    return None if not t else 1e3 * t / ctx.host["steps_traced"]
