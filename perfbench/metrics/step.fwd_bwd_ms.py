"""Device milliseconds a traced step spends in the kernels launched inside
the benchmark's range around the train step's loss-and-gradient call
(forward, the remat rerun and backward)."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    t = ctx.trace.in_range("perfbench.fwd_bwd")
    return None if not t else 1e3 * t / ctx.host["steps_traced"]
