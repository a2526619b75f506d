"""Per cent of the card's peak that the migrating window's model FLOPs come
to over its seconds (in the traced run, the profiler's window)."""


def read(ctx):
    if ctx.kind != "migrate":
        return None
    h = ctx.host
    flops = h["steps"] * h["model_flops_per_step"]
    return 100.0 * flops / (h["window_s"] * ctx.flops.PEAK_FLOPS[h["dtype"]])
