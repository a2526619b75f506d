"""Per cent of the traced steps' window with nothing running on the card."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "train":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
