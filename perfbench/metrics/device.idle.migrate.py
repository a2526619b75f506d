"""Per cent of the traced window (training, the preemption's save, the
migration, the restore and the resumed training) with nothing running on
the card."""


def read(ctx):
    if ctx.trace is None or ctx.kind != "migrate":
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
