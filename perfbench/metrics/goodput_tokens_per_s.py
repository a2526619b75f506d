"""Tokens of every optimizer step completed in a window that holds a
preemption, a checkpoint save, the migration and the restore, over the
window's seconds (ending in a synchronize)."""


def read(ctx):
    if ctx.kind != "migrate":
        return None
    return ctx.host["steps"] * ctx.host["tokens_per_step"] / ctx.host["window_s"]
