"""Tokens of every optimizer step completed in the window over the window's
seconds; the window ends when the card has finished (a synchronize)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.host["steps"] * ctx.host["tokens_per_step"] / ctx.host["window_s"]
