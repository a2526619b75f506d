"""GB (1e9 bytes) of the card's memory the window's steps held at their
peak (``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(ctx):
    if ctx.kind != "train" or "peak_window_bytes" not in ctx.host:
        return None
    return ctx.host["peak_window_bytes"] / 1e9
