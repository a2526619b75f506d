"""Seconds of the destination's ``Trainer.restore``, on the host clock up to
a synchronize."""


def read(ctx):
    if ctx.kind != "migrate":
        return None
    return ctx.host.get("restore_s")
