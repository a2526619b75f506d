"""Seconds of the preemption's checkpoint save: the trainer's record of it
(``CheckpointInfo.wall_time_s``: from the device-to-host copy, which waits
for the card, to the written file)."""


def read(ctx):
    if ctx.kind != "migrate":
        return None
    return ctx.host.get("save_s")
