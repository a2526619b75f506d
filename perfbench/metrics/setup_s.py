"""Seconds from the process's start to the start of the measured window:
imports, the kernel library's load (its build in a checkout's first run),
the weights, the batches, the trainer and its first steps."""


def read(ctx):
    return ctx.host["setup_s"]
