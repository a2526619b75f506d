"""Device milliseconds a traced step spends adding the experts' rows back into
the tokens, weighted by their gates (the program's span ``moe.combine``),
forward, remat rerun and backward."""
from perfbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "moe.combine")
