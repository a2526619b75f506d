"""Device milliseconds a traced step spends in the experts' SwiGLU GEMMs and
products (the program's span ``moe.experts``), forward, remat rerun and
backward."""
from perfbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "moe.experts")
