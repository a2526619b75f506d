"""Device milliseconds a traced step spends bringing token rows to the experts
(the program's span ``moe.dispatch``: the dense path's (E, b, s, d) buffers,
the capacity path's gather), forward, remat rerun and backward."""
from perfbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "moe.dispatch")
