"""Device milliseconds a traced step spends routing tokens to experts (the
program's span ``moe.route``: router logits, softmax, top-k, the combine and
dispatch weights), forward, remat rerun and backward."""
from perfbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "moe.route")
