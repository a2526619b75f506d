"""Device milliseconds a traced step spends in the blocks' mixer calls (the
program's span ``block.attn``: the QKV projections, RoPE, K1 and the output
projection), their remat rerun and backward pass (``block.attn.bwd``)."""
from perfbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "block.attn")
