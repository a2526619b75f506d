"""Device milliseconds a traced step spends in the blocks' MLP or MoE calls (the
program's span ``block.ffn``), their remat rerun and backward pass
(``block.ffn.bwd``, less the layer group's rerun that opens inside it)."""
from perfbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "block.ffn")
