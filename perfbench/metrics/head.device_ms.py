"""Device milliseconds a traced step spends in the LM head: the final norm and
the unembedding (the program's span ``model.head``), the cross-entropy and the
aux sum (``model.loss``), and their backward passes."""
from perfbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "model.head", "model.loss")
