"""Per cent of the token rows the expert GEMMs compute that were routed to
their expert: 100 x the program's counters ``moe.rows_routed`` over
``moe.rows_computed`` (the dense dispatch computes every row for every
expert: top_k / E)."""
from perfbench.program_spans import counters


def read(ctx):
    if ctx.kind != "train":
        return None
    c = counters()
    if not c or not c.get("moe.rows_computed"):
        return None
    return 100.0 * c.get("moe.rows_routed", 0) / c["moe.rows_computed"]
