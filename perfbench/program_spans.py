"""Device time of the program's own spans (``repro_torch.spans``).

The port opens a span around each layer's call and, where autograd records
the call, a span ``<name>.bwd`` around its backward pass.  Under remat the
backward pass reruns a layer group's forward (inside ``model.group``) in
whichever ``.bwd`` span opens first: that rerun is forward work, counted by
the forward spans it opens, never by a ``.bwd`` span.  So a span's device
time per traced step is

    in_range(X) + in_range(X + ".bwd", exclude=("model.group",))

over the steps traced.
"""
from typing import Optional

RERUN = ("model.group",)


def span_ms(ctx, *names: str) -> Optional[float]:
    """Device milliseconds a traced training step spends in the kernels
    launched inside the program spans ``names`` and their backward spans;
    None where none of them ran (a program without them, or a cell without
    that layer)."""
    if ctx.trace is None or ctx.kind != "train":
        return None
    total, seen = 0.0, False
    for name in names:
        forward = ctx.trace.in_range(name)
        if forward is None:
            continue
        seen = True
        total += forward + (ctx.trace.in_range(name + ".bwd", exclude=RERUN) or 0.0)
    return 1e3 * total / ctx.host["steps_traced"] if seen else None


def counters() -> Optional[dict]:
    """The program's counters, or None for a program without them."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.counts()
