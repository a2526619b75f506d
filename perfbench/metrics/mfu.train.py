"""Per cent of the card's peak (989 TFLOP/s bf16, 495 TF32 for float32) that
the window's model FLOPs (6 x matmul parameters per token x tokens, plus
causal attention, no recomputation) come to over its seconds."""


def read(ctx):
    if ctx.kind != "train":
        return None
    h = ctx.host
    flops = h["steps"] * h["model_flops_per_step"]
    return 100.0 * flops / (h["window_s"] * ctx.flops.PEAK_FLOPS[h["dtype"]])
