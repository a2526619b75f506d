"""The yardstick's arithmetic: the card's peaks, a training step's model
FLOPs, and each kernel's operations and bytes for its roofline.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W, dense
(no sparsity).  A float32 configuration is held to the TF32 tensor-core
peak: schemes that keep float32 accuracy on the tensor cores (the program's
attention kernel splits each operand into three TF32 products) run faster
than the 67 TFLOP/s of the CUDA cores, so that lower peak would let a sound
program read over 100%.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def matmul_params_per_token(cfg: dict) -> int:
    """Weights a token multiplies by in one forward pass: the attention
    projections, the MLP or the router and the top-k experts, and the
    output head (the embedding lookup is no product)."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    nh, nkv, f = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"]
    attn = d * (nh + 2 * nkv) * hd + nh * hd * d
    experts = cfg.get("num_local_experts", 0)
    if experts:
        ffn = cfg["num_experts_per_tok"] * 3 * d * f + d * experts
    else:
        ffn = 3 * d * f
    return cfg["num_hidden_layers"] * (attn + ffn) + cfg["vocab_size"] * d


def attention_flops_per_step(cfg: dict, batch: int, seq: int) -> float:
    """Causal attention's two products in forward and backward (3x the
    forward), over half the square of the sequence."""
    fwd = 2 * 2 * batch * cfg["num_attention_heads"] * head_dim(cfg) * seq * seq / 2
    return 3 * fwd * cfg["num_hidden_layers"]


def model_flops_per_step(cfg: dict, batch: int, seq: int) -> float:
    """6 x matmul params per token x tokens, plus causal attention; no
    recomputation counted."""
    return 6.0 * matmul_params_per_token(cfg) * batch * seq + attention_flops_per_step(cfg, batch, seq)


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def k1_forward(cfg: dict, batch: int, seq: int):
    """(operations, bytes) of one causal attention forward launch: QK^T and
    PV over the visible pairs; q, k, v read once, the output and the row
    log-sum-exp written once."""
    nh, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    es = ELEM_BYTES[cfg["torch_dtype"]]
    ops = 4 * batch * nh * hd * causal_pairs(seq)
    nbytes = batch * seq * hd * es * (nh + 2 * nkv + nh) + batch * nh * seq * 4
    return ops, nbytes


def k1_backward(cfg: dict, batch: int, seq: int):
    """(operations, bytes) of one attention backward launch: the scores
    again, dP, dV, dQ and dK over the visible pairs; q, k, v, o, dO and the
    log-sum-exp read once, dQ, dK and dV written once."""
    nh, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    es = ELEM_BYTES[cfg["torch_dtype"]]
    ops = 10 * batch * nh * hd * causal_pairs(seq)
    reads = batch * seq * hd * es * (nh + 2 * nkv + nh + nh) + batch * nh * seq * 4
    writes = batch * seq * hd * es * (nh + 2 * nkv)
    return ops, reads + writes


def k2_bytes(n_padded: int) -> int:
    """int8 quantize of n float32 values: read 4n, write n codes and n/256
    float32 scales."""
    return 4 * n_padded + n_padded + 4 * (n_padded // 256)


def k3_bytes(n_padded: int) -> int:
    """int8 dequantize: read n codes and n/256 scales, write 4n."""
    return n_padded + 4 * (n_padded // 256) + 4 * n_padded


def roofline_share(ops: float, nbytes: float, seconds: float, dtype: str) -> float:
    """Per cent of the least time the card could take (the larger of
    operations over peak and bytes over bandwidth) in ``seconds``."""
    least = max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
    return 100.0 * least / seconds
