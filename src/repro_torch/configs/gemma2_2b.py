"""gemma2-2b [dense] — alternating local(4k sliding window)/global attention,
attention-logit softcap 50, final-logit softcap 30, head_dim 256, tied
embeddings with sqrt(d) embed scaling. [arXiv:2408.00118; hf]

Copy of ``repro/configs/gemma2_2b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("attn_local", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2408.00118 (hf tier)",
)
