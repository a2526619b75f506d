"""granite-moe-1b-a400m [moe] — 32 experts, top-8 routing, every layer MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Copy of ``repro/configs/granite_moe_1b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,  # per-expert intermediate
    vocab_size=49155,
    head_dim=64,
    moe=True,
    num_experts=32,
    top_k=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (hf tier)",
)
