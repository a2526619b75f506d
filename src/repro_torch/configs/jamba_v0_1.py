"""jamba-v0.1-52b [hybrid] — Mamba:attention 7:1 interleave (attention at
position 4 of each 8-layer block), MoE every other layer (16 experts,
top-2). No positional encoding (Mamba provides order). [arXiv:2403.19887; hf]

Copy of ``repro/configs/jamba_v0_1.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    rope_type="none",
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    moe=True,
    num_experts=16,
    top_k=2,
    moe_pattern=(1, 3, 5, 7),  # every other layer inside the 8-layer unit
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    source="arXiv:2403.19887 (hf tier)",
)
