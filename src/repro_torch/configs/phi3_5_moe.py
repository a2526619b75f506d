"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2 routing, every layer MoE.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]

Copy of ``repro/configs/phi3_5_moe.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,  # per-expert intermediate
    vocab_size=32064,
    head_dim=128,
    moe=True,
    num_experts=16,
    top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct (hf tier)",
)
