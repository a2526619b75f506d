"""qwen2.5-32b [dense] — GQA (8 KV heads), QKV bias. [hf:Qwen/Qwen2.5-0.5B
family scaling; hf]

Copy of ``repro/configs/qwen2_5_32b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5 family (hf tier)",
)
