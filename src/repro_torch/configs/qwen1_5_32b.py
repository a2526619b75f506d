"""qwen1.5-32b [dense] — MHA (40 KV heads == 40 Q heads), QKV bias.
[hf:Qwen/Qwen1.5 family; hf]

Copy of ``repro/configs/qwen1_5_32b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5 family (hf tier)",
)
