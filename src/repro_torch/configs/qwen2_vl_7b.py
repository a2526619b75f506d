"""qwen2-vl-7b [vlm] — M-RoPE, dynamic-resolution vision frontend stubbed
(input_specs feeds precomputed patch/text embeddings + 3-D t/h/w position
ids). [arXiv:2409.12191; hf]

Copy of ``repro/configs/qwen2_vl_7b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    rope_type="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # half-dim split over t/h/w streams
    qkv_bias=True,
    input_mode="embeddings",
    source="arXiv:2409.12191 (hf tier)",
)
