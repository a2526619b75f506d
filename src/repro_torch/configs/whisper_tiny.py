"""whisper-tiny [audio] — enc-dec, conv frontend stubbed (input_specs feeds
precomputed (B, 1500, 384) frame embeddings). [arXiv:2212.04356; unverified]

Copy of ``repro/configs/whisper_tiny.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers
    encoder_layers=4,
    encoder_seq=1500,  # 30 s audio -> 1500 frames after the conv stub
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    rope_type="none",
    learned_pos=True,
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
    input_mode="tokens",  # decoder side; encoder side takes 'frames'
    source="arXiv:2212.04356 (unverified tier)",
)
