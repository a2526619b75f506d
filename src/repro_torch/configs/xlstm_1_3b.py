"""xlstm-1.3b [ssm] — mLSTM:sLSTM 7:1 interleave (xLSTM[7:1]), 48 blocks,
4 heads, no separate FFN in mLSTM blocks (d_ff=0 per assignment; the
projection factors live inside the blocks). [arXiv:2405.04517; unverified]

Copy of ``repro/configs/xlstm_1_3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=0,
    rope_type="none",
    block_pattern=(
        "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm",
    ),
    source="arXiv:2405.04517 (unverified tier)",
)
