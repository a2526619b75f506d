"""Paper-native single-node workloads (copy of ``repro/configs/micro_lm.py``).

The paper's migratory jobs are single-GPU fine-tunes (ResNet-50 / GPT-2-
scale, 1-40 GB checkpoints). `micro-lm` (~31M) and `micro-lm-100m` (~100M)
are the concrete jobs the end-to-end examples train and serve.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="micro-lm",
    family="dense",
    num_layers=8,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=32000,
    tie_embeddings=True,
    dtype="float32",
    source="paper-native micro workload",
)

CONFIG_100M = ModelConfig(
    name="micro-lm-100m",
    family="dense",
    num_layers=20,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=32000,
    tie_embeddings=True,
    dtype="float32",
    source="paper-native ~100M workload (examples/train_micro_lm.py)",
)
