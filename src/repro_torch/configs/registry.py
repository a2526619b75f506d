"""--arch <id> registry of the configs the port can build.

The JAX package's registry also holds ten assigned architectures.  Three are
ported (qwen3-1.7b, gemma2-2b, granite-moe-1b-a400m); the other seven need
blocks or inputs the port does not have yet (Mamba, xLSTM, M-RoPE,
encoder-decoder, embeddings input) or have not been brought up on the card,
and asking for one raises and names the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE_1B
from repro_torch.configs.micro_lm import CONFIG as MICRO_LM, CONFIG_100M as MICRO_LM_100M
from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN3_17B

ARCHS: Dict[str, ModelConfig] = {
    "granite-moe-1b-a400m": GRANITE_MOE_1B,
    "gemma2-2b": GEMMA2_2B,
    "qwen3-1.7b": QWEN3_17B,
    "micro-lm": MICRO_LM,
    "micro-lm-100m": MICRO_LM_100M,
}

NOT_PORTED = (
    "whisper-tiny", "qwen2-vl-7b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b", "qwen2.5-32b",
    "qwen1.5-32b", "xlstm-1.3b",
)


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet (ROADMAP Queue 1, item 10)")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
