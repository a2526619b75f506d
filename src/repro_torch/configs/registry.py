"""--arch <id> registry of the configs the port can build.

The JAX package's registry also holds ten assigned architectures.  Their
blocks (MoE, Mamba, xLSTM, M-RoPE, encoder-decoder, qk-norm, biases,
windows) are not ported yet; asking for one raises and names the ROADMAP
item that ports it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.micro_lm import CONFIG as MICRO_LM, CONFIG_100M as MICRO_LM_100M

ARCHS: Dict[str, ModelConfig] = {
    "micro-lm": MICRO_LM,
    "micro-lm-100m": MICRO_LM_100M,
}

NOT_PORTED = (
    "whisper-tiny", "qwen2-vl-7b", "phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m",
    "jamba-v0.1-52b", "qwen2.5-32b", "qwen1.5-32b", "gemma2-2b", "qwen3-1.7b",
    "xlstm-1.3b",
)


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet (ROADMAP Queue 1, item 10)")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
