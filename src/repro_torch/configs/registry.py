"""--arch <id> registry: the ten assigned architectures and the
paper-native micro workloads, as in the JAX package's registry.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE_1B
from repro_torch.configs.jamba_v0_1 import CONFIG as JAMBA_V01
from repro_torch.configs.micro_lm import CONFIG as MICRO_LM, CONFIG_100M as MICRO_LM_100M
from repro_torch.configs.phi3_5_moe import CONFIG as PHI35_MOE
from repro_torch.configs.qwen1_5_32b import CONFIG as QWEN15_32B
from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN25_32B
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN3_17B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.xlstm_1_3b import CONFIG as XLSTM_13B

ARCHS: Dict[str, ModelConfig] = {
    "granite-moe-1b-a400m": GRANITE_MOE_1B,
    "gemma2-2b": GEMMA2_2B,
    "qwen3-1.7b": QWEN3_17B,
    "qwen2.5-32b": QWEN25_32B,
    "qwen1.5-32b": QWEN15_32B,
    "phi3.5-moe-42b-a6.6b": PHI35_MOE,
    "qwen2-vl-7b": QWEN2_VL_7B,
    "jamba-v0.1-52b": JAMBA_V01,
    "xlstm-1.3b": XLSTM_13B,
    "whisper-tiny": WHISPER_TINY,
    "micro-lm": MICRO_LM,
    "micro-lm-100m": MICRO_LM_100M,
}

ASSIGNED = tuple(k for k in ARCHS if not k.startswith("micro-lm"))


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]
