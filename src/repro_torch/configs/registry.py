"""--arch <id> registry of the configs the port can build.

The JAX package's registry also holds ten assigned architectures.  Seven
are ported: the attention family (qwen3-1.7b, gemma2-2b,
granite-moe-1b-a400m, qwen2.5-32b, qwen1.5-32b, phi3.5-moe-42b-a6.6b and
qwen2-vl-7b, the last with M-RoPE and embedding inputs).  The other three
need mixers the port does not have yet (jamba's Mamba, xlstm's mLSTM /
sLSTM, whisper's encoder-decoder); asking for one raises and names the
ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma2_2b import CONFIG as GEMMA2_2B
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE_1B
from repro_torch.configs.micro_lm import CONFIG as MICRO_LM, CONFIG_100M as MICRO_LM_100M
from repro_torch.configs.phi3_5_moe import CONFIG as PHI35_MOE
from repro_torch.configs.qwen1_5_32b import CONFIG as QWEN15_32B
from repro_torch.configs.qwen2_5_32b import CONFIG as QWEN25_32B
from repro_torch.configs.qwen2_vl_7b import CONFIG as QWEN2_VL_7B
from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN3_17B

ARCHS: Dict[str, ModelConfig] = {
    "granite-moe-1b-a400m": GRANITE_MOE_1B,
    "gemma2-2b": GEMMA2_2B,
    "qwen3-1.7b": QWEN3_17B,
    "qwen2.5-32b": QWEN25_32B,
    "qwen1.5-32b": QWEN15_32B,
    "phi3.5-moe-42b-a6.6b": PHI35_MOE,
    "qwen2-vl-7b": QWEN2_VL_7B,
    "micro-lm": MICRO_LM,
    "micro-lm-100m": MICRO_LM_100M,
}

NOT_PORTED = ("whisper-tiny", "jamba-v0.1-52b", "xlstm-1.3b")


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet (ROADMAP Queue 1, item 10)")
    raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
