"""Model configuration dataclass (the port's copy of ``repro/configs/base.py``).

Every architecture is expressed as a ``ModelConfig``; the model factory
(``repro_torch.models.model``) consumes only this dataclass.  The fields are
the JAX package's, so a config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Block kinds usable in ``block_pattern`` (the repeating layer-group unit):
#   'attn'         full causal self-attention + MLP
#   'attn_local'   sliding-window self-attention + MLP (gemma2 local layers)
#   'mamba'        Mamba-1 selective-SSM mixer + MLP
#   'mlstm'        xLSTM matrix-LSTM block (self-contained, no separate MLP)
#   'slstm'        xLSTM scalar-LSTM block (self-contained, gated FFN inside)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---
    rope_type: str = "rope"  # 'rope' | 'mrope' | 'none'
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    sliding_window: int = 0

    # --- layer pattern (repeating unit; len must divide num_layers) ---
    block_pattern: Tuple[str, ...] = ("attn",)
    moe_pattern: Tuple[int, ...] = ()

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # 0 -> d_ff
    router_aux_coef: float = 0.01

    # --- mamba (jamba) ---
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- norm / activation / embeddings ---
    norm_type: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    act: str = "silu"  # 'silu' | 'gelu'
    tie_embeddings: bool = False
    embed_scale: bool = False

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    learned_pos: bool = False

    # 'tokens' (int ids -> embedding table) | 'embeddings' (precomputed)
    input_mode: str = "tokens"

    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def num_groups(self) -> int:
        if self.num_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern len {len(self.block_pattern)}")
        return self.num_layers // len(self.block_pattern)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the JAX package's rule)."""
        n_unit = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_unit * (2 if self.encoder_layers == 0 else 1) if n_unit > 1 else 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            moe_d_ff=64 if self.moe else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            encoder_layers=1 if self.encoder_layers else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            sliding_window=16 if self.sliding_window else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),
            dtype="float32",
        )
