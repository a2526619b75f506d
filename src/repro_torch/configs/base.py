"""Model configuration dataclass (the port's copy of ``repro/configs/base.py``).

Every architecture is expressed as a ``ModelConfig``; the model factory
(``repro_torch.models.model``) consumes only this dataclass.  The fields are
the JAX package's, so a config means the same model in both packages.
``param_count`` / ``active_param_count`` are copies of the reference's
analytic counts.
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


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (exact for this implementation; used by the
    feasibility model before a model is ever instantiated)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    total = 0
    # embeddings
    total += cfg.vocab_size * d
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d
    if cfg.learned_pos:
        total += 32768 * d

    def attn_params() -> int:
        p = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if cfg.qkv_bias:
            p += nh * hd + 2 * nkv * hd
        if cfg.qk_norm:
            p += 2 * hd
        return p

    def dense_mlp() -> int:
        return 3 * d * cfg.d_ff  # SwiGLU (gate, up, down)

    def moe_mlp() -> int:
        return cfg.num_experts * 3 * d * cfg.expert_d_ff + d * cfg.num_experts

    def mamba_params() -> int:
        d_in = cfg.mamba_expand * d
        dt_rank = max(1, d // 16)
        p = d * 2 * d_in  # in_proj
        p += d_in * cfg.mamba_d_conv + d_in  # conv1d + bias
        p += d_in * (dt_rank + 2 * cfg.mamba_d_state)  # x_proj
        p += dt_rank * d_in + d_in  # dt_proj
        p += d_in * cfg.mamba_d_state + d_in  # A_log, D
        p += d_in * d  # out_proj
        return p

    def mlstm_params() -> int:
        d_in = 2 * d
        dh = d_in // max(cfg.num_heads, 1)
        p = d * 2 * d_in  # up proj (x | z-gate)
        p += 3 * cfg.num_heads * dh * dh  # block-diagonal q,k,v
        p += 2 * d_in * cfg.num_heads + 2 * cfg.num_heads  # i/f gates
        p += d_in  # skip
        p += d_in * d  # down proj
        return p

    def slstm_params() -> int:
        p = 4 * d * d + 4 * d  # i,f,z,o projections
        p += 2 * d * (d * 4 // 3)  # gated FFN up/gate (pf 4/3)
        p += (d * 4 // 3) * d
        return p

    unit_cost = 0
    for i, kind in enumerate(cfg.block_pattern):
        if kind.startswith("attn"):
            unit_cost += attn_params() + 2 * d  # + norms
            if cfg.moe and (not cfg.moe_pattern or i in cfg.moe_pattern):
                unit_cost += moe_mlp()
            else:
                unit_cost += dense_mlp()
        elif kind == "mamba":
            unit_cost += mamba_params() + 2 * d
            if cfg.moe and (not cfg.moe_pattern or i in cfg.moe_pattern):
                unit_cost += moe_mlp()
            else:
                unit_cost += dense_mlp()
        elif kind == "mlstm":
            unit_cost += mlstm_params() + 2 * d
        elif kind == "slstm":
            unit_cost += slstm_params() + 2 * d
        else:
            raise ValueError(kind)
    total += cfg.num_groups * unit_cost
    # encoder (whisper): attn + cross-attn-free encoder blocks, decoder adds
    # cross attention per layer (counted roughly; exact count comes from the
    # instantiated pytree which the checkpoint manager measures).
    if cfg.is_encdec:
        enc = cfg.encoder_layers * (attn_params() + dense_mlp() + 2 * d)
        xattn = cfg.num_layers * (attn_params() + d)
        total += enc + xattn
    total += d  # final norm
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top_k of num_experts)."""
    if not cfg.moe:
        return param_count(cfg)
    full = param_count(cfg)
    d = cfg.d_model
    per_expert = 3 * d * cfg.expert_d_ff
    n_moe_layers = (
        cfg.num_groups * (len(cfg.moe_pattern) if cfg.moe_pattern else len(cfg.block_pattern))
    )
    inactive = n_moe_layers * (cfg.num_experts - cfg.top_k) * per_expert
    return int(full - inactive)
