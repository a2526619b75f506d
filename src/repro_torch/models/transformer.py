"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

Only the dense ``("attn",)`` block pattern is ported.  The layer stack is
``num_groups`` repetitions of ``cfg.block_pattern`` with group params
stacked on a leading dim, as in the JAX package, so the param tree and its
checkpoint paths match; the JAX ``lax.scan`` over groups is a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    apply_embed,
    apply_mlp,
    apply_norm,
    apply_unembed,
    init_embed,
    init_mlp,
    init_norm,
    softcap,
)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any block or input the port does not have yet."""
    for kind in cfg.block_pattern:
        if kind != "attn":
            raise NotImplementedError(
                f"{cfg.name}: block {kind!r} is not ported yet (ROADMAP Queue 1, item 10)")
    if cfg.moe:
        raise NotImplementedError(f"{cfg.name}: MoE is not ported yet (ROADMAP Queue 1, item 10)")
    if cfg.is_encdec or cfg.input_mode != "tokens" or cfg.learned_pos:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder / embedding inputs are not ported yet "
            "(ROADMAP Queue 1, item 10)")


def _mixer_kwargs(cfg: ModelConfig) -> dict:
    return dict(
        rope_type=cfg.rope_type,
        rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections,
        qk_norm=cfg.qk_norm,
        mask_kind="causal",
        window=0,
        attn_softcap=cfg.attn_softcap,
    )


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def init_block(gen, cfg: ModelConfig, device) -> dict:
    dt = _dtype(cfg)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm_type, dt, device),
        "attn": attn_lib.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            num_layers=cfg.num_layers, dtype=dt, device=device,
        ),
        "norm2": init_norm(cfg.d_model, cfg.norm_type, dt, device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.num_layers, dt, device),
    }


def apply_block(p: dict, x, cfg: ModelConfig, positions):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    x = x + attn_lib.apply_attention(p["attn"], h, positions=positions, **_mixer_kwargs(cfg))
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    return x + apply_mlp(p["mlp"], h, cfg.act)


def apply_block_decode(p, x, cfg: ModelConfig, positions, index: int, cache):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    mix, cache = attn_lib.apply_attention_decode(
        p["attn"], h, cache, index, positions=positions, **_mixer_kwargs(cfg))
    x = x + mix
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    return x + apply_mlp(p["mlp"], h, cfg.act), cache


# ---------------------------------------------------------------------------
# Param tree helpers
# ---------------------------------------------------------------------------


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unembed_table(params, cfg: ModelConfig):
    return params["embed"]["table"].T if cfg.tie_embeddings else params["unembed"]["table"]


# ---------------------------------------------------------------------------
# LM init / forward
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    check_ported(cfg)
    dt = _dtype(cfg)
    params: Dict[str, Any] = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dt, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": init_embed(gen, cfg.d_model, cfg.vocab_size, dt, device)["table"]}
    params["groups"] = _stack([
        {f"b{i}": init_block(gen, cfg, device) for i in range(len(cfg.block_pattern))}
        for _ in range(cfg.num_groups)
    ])
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm_type, dt, device)
    return params


def embed_inputs(params, cfg: ModelConfig, batch: dict):
    x = apply_embed(params["embed"], batch["tokens"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def lm_forward(params: dict, batch: dict, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, vocab), aux_loss)."""
    check_ported(cfg)
    x = embed_inputs(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    for g in range(cfg.num_groups):
        gp = _index(params["groups"], g)
        for i in range(len(cfg.block_pattern)):
            x = apply_block(gp[f"b{i}"], x, cfg, positions)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = softcap(apply_unembed(_unembed_table(params, cfg), x), cfg.logit_softcap)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Cache / decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{'b<i>': {'k': (shape, dtype), 'v': ...}} with the leading group dim."""
    check_ported(cfg)
    shape = (cfg.num_groups, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {f"b{i}": {"k": (shape, _dtype(cfg)), "v": (shape, _dtype(cfg))}
            for i in range(len(cfg.block_pattern))}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    return {blk: {name: torch.zeros(shape, dtype=dt, device=device)
                  for name, (shape, dt) in spec.items()}
            for blk, spec in cache_specs(cfg, batch, max_len).items()}


def lm_decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode; batch = {'token': (b,), 'index': int}.  Returns
    (logits (b, vocab), cache); the cache is updated in place."""
    check_ported(cfg)
    index = int(batch["index"])
    x = embed_inputs(params, cfg, {"tokens": batch["token"][:, None]})
    b = x.shape[0]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.full((b, 1), index, device=x.device)
    for g in range(cfg.num_groups):
        gp = _index(params["groups"], g)
        for i in range(len(cfg.block_pattern)):
            blk = f"b{i}"
            gc = {name: c[g] for name, c in cache[blk].items()}  # views into the stack
            x, _ = apply_block_decode(gp[blk], x, cfg, positions, index, gc)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = softcap(apply_unembed(_unembed_table(params, cfg), x), cfg.logit_softcap)
    return logits[:, 0], cache
