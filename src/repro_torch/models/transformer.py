"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

The ported blocks are ``attn`` (causal) and ``attn_local`` (sliding
window), each followed by a dense MLP or, at the positions ``cfg.moe``
and ``cfg.moe_pattern`` pick, an MoE MLP whose aux losses the forward
sums.  Inputs are token ids or precomputed embeddings (``batch["embeds"]``,
qwen2-vl's stubbed vision frontend), and positions (b, s) or, for M-RoPE,
(b, s, 3) t / h / w streams.  Mamba and xLSTM blocks, encoder-decoder and
learned positions are not ported yet (``check_ported`` raises).  The layer stack is
``num_groups`` repetitions of ``cfg.block_pattern`` with group params
stacked on a leading dim, as in the JAX package, so the param tree and its
checkpoint paths match; the JAX ``lax.scan`` over groups is a Python loop,
and gradients reach the stacked leaves through the per-group indexing.
Rematerialization (``remat_policy``) wraps each group as ``_remat`` does
in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import flatten_with_paths, tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_embed,
    apply_mlp,
    apply_norm,
    apply_unembed,
    cross_entropy,
    init_embed,
    init_mlp,
    init_norm,
    softcap,
)


REMAT_POLICIES = ("none", "full", "dots")
# "dots": the matmul outputs are saved, everything else is recomputed.
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under activation checkpointing: "none" saves everything,
    "full" saves only the inputs (the whole group reruns in the backward
    pass), "dots" saves the matmul outputs (selective checkpointing).
    Without autograd recording there is nothing to save and ``fn`` runs as
    it is."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    if policy == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


ATTN_KINDS = ("attn", "attn_local")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any block or input the port does not have yet."""
    for kind in cfg.block_pattern:
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block {kind!r} is not ported yet (ROADMAP Queue 1, item 10)")
    if cfg.is_encdec or cfg.learned_pos:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder / learned positions are not ported yet "
            "(ROADMAP Queue 1, item 10)")


def _is_moe_pos(cfg: ModelConfig, i: int) -> bool:
    if not cfg.moe:
        return False
    return (not cfg.moe_pattern) or (i in cfg.moe_pattern)


def _mixer_kwargs(cfg: ModelConfig, kind: str) -> dict:
    local = kind == "attn_local"
    return dict(
        rope_type=cfg.rope_type,
        rope_theta=cfg.rope_theta,
        mrope_sections=cfg.mrope_sections,
        qk_norm=cfg.qk_norm,
        mask_kind="window" if local else "causal",
        window=cfg.sliding_window if local else 0,
        attn_softcap=cfg.attn_softcap,
    )


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def init_block(gen, cfg: ModelConfig, moe_here: bool, device) -> dict:
    dt = _dtype(cfg)
    p = {
        "norm1": init_norm(cfg.d_model, cfg.norm_type, dt, device),
        "attn": attn_lib.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            num_layers=cfg.num_layers, dtype=dt, device=device,
        ),
        "norm2": init_norm(cfg.d_model, cfg.norm_type, dt, device),
    }
    if moe_here:
        p["moe"] = moe_lib.init_moe(gen, cfg.d_model, cfg.expert_d_ff, cfg.num_experts,
                                    cfg.num_layers, dt, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.num_layers, dt, device)
    return p


def _apply_ffn(p: dict, h, cfg: ModelConfig):
    """(the block's MLP or MoE output, its aux loss or None)."""
    if "moe" in p:
        return moe_lib.apply_moe(p["moe"], h, top_k=cfg.top_k, act=cfg.act)
    return apply_mlp(p["mlp"], h, cfg.act), None


def apply_block(p: dict, x, kind: str, cfg: ModelConfig, positions):
    """Full-sequence block.  Returns (x, aux_loss or None)."""
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    x = x + attn_lib.apply_attention(p["attn"], h, positions=positions,
                                     **_mixer_kwargs(cfg, kind))
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    y, aux = _apply_ffn(p, h, cfg)
    return x + y, aux


def apply_block_decode(p, x, kind: str, cfg: ModelConfig, positions, index: int, cache):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    mix, cache = attn_lib.apply_attention_decode(
        p["attn"], h, cache, index, positions=positions, **_mixer_kwargs(cfg, kind))
    x = x + mix
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    y, _ = _apply_ffn(p, h, cfg)
    return x + y, cache


# ---------------------------------------------------------------------------
# Param tree helpers
# ---------------------------------------------------------------------------


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unembed_table(params, cfg: ModelConfig):
    return params["embed"]["table"].T if cfg.tie_embeddings else params["unembed"]["table"]


# ---------------------------------------------------------------------------
# LM init / forward
# ---------------------------------------------------------------------------


def _init_groups(gen, cfg: ModelConfig, device) -> dict:
    """The stacked layer groups, drawn group by group in the generator's
    order and written into their slot of leaves allocated once, shaped
    (num_groups, ...): the peak is the model plus one group's tree, not two
    copies of the stack (65-70 GB each for the 32 B models)."""
    stacked = None
    for g in range(cfg.num_groups):
        tree = {f"b{i}": init_block(gen, cfg, _is_moe_pos(cfg, i), device)
                for i in range(len(cfg.block_pattern))}
        if stacked is None:
            stacked = tree_map(lambda x: x.new_empty((cfg.num_groups, *x.shape)), tree)
        for (_, dst), (_, src) in zip(flatten_with_paths(stacked), flatten_with_paths(tree)):
            dst[g].copy_(src)
        del tree
    return stacked


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    check_ported(cfg)
    dt = _dtype(cfg)
    params: Dict[str, Any] = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dt, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": init_embed(gen, cfg.d_model, cfg.vocab_size, dt, device)["table"]}
    params["groups"] = _init_groups(gen, cfg, device)
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm_type, dt, device)
    return params


def embed_inputs(params, cfg: ModelConfig, batch: dict):
    """(b, s, d) activations: ``batch["embeds"]`` in the model's type, else
    the embedding of ``batch["tokens"]``."""
    if "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = apply_embed(params["embed"], batch["tokens"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def lm_forward(params: dict, batch: dict, cfg: ModelConfig, *,
               remat_policy: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, vocab), aux_loss).  ``batch`` holds 'tokens'
    (b, s) or 'embeds' (b, s, d), and optionally 'positions' (b, s) or
    (b, s, 3); the attention mask runs on sequence indices whatever the
    positions."""
    check_ported(cfg)
    x = embed_inputs(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)

    def group_fn(x, aux, gp):
        for i, kind in enumerate(cfg.block_pattern):
            x, a = apply_block(gp[f"b{i}"], x, kind, cfg, positions)
            if a is not None:
                aux = aux + a
        return x, aux

    body = _remat(group_fn, remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.num_groups):
        x, aux = body(x, aux, _index(params["groups"], g))
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = softcap(apply_unembed(_unembed_table(params, cfg), x), cfg.logit_softcap)
    return logits, aux


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, *, remat_policy: str = "full"):
    """(loss, {"ce", "aux"}) for batch = {'tokens', 'labels'}: the cross
    entropy plus ``router_aux_coef`` times the MoE layers' summed aux loss
    (0 without MoE)."""
    logits, aux = lm_forward(params, batch, cfg, remat_policy=remat_policy)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + cfg.router_aux_coef * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Cache / decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{'b<i>': {'k': (shape, dtype), 'v': ...}} with the leading group dim.
    A sliding-window block keeps min(max_len, sliding_window) slots (a ring
    buffer, ``attention.apply_attention_decode``), any other max_len."""
    check_ported(cfg)
    specs = {}
    for i, kind in enumerate(cfg.block_pattern):
        cache_len = max_len
        if kind == "attn_local" and cfg.sliding_window:
            cache_len = min(max_len, cfg.sliding_window)
        shape = (cfg.num_groups, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        specs[f"b{i}"] = {"k": (shape, _dtype(cfg)), "v": (shape, _dtype(cfg))}
    return specs


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    return {blk: {name: torch.zeros(shape, dtype=dt, device=device)
                  for name, (shape, dt) in spec.items()}
            for blk, spec in cache_specs(cfg, batch, max_len).items()}


def lm_decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig):
    """One-token decode; batch = {'token': (b,) | 'embeds': (b, 1, d),
    'index': int, optionally 'positions': (b, 1) or (b, 1, 3)}.  The
    positions feed the rope (default: ``index``); the cache slot and the
    mask use ``index``.  Returns (logits (b, vocab), cache); the cache is
    updated in place."""
    check_ported(cfg)
    index = int(batch["index"])
    if "embeds" in batch:
        x = embed_inputs(params, cfg, {"embeds": batch["embeds"]})
    else:
        x = embed_inputs(params, cfg, {"tokens": batch["token"][:, None]})
    b = x.shape[0]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.full((b, 1), index, device=x.device)
    for g in range(cfg.num_groups):
        gp = _index(params["groups"], g)
        for i, kind in enumerate(cfg.block_pattern):
            blk = f"b{i}"
            gc = {name: c[g] for name, c in cache[blk].items()}  # views into the stack
            x, _ = apply_block_decode(gp[blk], x, kind, cfg, positions, index, gc)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = softcap(apply_unembed(_unembed_table(params, cfg), x), cfg.logit_softcap)
    return logits[:, 0], cache
