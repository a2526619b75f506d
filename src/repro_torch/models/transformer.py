"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

The blocks are ``attn`` (causal), ``attn_local`` (sliding window) and
``mamba`` (``models/mamba.py``), each followed by a dense MLP or, at the
positions ``cfg.moe`` and ``cfg.moe_pattern`` pick, an MoE MLP whose aux
losses the forward sums; and the self-contained ``mlstm`` and ``slstm``
blocks (``models/xlstm.py``: a norm and the mixer, no MLP after it).
Inputs are token ids or precomputed embeddings (``batch["embeds"]``,
qwen2-vl's stubbed vision frontend), positions (b, s) or, for M-RoPE,
(b, s, 3) t / h / w streams, and learned absolute positions where the
config has them.  The layer stack is ``num_groups`` repetitions of
``cfg.block_pattern`` with group params stacked on a leading dim, as in
the JAX package, so the param tree and its checkpoint paths match; the JAX
``lax.scan`` over groups is a Python loop, and gradients reach the stacked
leaves through the per-group indexing.  Rematerialization
(``remat_policy``) wraps each group as ``_remat`` does in the JAX package.
The encoder-decoder (whisper) is ``models/encdec.py``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import flatten_with_paths, tree_map
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (
    TensorSpec,
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
from repro_torch.parallel.shards import take_rows
from repro_torch.parallel.sharding import shd


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


def init_block(gen, cfg: ModelConfig, kind: str, moe_here: bool, device) -> dict:
    dt = _dtype(cfg)
    p = {"norm1": init_norm(cfg.d_model, cfg.norm_type, dt, device)}
    if kind.startswith("attn"):
        p["attn"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
            num_layers=cfg.num_layers, dtype=dt, device=device,
        )
    elif kind == "mamba":
        p["mamba"] = mamba_lib.init_mamba(
            gen, cfg.d_model, expand=cfg.mamba_expand, d_state=cfg.mamba_d_state,
            d_conv=cfg.mamba_d_conv, num_layers=cfg.num_layers, dtype=dt, device=device)
    elif kind == "mlstm":
        p["mlstm"] = xlstm_lib.init_mlstm(gen, cfg.d_model, cfg.num_heads, cfg.num_layers,
                                          dt, device)
        return p  # self-contained block
    elif kind == "slstm":
        p["slstm"] = xlstm_lib.init_slstm(gen, cfg.d_model, cfg.num_heads, cfg.num_layers,
                                          dt, device)
        return p
    else:
        raise ValueError(kind)
    p["norm2"] = init_norm(cfg.d_model, cfg.norm_type, dt, device)
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
    if kind.startswith("attn"):
        mix = attn_lib.apply_attention(p["attn"], h, positions=positions,
                                       **_mixer_kwargs(cfg, kind))
    elif kind == "mamba":
        mix = mamba_lib.apply_mamba(p["mamba"], h, d_state=cfg.mamba_d_state)
    elif kind == "mlstm":
        return x + xlstm_lib.apply_mlstm(p["mlstm"], h, cfg.num_heads), None
    elif kind == "slstm":
        return x + xlstm_lib.apply_slstm(p["slstm"], h, cfg.num_heads), None
    else:
        raise ValueError(kind)
    x = x + mix
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    y, aux = _apply_ffn(p, h, cfg)
    return shd(x + y, "batch", "seq", "embed_act"), aux


def apply_block_decode(p, x, kind: str, cfg: ModelConfig, positions, index: int, cache,
                       long_context: bool = False):
    """One-token block step.  ``cache`` is the block's slice of the decode
    cache, updated in place: an attention layer writes its new key and
    value, a recurrent layer (Mamba, mLSTM, sLSTM) overwrites its state."""
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    if kind.startswith("attn"):
        mix, _ = attn_lib.apply_attention_decode(
            p["attn"], h, cache, index, positions=positions, long_context=long_context,
            **_mixer_kwargs(cfg, kind))
        state = None
    elif kind == "mamba":
        mix, state = mamba_lib.apply_mamba_decode(p["mamba"], h, cache, d_state=cfg.mamba_d_state)
    elif kind == "mlstm":
        mix, state = xlstm_lib.apply_mlstm(p["mlstm"], h, cfg.num_heads, state=cache, decode=True)
    elif kind == "slstm":
        mix, state = xlstm_lib.apply_slstm(p["slstm"], h, cfg.num_heads, state=cache, decode=True)
    else:
        raise ValueError(kind)
    if state is not None:
        for name, t in state.items():
            cache[name].copy_(t)
    x = x + mix
    if "norm2" not in p:  # mLSTM / sLSTM: self-contained
        return x
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    y, _ = _apply_ffn(p, h, cfg)
    return x + y


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


def init_stacked(n: int, parts) -> dict:
    """{key: stacked tree} of ``parts``, a list of (key, draw): for each of
    ``n`` slots, every part's tree is drawn by ``draw()`` in turn (slot 0's
    parts, then slot 1's: the generator's order) and written into its slot
    of leaves allocated once, shaped (n, ...).  The peak is the stack plus
    one part's tree, not two copies of the stack (65-70 GB each for the
    32 B models) nor the stack and a whole slot (jamba's groups are 26 GB
    each)."""
    stacked = {}
    for g in range(n):
        for key, draw in parts:
            tree = draw()
            if key not in stacked:
                stacked[key] = tree_map(lambda x: x.new_empty((n, *x.shape)), tree)
            for (_, dst), (_, src) in zip(flatten_with_paths(stacked[key]),
                                          flatten_with_paths(tree)):
                dst[g].copy_(src)
            del tree
    return stacked


def _init_groups(gen, cfg: ModelConfig, device) -> dict:
    """The stacked layer groups, block by block (init_stacked)."""
    return init_stacked(cfg.num_groups, [
        (f"b{i}", functools.partial(init_block, gen, cfg, kind, _is_moe_pos(cfg, i), device))
        for i, kind in enumerate(cfg.block_pattern)])


def init_lm(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = _dtype(cfg)
    params: Dict[str, Any] = {"embed": init_embed(gen, cfg.vocab_size, cfg.d_model, dt, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": init_embed(gen, cfg.d_model, cfg.vocab_size, dt, device)["table"]}
    if cfg.learned_pos:
        params["pos_embed"] = init_pos_embed(gen, cfg, device)
    params["groups"] = _init_groups(gen, cfg, device)
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm_type, dt, device)
    return params


# rows of a learned absolute-position table (the JAX package's size)
POS_TABLE_ROWS = 32768


def init_pos_embed(gen, cfg: ModelConfig, device) -> dict:
    return {"table": init_embed(gen, POS_TABLE_ROWS, cfg.d_model, _dtype(cfg), device)["table"]}


def embed_inputs(params, cfg: ModelConfig, batch: dict):
    """(b, s, d) activations: ``batch["embeds"]`` in the model's type, else
    the embedding of ``batch["tokens"]``; with learned positions, plus the
    table's rows at ``batch["positions"]`` (the t stream of (b, s, 3)
    ones), by default at 0 .. s-1."""
    if "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = apply_embed(params["embed"], batch["tokens"])
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    if cfg.learned_pos:
        pos = batch.get("positions")
        if pos is None:
            pos = torch.arange(x.shape[1], device=x.device)[None]
        if pos.dim() == 3:
            pos = pos[..., 0]
        pe = take_rows(params["pos_embed"]["table"], pos.long())
        x = x + pe.expand(x.shape).to(x.dtype)
    return shd(x, "batch", "seq", "embed_act")


def lm_forward(params: dict, batch: dict, cfg: ModelConfig, *,
               remat_policy: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, vocab), aux_loss).  ``batch`` holds 'tokens'
    (b, s) or 'embeds' (b, s, d), and optionally 'positions' (b, s) or
    (b, s, 3); the attention mask runs on sequence indices whatever the
    positions."""
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


def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int) -> dict:
    """{name: (shape, dtype)} of one block's decode cache.  An attention
    block keeps keys and values: a sliding-window block min(max_len,
    sliding_window) slots (a ring buffer, ``attention.apply_attention_decode``),
    any other max_len.  A recurrent block keeps its state."""
    dt = _dtype(cfg)
    if kind.startswith("attn"):
        cache_len = max_len
        if kind == "attn_local" and cfg.sliding_window:
            cache_len = min(max_len, cfg.sliding_window)
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": (shape, dt), "v": (shape, dt)}
    if kind == "mamba":
        return mamba_lib.mamba_state_spec(batch, cfg.d_model, expand=cfg.mamba_expand,
                                          d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
                                          dtype=dt)
    if kind == "mlstm":
        return xlstm_lib.mlstm_state_spec(batch, cfg.d_model, cfg.num_heads)
    if kind == "slstm":
        return xlstm_lib.slstm_state_spec(batch, cfg.d_model)
    raise ValueError(kind)


def _block_cache_pspec(kind: str, long: bool) -> dict:
    """Logical pspecs of one block's cache leaves (the reference's): keys
    and values (batch on 'dp_batch', sequence on 'kv_seq'; long-context:
    no batch axis, sequence on 'kv_long'), recurrent states likewise."""
    if kind.startswith("attn"):
        ps = (None if long else "dp_batch", "kv_long" if long else "kv_seq", None, None)
        return {"k": ps, "v": ps}
    if kind == "mamba":
        return mamba_lib.mamba_state_pspecs(long)
    if kind == "mlstm":
        return xlstm_lib.mlstm_state_pspecs(long)
    if kind == "slstm":
        return xlstm_lib.slstm_state_pspecs(long)
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, long_context: bool = False):
    """(specs, logical pspecs) of the decode cache: {'b<i>': {name:
    TensorSpec}} with the leading group dim, and the same tree of logical
    axis names ('layers' first)."""
    specs, pspecs = {}, {}
    for i, kind in enumerate(cfg.block_pattern):
        specs[f"b{i}"] = {name: TensorSpec((cfg.num_groups, *shape), dt) for name, (shape, dt)
                          in _block_cache_spec(cfg, kind, batch, max_len).items()}
        pspecs[f"b{i}"] = {name: ("layers", *ps)
                           for name, ps in _block_cache_pspec(kind, long_context).items()}
    return specs, pspecs


def zeros_like_specs(specs: dict, device) -> dict:
    """Zero tensors of a spec tree ({name: (shape, dtype)} leaves)."""
    if isinstance(specs, dict):
        return {k: zeros_like_specs(v, device) for k, v in specs.items()}
    shape, dt = specs
    return torch.zeros(shape, dtype=dt, device=device)


def lm_decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig, *,
                   long_context: bool = False):
    """One-token decode; batch = {'token': (b,) | 'embeds': (b, 1, d),
    'index': int, optionally 'positions': (b, 1) or (b, 1, 3)}.  The
    positions feed the rope (default: ``index``); the cache slot and the
    mask use ``index``.  Returns (logits (b, vocab), cache); the cache is
    updated in place.  ``long_context`` changes only the sharding of a
    DTensor cache (its pspecs), as in the reference."""
    index = int(batch["index"])
    b = (batch["embeds"] if "embeds" in batch else batch["token"]).shape[0]
    dev = params["embed"]["table"].device
    positions = batch.get("positions")
    if positions is None:
        positions = torch.full((b, 1), index, device=dev)
    if "embeds" in batch:
        pos = {"positions": batch["positions"]} if "positions" in batch else {}
        x = embed_inputs(params, cfg, {"embeds": batch["embeds"], **pos})
    else:
        # learned positions default to the token's index, as in the JAX package
        pos = {"positions": positions} if "positions" in batch or cfg.learned_pos else {}
        x = embed_inputs(params, cfg, {"tokens": batch["token"][:, None], **pos})
    for g in range(cfg.num_groups):
        gp = _index(params["groups"], g)
        for i, kind in enumerate(cfg.block_pattern):
            blk = f"b{i}"
            gc = {name: c[g] for name, c in cache[blk].items()}  # views into the stack
            x = apply_block_decode(gp[blk], x, kind, cfg, positions, index, gc, long_context)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = softcap(apply_unembed(_unembed_table(params, cfg), x), cfg.logit_softcap)
    return logits[:, 0], cache
