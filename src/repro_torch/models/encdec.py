"""Whisper-style encoder-decoder transformer (port of
``repro/models/encdec.py``).

The audio conv frontend is a stub, as in the JAX package: the encoder
takes precomputed (batch, encoder_seq, d_model) frame embeddings
(``batch["frames"]``, sinusoidal positions folded in upstream).  The
encoder's self-attention sees every frame (``mask_kind="full"``, through
``kernels.ops.flash_attention``: K1 on the card).  The decoder is a causal
transformer with learned absolute positions and cross-attention over the
encoder's output (the plain ``attention.attend_ref``), its embedding table
tied to the logits.  Layer params are stacked on a leading dim
(``enc_groups``, ``dec_groups``) as in the JAX package, so the trees and
their checkpoint paths match.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    apply_embed, apply_mlp, apply_norm, apply_unembed, cross_entropy, init_embed, init_mlp,
    init_norm,
)
from repro_torch.models.transformer import (
    _dtype, _index, _remat, init_pos_embed, init_stacked, zeros_like_specs,
)

_NO_ROPE = dict(rope_type="none", rope_theta=0.0)


def _init_attn(gen, cfg: ModelConfig, device):
    return attn_lib.init_attention(
        gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=False, num_layers=cfg.num_layers, dtype=_dtype(cfg),
        device=device)


def init_encdec(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model

    def norm():
        return init_norm(d, cfg.norm_type, dt, device)

    def enc_block():
        return {"norm1": norm(), "attn": _init_attn(gen, cfg, device), "norm2": norm(),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.num_layers, dt, device)}

    def dec_block():
        return {"norm1": norm(), "attn": _init_attn(gen, cfg, device), "norm2": norm(),
                "cross_attn": _init_attn(gen, cfg, device), "norm3": norm(),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.num_layers, dt, device)}

    params: Dict[str, Any] = {
        "embed": init_embed(gen, cfg.vocab_size, d, dt, device),
        "pos_embed": init_pos_embed(gen, cfg, device),
    }
    params["enc_groups"] = init_stacked(cfg.encoder_layers, [("enc", enc_block)])["enc"]
    params["enc_norm"] = norm()
    params["dec_groups"] = init_stacked(cfg.num_layers, [("dec", dec_block)])["dec"]
    params["final_norm"] = norm()
    return params


def encode(params, frames: torch.Tensor, cfg: ModelConfig, remat_policy: str = "full"):
    """(b, t, d) encoder output of (b, t, d) frame embeddings."""
    x = frames.to(_dtype(cfg))
    b, t = x.shape[0], x.shape[1]
    positions = torch.arange(t, device=x.device).expand(b, t)

    def block(x, p):
        h = apply_norm(p["norm1"], x, cfg.norm_type)
        x = x + attn_lib.apply_attention(p["attn"], h, positions=positions, mask_kind="full",
                                         **_NO_ROPE)
        h = apply_norm(p["norm2"], x, cfg.norm_type)
        return x + apply_mlp(p["mlp"], h, cfg.act)

    body = _remat(block, remat_policy)
    for i in range(cfg.encoder_layers):
        x = body(x, _index(params["enc_groups"], i))
    return apply_norm(params["enc_norm"], x, cfg.norm_type)


def _logits(params, x, cfg: ModelConfig):
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return apply_unembed(params["embed"]["table"].T, x)  # tied


def decode_train(params, enc_out, tokens, cfg: ModelConfig, remat_policy: str = "full"):
    """(b, s, vocab) logits of the decoder over ``tokens`` (b, s), all at
    once (teacher forcing)."""
    x = apply_embed(params["embed"], tokens)
    b, s = x.shape[0], x.shape[1]
    x = x + params["pos_embed"]["table"][:s][None].to(x.dtype)
    positions = torch.arange(s, device=x.device).expand(b, s)

    def block(x, p):
        h = apply_norm(p["norm1"], x, cfg.norm_type)
        x = x + attn_lib.apply_attention(p["attn"], h, positions=positions, mask_kind="causal",
                                         **_NO_ROPE)
        h = apply_norm(p["norm2"], x, cfg.norm_type)
        x = x + attn_lib.apply_cross_attention(p["cross_attn"], h, enc_out)
        h = apply_norm(p["norm3"], x, cfg.norm_type)
        return x + apply_mlp(p["mlp"], h, cfg.act)

    body = _remat(block, remat_policy)
    for i in range(cfg.num_layers):
        x = body(x, _index(params["dec_groups"], i))
    return _logits(params, x, cfg)


def encdec_forward(params, batch, cfg: ModelConfig, remat_policy: str = "full"):
    """(logits, aux = 0) for batch = {'frames': (b, t, d), 'tokens': (b, s)}."""
    if "frames" not in batch:
        # The JAX package fails here with a KeyError from inside its traced
        # step: a token stream alone (SyntheticLMDataset) cannot feed it.
        raise ValueError(f"{cfg.name} is an encoder-decoder: its batch needs 'frames' "
                         f"(b, {cfg.encoder_seq}, {cfg.d_model}) beside 'tokens'; got "
                         f"{sorted(batch)}")
    enc_out = encode(params, batch["frames"], cfg, remat_policy)
    logits = decode_train(params, enc_out, batch["tokens"], cfg, remat_policy)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def encdec_loss(params, batch, cfg: ModelConfig, *, remat_policy: str = "full"):
    logits, aux = encdec_forward(params, batch, cfg, remat_policy)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def encdec_cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """{'self': {'k', 'v'}: (L, b, max_len, nkv, hd), 'cross': {'k', 'v'}:
    (L, b, encoder_seq, nkv, hd)}, as (shape, dtype)."""
    dt = _dtype(cfg)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    self_shape = (cfg.num_layers, batch, max_len, *tail)
    cross_shape = (cfg.num_layers, batch, cfg.encoder_seq, *tail)
    return {"self": {"k": (self_shape, dt), "v": (self_shape, dt)},
            "cross": {"k": (cross_shape, dt), "v": (cross_shape, dt)}}


def encdec_init_cache(params, frames, cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Run the encoder over ``frames`` and precompute each decoder layer's
    cross K / V (the "prefill"); the self-attention cache starts at 0."""
    enc_out = encode(params, frames, cfg)
    kv = [attn_lib.cross_kv(_index(params["dec_groups"], i)["cross_attn"], enc_out)
          for i in range(cfg.num_layers)]
    cache = zeros_like_specs({"self": encdec_cache_specs(cfg, batch, max_len)["self"]},
                             enc_out.device)
    cache["cross"] = {"k": torch.stack([k for k, _ in kv]), "v": torch.stack([v for _, v in kv])}
    return cache


def encdec_decode_step(params, cache, batch, cfg: ModelConfig):
    """One decoder token: batch = {'token': (b,), 'index': int}.  Returns
    (logits (b, vocab), cache); the self-attention cache is updated in
    place."""
    index = int(batch["index"])
    x = apply_embed(params["embed"], batch["token"][:, None])
    x = x + params["pos_embed"]["table"][index].expand(x.shape).to(x.dtype)
    positions = torch.full((x.shape[0], 1), index, device=x.device)
    for i in range(cfg.num_layers):
        p = _index(params["dec_groups"], i)
        self_c = {name: c[i] for name, c in cache["self"].items()}  # views into the stack
        h = apply_norm(p["norm1"], x, cfg.norm_type)
        y, _ = attn_lib.apply_attention_decode(p["attn"], h, self_c, index,
                                               positions=positions, **_NO_ROPE)
        x = x + y
        h = apply_norm(p["norm2"], x, cfg.norm_type)
        x = x + attn_lib.apply_cross_attention(
            p["cross_attn"], h, (cache["cross"]["k"][i], cache["cross"]["v"][i]))
        h = apply_norm(p["norm3"], x, cfg.norm_type)
        x = x + apply_mlp(p["mlp"], h, cfg.act)
    return _logits(params, x, cfg)[:, 0], cache
