"""Shared primitive layers (plain functions; params are nested dicts).

Port of ``repro/models/layers.py``.  Init draws from an explicit
``torch.Generator`` on the generator's device and then moves to ``device``:
a CPU generator (the default) gives the same weights on every device, a
generator on the card draws a full-width model there in a fraction of the
time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_TRUNC = 2.0  # the JAX package's truncation, in standard deviations
_CDF_LO = 0.5 * (1.0 + math.erf(-_TRUNC / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(_TRUNC / math.sqrt(2.0)))


def truncated_normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``std`` (the JAX package's init),
    drawn on ``gen``'s device by the inverse CDF: one uniform draw per value
    (what ``torch.nn.init.trunc_normal_`` did up to torch 2.11; later
    versions resample, several times slower on the CPU)."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    x.uniform_(2.0 * _CDF_LO - 1.0, 2.0 * _CDF_HI - 1.0, generator=gen)
    x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC)
    return (x * std).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(d: int, norm_type: str, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, norm_type: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rms_norm_1d(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim with an explicit scale vector (qk-norm)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu defaults to the tanh form


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh soft-capping (gemma2)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, d_ff: int, num_layers: int, dtype, device) -> dict:
    out_std = 0.02 / max(1.0, (2.0 * num_layers) ** 0.5)
    return {
        "wi": truncated_normal(gen, (d, d_ff), 0.02, dtype, device),
        "wg": truncated_normal(gen, (d, d_ff), 0.02, dtype, device),
        "wo": truncated_normal(gen, (d_ff, d), out_std, dtype, device),
    }


def apply_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = activation(act)(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embed(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": truncated_normal(gen, (vocab, d), 0.02, dtype, device)}


def apply_embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def apply_unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) @ table.T -> logits.  ``table`` is (vocab, d) when tied
    (embed table) or (d, vocab) for a dedicated unembed matrix."""
    if table.shape[0] == x.shape[-1]:
        return x @ table
    return x @ table.T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy in f32. labels < 0 are masked."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
