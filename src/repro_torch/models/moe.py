"""Mixture-of-Experts MLP with top-k routing (port of ``repro/models/moe.py``).

Dense-dispatch formulation (Switch/Mixtral-reference style): tokens are
combined into per-expert buffers with an einsum against the dispatch mask.
The JAX package computes MoE outside any Pallas kernel, so this is plain
PyTorch on every device.  ``apply_moe_capacity``, the block-local capacity
dispatch, is a function of its own that no model path selects yet (the
reference's ``REPRO_MOE_IMPL`` environment override is not copied).

Top-k selections are deterministic, as ``jax.lax.top_k``'s: the larger
value first, and of equal values the lower index first.  ``torch.topk``
leaves the order of ties open, which the capacity path's gates, many of
them exactly 0, would expose.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation, truncated_normal
from repro_torch.parallel.compat import DTensor
from repro_torch.parallel.shards import full_local, keep_only, replicated, shard_mean, wrap_like
from repro_torch.parallel.sharding import shd


def init_moe(gen, d: int, d_ff: int, num_experts: int, num_layers: int, dtype, device) -> dict:
    """The router in float32 whatever the model's dtype, the experts in it."""
    out_std = 0.02 / max(1.0, (2.0 * num_layers) ** 0.5)
    return {
        "router": truncated_normal(gen, (d, num_experts), 0.02, torch.float32, device),
        "wi": truncated_normal(gen, (num_experts, d, d_ff), 0.02, dtype, device),
        "wg": truncated_normal(gen, (num_experts, d, d_ff), 0.02, dtype, device),
        "wo": truncated_normal(gen, (num_experts, d_ff, d), out_std, dtype, device),
    }


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along the last dim,
    ties to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: dict, x: torch.Tensor, top_k: int):
    """(combine (b,s,E) f32, dispatch (b,s,E) f32 0/1, probs (b,s,E) f32)."""
    logits = (x.float() @ p["router"]).float()  # (b,s,E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = topk_stable(probs, top_k)  # (b,s,k)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    onehot = F.one_hot(top_idx, logits.shape[-1]).float()  # (b,s,k,E)
    dispatch = onehot.sum(dim=-2)
    combine = torch.einsum("bsk,bske->bse", top_vals, onehot)
    return combine, dispatch, probs


def _aux(frac_tokens, frac_probs, num_experts: int):
    """Switch-style load-balance aux loss of the per-expert token and
    probability fractions."""
    return num_experts * torch.sum(frac_tokens * frac_probs)


def router_probs(p: dict, x: torch.Tensor, top_k: int):
    """Returns (combine (b,s,E) f32, dispatch (b,s,E) f32 0/1, aux_loss scalar)."""
    combine, dispatch, probs = _route(p, x, top_k)
    frac_tokens = torch.mean(dispatch, dim=(0, 1)) / top_k  # (E,)
    frac_probs = torch.mean(probs, dim=(0, 1))  # (E,)
    return combine, dispatch, _aux(frac_tokens, frac_probs, probs.shape[-1])


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int, act: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss), by the reference's dense dispatch.

    On a DTensor, routing and the experts run on each rank's tokens (batch
    and sequence stay sharded, the expert weights are gathered): top-k
    runs along the expert dim, which no rank splits; the aux loss takes
    the per-expert fractions' means over all shards."""
    if isinstance(x, DTensor):
        xs = keep_only(x, (0, 1))
        xl = xs.to_local()
        pl = full_local(p, xs)
        combine, dispatch, probs = _route(pl, xl, top_k)
        y = _experts(pl, xl, combine, dispatch, act)
        frac_tokens = shard_mean(torch.mean(dispatch, dim=(0, 1)), xs, (0, 1)) / top_k
        frac_probs = shard_mean(torch.mean(probs, dim=(0, 1)), xs, (0, 1))
        aux = replicated(_aux(frac_tokens, frac_probs, probs.shape[-1]).float(), xs.device_mesh)
        return shd(wrap_like(y, xs), "batch", "seq", None), aux
    combine, dispatch, aux = router_probs(p, x, top_k)
    return _experts(p, x, combine, dispatch, act), aux.float()


def _experts(p: dict, x, combine, dispatch, act: str):
    # Dispatch: (E, b, s, d) buffers.
    expert_in = torch.einsum("bse,bsd->ebsd", dispatch.to(x.dtype), x)
    expert_in = shd(expert_in, "expert_act", "batch", None, None)
    h = activation(act)(torch.einsum("ebsd,edf->ebsf", expert_in, p["wg"]))
    h = h * torch.einsum("ebsd,edf->ebsf", expert_in, p["wi"])
    h = shd(h, "expert_act", "batch", None, None)
    expert_out = torch.einsum("ebsf,efd->ebsd", h, p["wo"])
    expert_out = shd(expert_out, "expert_act", "batch", None, None)
    y = torch.einsum("ebsd,bse->bsd", expert_out, combine.to(x.dtype))
    return shd(y, "batch", "seq", None)


def apply_moe_capacity(
    p: dict, x: torch.Tensor, *, top_k: int, act: str,
    capacity_factor: float = 1.5, block: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-local capacity dispatch: tokens are grouped into seq-blocks of
    ``block``, and each expert takes its top-C tokens by gate within each
    block (C = block·top_k/E·cf); overflow tokens are dropped per expert
    (Switch-style), as are zero-gate picks."""
    b, s, d = x.shape
    combine, dispatch, aux = router_probs(p, x, top_k)  # (b,s,E) f32
    E = dispatch.shape[-1]
    bs = min(block, s)
    if s % bs:
        raise ValueError(f"sequence {s} is not a multiple of the block {bs}")
    nb = s // bs
    cap = int(max(1, min(bs, round(bs * top_k / E * capacity_factor))))
    gates = (combine * dispatch).reshape(b, nb, bs, E)
    topv, topi = topk_stable(gates.transpose(2, 3), cap)  # (b, nb, E, C) block-local ids
    keep = (topv > 0.0).to(x.dtype)
    xb = shd(x.reshape(b, nb, bs, d), "batch", "seq", None, None)
    bi = torch.arange(b, device=x.device)[:, None, None, None]
    ni = torch.arange(nb, device=x.device)[None, :, None, None]
    xin = xb[bi, ni, topi] * keep[..., None]  # gather within blocks: (b, nb, E, C, d)
    xin = shd(xin, "batch", "seq", "expert_act", None, None)
    h = activation(act)(torch.einsum("bnecd,edf->bnecf", xin, p["wg"]))
    h = h * torch.einsum("bnecd,edf->bnecf", xin, p["wi"])
    out = torch.einsum("bnecf,efd->bnecd", h, p["wo"])
    out = out * (topv.to(x.dtype) * keep)[..., None]
    # scatter-add back inside each block
    y = torch.zeros((b, nb, bs, d), dtype=x.dtype, device=x.device)
    y = y.index_put((bi, ni, topi), out, accumulate=True)
    return shd(y.reshape(b, s, d), "batch", "seq", None), aux.float()

