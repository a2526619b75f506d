"""Mixture-of-Experts MLP with top-k routing and expert parallelism (port
of ``repro/models/moe.py``).

The JAX package's dense dispatch (``impl="dense"``, the default) computes
every token row through every expert, the rows of the experts a token is
not routed to being zero.  The port computes the same sum without those
rows (dropless): the b s k routed (token, expert) rows are sorted by expert
and gathered (``moe.dispatch``), each expert's MLP runs on its own rows in
one grouped GEMM (``kernels/ops.grouped_mlp``: K5 on the card, a loop of
``torch.matmul`` on the CPU; ``moe.experts``), and each token sums its k
output rows weighted by its float32 gates (``moe.combine``).  Nothing
reads a group's size on the host, and every step is deterministic: no
atomic adds, so a forward repeats itself bit for bit (the remat rerun
routes as the forward did).  ``apply_moe(impl=)`` or the
``REPRO_MOE_IMPL`` environment variable selects the block-local capacity
dispatch (``apply_moe_capacity``) instead, as in the reference.

On DTensors the experts stay where the param rules put them: with the
expert dim split over 'model' (EP), each rank runs its block of experts on
its batch shard, the sequence whole (``parallel/shards.on_channel_shards``
with the expert dim as the channel); with it whole (``moe-blocked``, or
an expert count the mesh does not divide), each rank runs every expert on
its batch and sequence shard.

Top-k selections are deterministic, as ``jax.lax.top_k``'s: the larger
value first, and of equal values the lower index first.  ``torch.topk``
leaves the order of ties open, which the capacity path's gates, many of
them exactly 0, would expose.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import ops
from repro_torch.models.layers import activation, truncated_normal
from repro_torch.parallel.compat import DTensor
from repro_torch.parallel.shards import (
    Whole, channel_dims, full_local, keep_only, on_channel_shards, replicated, shard_mean,
    wrap_like)
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
    """(gates (b,s,k) f32, experts (b,s,k) int64, probs (b,s,E) f32): each
    token's top-k experts, their probabilities renormalised to sum 1."""
    logits = (x.float() @ p["router"]).float()  # (b,s,E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = topk_stable(probs, top_k)  # (b,s,k)
    return top_vals / torch.sum(top_vals, dim=-1, keepdim=True), top_idx, probs


def _routed(experts: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(b,s,E) f32: 1 where a token is routed to an expert, else 0."""
    mask = experts.new_zeros((*experts.shape[:-1], num_experts), dtype=torch.float32)
    return mask.scatter_(-1, experts, 1.0)


def _aux(frac_tokens, frac_probs, num_experts: int):
    """Switch-style load-balance aux loss of the per-expert token and
    probability fractions."""
    return num_experts * torch.sum(frac_tokens * frac_probs)


def _dense_weights(gates, experts, num_experts: int):
    """(combine, dispatch), (b,s,E) f32: each token's gate at its experts, and 0/1."""
    onehot = F.one_hot(experts, num_experts).float()  # (b,s,k,E)
    return torch.einsum("bsk,bske->bse", gates, onehot), onehot.sum(dim=-2)


# the expert weights' expert dim: the channel of on_channel_shards (the
# router, unnamed, is gathered whole)
EXPERTS = {"wi": 0, "wg": 0, "wo": 0}


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int, act: str,
              impl: str = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss).  impl: 'dense' (the reference's
    mathematics, computed dropless on the routed rows) or 'capacity'
    (``apply_moe_capacity``); ``REPRO_MOE_IMPL`` overrides the default.

    On a DTensor whose expert weights are split along the expert dim (EP,
    the baseline rules), each rank routes its batch shard's tokens, the
    sequence gathered, over all experts (top-k needs every probability) and
    runs only its block of E/M experts (``_expert_block``): its part of y
    is reduce-scattered into the residual's placement, its part of the aux
    loss summed over the blocks.  Otherwise routing and the experts,
    gathered whole, run on each rank's batch and sequence shard."""
    impl = impl or os.environ.get("REPRO_MOE_IMPL", "dense")
    if impl == "capacity":
        return apply_moe_capacity(p, x, top_k=top_k, act=act)
    fn = functools.partial(_expert_block, top_k=top_k, act=act)
    if not isinstance(x, DTensor):
        y, _, aux = fn(x, p, Whole, None)
        return y, aux
    if channel_dims(x, p["wi"], 0):
        y, _, aux = on_channel_shards(fn, x, p, EXPERTS)
        return shd(y, "batch", "seq", None), replicated(aux, x.device_mesh)
    return _on_token_shards(functools.partial(_experts, act=act, top_k=top_k), p, x, top_k)


def _expert_block(x, p, ch, state, *, top_k: int, act: str):
    """The routed experts of one block (``ch``'s: ``p``'s expert weights
    hold that block, the router all experts): (this block's part of y,
    None, the aux loss).  The aux loss's sum over experts is taken per
    block and summed over the blocks, so that its gradient arrives once;
    its per-expert means are over the batch shards."""
    gates, experts, probs = spans.call("moe.route", _route, p, x, top_k)
    num_experts = probs.shape[-1]
    dispatch = _routed(experts, num_experts)
    first, n = 0, num_experts
    if ch.count > 1:
        n = num_experts // ch.count
        first = ch.index * n
        dispatch, probs = dispatch[..., first:first + n], probs[..., first:first + n]
    y = _experts(p, x, gates, experts, first, n, act=act, top_k=top_k)
    frac_tokens = ch.batch_mean(torch.mean(dispatch, dim=(0, 1))) / top_k
    frac_probs = ch.batch_mean(torch.mean(probs, dim=(0, 1)))
    return y, None, ch.total(_aux(frac_tokens, frac_probs, num_experts)).float()


def _on_token_shards(run, p: dict, x, top_k: int):
    """``run(p, x, gates, experts)`` (the experts) on each rank's batch and
    sequence shard of ``x``, routed there, the params gathered whole: (y
    placed as the residual, the aux loss, its per-expert fractions' means
    taken over all shards, replicated)."""
    xs = keep_only(x, (0, 1))
    xl = xs.to_local()
    pl = full_local(p, xs)
    gates, experts, probs = spans.call("moe.route", _route, pl, xl, top_k)
    y = run(pl, xl, gates, experts)
    frac_tokens = shard_mean(torch.mean(_routed(experts, probs.shape[-1]), dim=(0, 1)),
                             xs, (0, 1)) / top_k
    frac_probs = shard_mean(torch.mean(probs, dim=(0, 1)), xs, (0, 1))
    aux = replicated(_aux(frac_tokens, frac_probs, probs.shape[-1]).float(), xs.device_mesh)
    return shd(wrap_like(y, xs), "batch", "seq", None), aux


def _experts(p: dict, x, gates, experts, first: int = 0, count: int = None, *, act: str,
             top_k: int):
    """The routed rows of experts ``first .. first + count`` (all by
    default; ``p``'s expert weights hold them), in the spans
    ``moe.dispatch`` (sort and gather), ``moe.experts`` (the grouped
    GEMM) and ``moe.combine``.  The buffers hold all b s k routed rows;
    on a block of experts the other experts' rows stay 0.  Counts the rows
    the expert GEMMs compute and the rows routed to these experts: on a
    block, its expected share of the routed rows."""
    b, s, _ = x.shape
    num_experts = p["router"].shape[-1]
    count = num_experts if count is None else count
    rows = b * s * top_k * count // num_experts
    spans.count("moe.rows_computed", rows)
    spans.count("moe.rows_routed", rows)
    xs, inv, offsets = spans.call("moe.dispatch", _dispatch, x, experts, num_experts)
    out = spans.call("moe.experts", ops.grouped_mlp, xs, p["wg"], p["wi"], p["wo"],
                     offsets[first:first + count + 1], act=act, num_experts=num_experts)
    return spans.call("moe.combine", _combine, out, gates, inv)


def _dispatch(x, experts, num_experts: int):
    """The routed rows in expert order, tokens in order within an expert:
    (rows (b s k, d), the inverse of the sort's permutation of the (token,
    slot) pairs: inv[t k + j] is the row of token t's j-th expert, each
    expert's first row and the end (E + 1,) int64).  The sort is stable;
    the offsets are found on the device."""
    b, s, d = x.shape
    k = experts.shape[-1]
    ids, order = torch.sort(experts.reshape(-1), stable=True)
    offsets = torch.searchsorted(ids, torch.arange(num_experts + 1, device=ids.device))
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                  device=order.device))
    return _GatherRows.apply(x.reshape(b * s, d), order // k, inv, k), inv, offsets


class _GatherRows(torch.autograd.Function):
    """rows[i] = x[token[i]]; the gradient of a token's row is the sum of
    its k rows' in slot order (``ops.moe_rows_sum``), in float32, rounded
    once: no scatter-add."""

    @staticmethod
    def forward(ctx, x, token, inv, k: int):
        ctx.save_for_backward(inv)
        ctx.k = k
        return x.index_select(0, token)

    @staticmethod
    def backward(ctx, drows):
        (inv,) = ctx.saved_tensors
        return ops.moe_rows_sum(drows.contiguous(), inv, None, ctx.k), None, None, None


def _combine(out, gates, inv):
    """y (b, s, d): each token's k output rows, weighted by its float32
    gates and summed in slot order, rounded once to the rows' type."""
    b, s, k = gates.shape
    y = _CombineRows.apply(out, gates.reshape(b * s, k).contiguous(), inv)
    return y.reshape(b, s, -1)


class _CombineRows(torch.autograd.Function):
    """y[t] = sum_j gates[t, j] out[inv[t k + j]] (``ops.moe_rows_sum``).
    Backward (``ops.moe_combine_bwd``): a row's cotangent is its gate times
    its token's (each row has one token: no scatter-add), a gate's the dot
    of its row with its token's cotangent."""

    @staticmethod
    def forward(ctx, out, gates, inv):
        ctx.save_for_backward(out, gates, inv)
        return ops.moe_rows_sum(out, inv, gates, gates.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        out, gates, inv = ctx.saved_tensors
        dout, dgates = ops.moe_combine_bwd(out, dy.contiguous(), inv, gates)
        return dout, dgates, None


def apply_moe_capacity(
    p: dict, x: torch.Tensor, *, top_k: int, act: str,
    capacity_factor: float = 1.5, block: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-local capacity dispatch: tokens are grouped into seq-blocks of
    ``block``, and each expert takes its top-C tokens by gate within each
    block (C = block·top_k/E·cf); overflow tokens are dropped per expert
    (Switch-style), as are zero-gate picks.

    On a DTensor it runs on each rank's batch and sequence shard with the
    experts whole (what the ``moe-blocked`` rules place): the blocks are
    those of the whole sequence only if they lie inside the shards, so a
    rank's sequence that is not a multiple of the block raises a
    ValueError."""
    bs = min(block, x.shape[1])
    run = functools.partial(_capacity, act=act, block=bs, top_k=top_k,
                            capacity_factor=capacity_factor)
    if isinstance(x, DTensor):
        return _on_token_shards(run, p, x, top_k)
    gates, experts, probs = spans.call("moe.route", _route, p, x, top_k)
    frac_tokens = torch.mean(_routed(experts, probs.shape[-1]), dim=(0, 1)) / top_k  # (E,)
    frac_probs = torch.mean(probs, dim=(0, 1))  # (E,)
    return run(p, x, gates, experts), _aux(frac_tokens, frac_probs, probs.shape[-1]).float()


def _capacity(p: dict, x, gates, experts, *, act: str, block: int, top_k: int,
              capacity_factor: float):
    b, s, _ = x.shape
    E = p["router"].shape[-1]
    combine, dispatch = _dense_weights(gates, experts, E)
    if s % block:
        raise ValueError(f"sequence {s} is not a multiple of the block {block} (on a mesh, a "
                         f"rank's shard of the sequence, whose blocks must be the whole one's)")
    nb = s // block
    cap = int(max(1, min(block, round(block * top_k / E * capacity_factor))))
    spans.count("moe.rows_computed", b * nb * E * cap)
    spans.count("moe.rows_routed", b * s * top_k)
    xin, topv, topi, keep = spans.call("moe.dispatch", _gather, x, combine, dispatch, block, cap)
    out = spans.call("moe.experts", _capacity_mlp, xin, p["wg"], p["wi"], p["wo"], act)
    return spans.call("moe.combine", _scatter_add, out, topv, topi, keep, x.shape)


def _block_ids(b: int, nb: int, device):
    return (torch.arange(b, device=device)[:, None, None, None],
            torch.arange(nb, device=device)[None, :, None, None])


def _gather(x, combine, dispatch, block: int, cap: int):
    """Each expert's top-``cap`` tokens by gate within each block of the
    sequence: (rows (b, nb, E, C, d), gates, block-local ids, kept 0/1)."""
    b, s, d = x.shape
    nb, E = s // block, dispatch.shape[-1]
    gates = (combine * dispatch).reshape(b, nb, block, E)
    topv, topi = topk_stable(gates.transpose(2, 3), cap)  # (b, nb, E, C) block-local ids
    keep = (topv > 0.0).to(x.dtype)
    xb = shd(x.reshape(b, nb, block, d), "batch", "seq", None, None)
    bi, ni = _block_ids(b, nb, x.device)
    xin = xb[bi, ni, topi] * keep[..., None]  # gather within blocks: (b, nb, E, C, d)
    return shd(xin, "batch", "seq", "expert_act", None, None), topv, topi, keep


def _capacity_mlp(xin, wg, wi, wo, act: str):
    h = activation(act)(torch.einsum("bnecd,edf->bnecf", xin, wg))
    h = h * torch.einsum("bnecd,edf->bnecf", xin, wi)
    return torch.einsum("bnecf,efd->bnecd", h, wo)


def _scatter_add(out, topv, topi, keep, shape):
    """The experts' rows, weighted by their gates, added back inside each block."""
    b, s, d = shape
    nb, bs = topi.shape[1], s // topi.shape[1]
    out = out * (topv.to(out.dtype) * keep)[..., None]
    bi, ni = _block_ids(b, nb, out.device)
    y = torch.zeros((b, nb, bs, d), dtype=out.dtype, device=out.device)
    y = y.index_put((bi, ni, topi), out, accumulate=True)
    return shd(y.reshape(b, s, d), "batch", "seq", None)
