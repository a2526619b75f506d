"""Plain PyTorch versions of every kernel in this package.

Each is the port of its ``repro/kernels/ref.py`` oracle.  The CPU runs
them in place of the CUDA kernels (``kernels/ops.py`` dispatches on the
input tensor's device); ``chip_smoke.py`` holds each CUDA kernel against
them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import ieee_f32
from repro_torch.models.layers import activation

NEG_INF = -2.0e38
LOG2E = 1.4426950408889634


def flash_attention_ref(
    q: torch.Tensor,  # (b, s, nh, hd)
    k: torch.Tensor,  # (b, t, nkv, hd)
    v: torch.Tensor,  # (b, t, nkv, hd)
    *,
    mask_kind: str = "causal",  # 'causal' | 'window' | 'full'
    window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Quadratic GQA attention, f32 softmax, dense left-aligned positions
    (qpos = arange(s), kpos = arange(t))."""
    b, s, nh, hd = q.shape
    scores = _scores(q, k, mask_kind, window, attn_softcap)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, s, nh, hd)


def _scores(q, k, mask_kind: str, window: int, attn_softcap: float) -> torch.Tensor:
    """Masked float32 scores (b, nkv, nh / nkv, s, t) of ``flash_attention_ref``."""
    if q.is_cuda:
        ieee_f32()
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, nkv, nh // nkv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * (hd ** -0.5)
    if attn_softcap:
        scores = attn_softcap * torch.tanh(scores / attn_softcap)
    if mask_kind != "full":
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(t, device=q.device)[None, :]
        ok = kpos <= qpos
        if mask_kind == "window" and window > 0:
            ok &= (qpos - kpos) < window
        scores = torch.where(ok, scores, torch.full((), NEG_INF, device=q.device))
    return scores


def flash_attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, *,
    mask_kind: str = "causal", window: int = 0, attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Each row's log-sum-exp of ``flash_attention_ref``'s scores, in base 2
    of the scores times log2 e (the units of K1's softmax): (b, nh, s)."""
    b, s, nh, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, mask_kind, window, attn_softcap), dim=-1)
    return (lse * LOG2E).reshape(b, nh, s)


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    mask_kind: str = "causal", window: int = 0, attn_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the autograd of ``flash_attention_ref`` at (q, k, v)
    for the output cotangent ``do`` -- what XLA computes for the JAX
    package, which differentiates its oracle."""
    with torch.enable_grad():
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = flash_attention_ref(qg, kg, vg, mask_kind=mask_kind, window=window,
                                  attn_softcap=attn_softcap)
        return torch.autograd.grad(out, (qg, kg, vg), do)


def grouped_mlp_ref(
    xs: torch.Tensor,  # (rows, d): the routed rows, sorted by expert
    wg: torch.Tensor,  # (groups, d, f)
    wi: torch.Tensor,  # (groups, d, f)
    wo: torch.Tensor,  # (groups, f, d)
    offsets: torch.Tensor,  # (groups + 1,) int64: group e's rows are offsets[e]:offsets[e + 1]
    *,
    act: str = "silu",
) -> torch.Tensor:
    """K5's plain version: each group's SwiGLU MLP on its own rows, a loop of
    ``torch.matmul``, (act(xs_e wg_e) * (xs_e wi_e)) wo_e; rows outside
    every group give 0.  It reads the group bounds on the host, so it takes
    CPU tensors (``kernels/ops.py``)."""
    bounds = offsets.tolist()
    parts = [xs.new_zeros((bounds[0], wo.shape[-1]))]
    for e in range(wg.shape[0]):
        seg = xs[bounds[e]:bounds[e + 1]]
        parts.append((activation(act)(seg @ wg[e]) * (seg @ wi[e])) @ wo[e])
    parts.append(xs.new_zeros((xs.shape[0] - bounds[-1], wo.shape[-1])))
    return torch.cat(parts)


def grouped_mlp_bwd_ref(
    dout: torch.Tensor, xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
    offsets: torch.Tensor, *, act: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dxs, dwg, dwi, dwo): the autograd of ``grouped_mlp_ref`` at its
    inputs for the output rows' cotangent ``dout``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xs, wg, wi, wo)]
        out = grouped_mlp_ref(*leaves, offsets, act=act)
        return torch.autograd.grad(out, leaves, dout)


def moe_rows_sum_ref(src: torch.Tensor, inv: torch.Tensor, w, k: int) -> torch.Tensor:
    """(tokens, d): y[t] = sum_j w[t, j] src[inv[t k + j]], summed in
    float32 over j in order and rounded once to src's type; ``w`` (tokens,
    k) float32 gates, or None for weights of 1."""
    rows = src.index_select(0, inv).view(inv.numel() // k, k, -1)
    if w is None:
        return rows.sum(dim=1, dtype=torch.float32).to(src.dtype)
    return torch.bmm(w.unsqueeze(1), rows.float()).squeeze(1).to(src.dtype)


def moe_combine_bwd_ref(src: torch.Tensor, dy: torch.Tensor, inv: torch.Tensor,
                        w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``moe_rows_sum_ref`` with gates, for y's cotangent
    ``dy``: (dsrc, dw), dsrc[inv[t k + j]] = w[t, j] dy[t] in src's type (inv
    a permutation of src's rows), dw[t, j] = <src[inv[t k + j]], dy[t]> in
    float32."""
    tokens, k = w.shape
    dy32 = dy.float()
    drows = torch.bmm(w.unsqueeze(2), dy32.unsqueeze(1)).to(src.dtype)
    dsrc = torch.empty_like(src).index_copy_(0, inv, drows.view(tokens * k, -1))
    rows = src.index_select(0, inv).view(tokens, k, -1)
    return dsrc, torch.bmm(rows.float(), dy32.unsqueeze(2)).squeeze(2)



def quantize_int8_ref(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of a flat f32/bf16 tensor.
    Returns (q int8 (n,), scales f32 (n // block,)).  n must divide by
    block (callers pad).  Division is true division and rounding is half
    to even, as ``jnp.round``."""
    n = x.shape[0]
    if n % block:
        raise ValueError(f"length {n} is not a multiple of block {block}")
    xb = x.float().reshape(n // block, block)
    amax = xb.abs().amax(dim=1)
    # Divide by a full tensor, not a Python scalar: PyTorch's CUDA division
    # by a scalar multiplies by its reciprocal, which is not IEEE division.
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    qv = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(torch.int8)
    return qv.reshape(n), scale


def dequantize_int8_ref(q: torch.Tensor, scale: torch.Tensor, block: int = 256) -> torch.Tensor:
    n = q.shape[0]
    return (q.reshape(n // block, block).float() * scale[:, None]).reshape(n)


def decide_dest_ref(
    jobs: torch.Tensor,   # (B, K, 6) float64: size, t_load, rem, cur_green, load_src, s_i
    sites: torch.Tensor,  # (B, S, 3) float64: W, bq_load, free_slots
    bw: torch.Tensor,     # (B, K, S) float64 bits/s
    *,
    alpha: float, gamma: float, betaqp: float, queue_penalty_s: float,
    min_benefit_s: float, ppf_sigma: float, use_stoch: bool,
    energy_ratio: float, t_downtime_s: float, class_c_s: float,
) -> torch.Tensor:
    """The fused Algorithm-1 decide: ``core/policy_kernels._score_numpy``
    op for op in float64, bit-identical to it.  Every product and sum is
    its own elementwise op (no contraction); division is tensor by
    tensor (IEEE on the card too), so bw 0 gives tt = inf.  Returns
    (B, K) int64 argbest destinations, -1 where none is valid."""
    size, t_load, rem, cur_green, load_src, s_i = (jobs[..., c, None] for c in range(6))
    W, bq_load, free_slots = (sites[:, None, :, c] for c in range(3))
    zero = torch.zeros((), dtype=torch.float64, device=jobs.device)
    tt = (8.0 * size) / bw
    t_cost = tt + t_load + t_downtime_s
    energy_ok = energy_ratio * tt < W
    not_c = tt < class_c_s
    if use_stoch:
        time_ok = t_cost < alpha * torch.maximum(W + ppf_sigma, zero)
    else:
        time_ok = t_cost < alpha * W
    ok = time_ok & energy_ok & not_c
    avoided = torch.maximum(zero, torch.minimum(W, rem) - torch.minimum(cur_green, rem))
    benefit = gamma * avoided - betaqp * (bq_load - load_src)
    benefit = benefit + torch.where(free_slots <= 0, torch.full_like(free_slots, -queue_penalty_s),
                                    torch.zeros_like(free_slots))
    sid = torch.arange(bw.shape[2], dtype=torch.float64, device=jobs.device)
    valid = ok & (sid != s_i) & (benefit > torch.maximum(t_cost, torch.full_like(t_cost, min_benefit_s)))
    b = torch.where(valid, benefit, -torch.inf)
    mb = b.amax(dim=2, keepdim=True)
    tie = valid & (b == mb)
    ttm = torch.where(tie, tt, torch.inf)
    tie = tie & (ttm == ttm.amin(dim=2, keepdim=True))
    first = tie.to(torch.uint8).argmax(dim=2)
    return torch.where(torch.isfinite(mb[..., 0]), first, -1)
