"""GQA attention with RoPE, sliding windows, soft-capping, qk-norm and a
KV-cache decode path (port of ``repro/models/attention.py``).

Train / prefill attention goes through ``kernels.ops.flash_attention``
(the hand-written kernel on the card).  Decode attention and the
encoder-decoder's cross-attention are the plain quadratic ``attend_ref``,
as in the JAX package, where they are no Pallas kernel either.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import rms_norm_1d, truncated_normal
from repro_torch.parallel import shards
from repro_torch.parallel.compat import DTensor, Replicate, Shard
from repro_torch.parallel.sharding import shd

NEG_INF = -2.0e38


def init_attention(
    gen,
    d_model: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    *,
    qkv_bias: bool,
    qk_norm: bool,
    num_layers: int,
    dtype,
    device,
) -> dict:
    out_std = 0.02 / max(1.0, (2.0 * num_layers) ** 0.5)
    p = {
        "wq": truncated_normal(gen, (d_model, num_heads, head_dim), 0.02, dtype, device),
        "wk": truncated_normal(gen, (d_model, num_kv_heads, head_dim), 0.02, dtype, device),
        "wv": truncated_normal(gen, (d_model, num_kv_heads, head_dim), 0.02, dtype, device),
        "wo": truncated_normal(gen, (num_heads, head_dim, d_model), out_std, dtype, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((num_heads, head_dim), dtype=dtype, device=device)
        p["bk"] = torch.zeros((num_kv_heads, head_dim), dtype=dtype, device=device)
        p["bv"] = torch.zeros((num_kv_heads, head_dim), dtype=dtype, device=device)
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=device)
    return p


def _mask_bias(qpos, kpos, mask_kind: str, window: int) -> Optional[torch.Tensor]:
    """Additive mask bias broadcastable to (..., q, k)."""
    if mask_kind == "full":
        return None
    ok = kpos[..., None, :] <= qpos[..., :, None]
    if mask_kind == "window" and window > 0:
        ok &= (qpos[..., :, None] - kpos[..., None, :]) < window
    zero = torch.zeros((), device=ok.device)
    return torch.where(ok, zero, torch.full((), NEG_INF, device=ok.device))


def attend_ref(
    q: torch.Tensor,  # (b, s, nh, hd)
    k: torch.Tensor,  # (b, t, nkv, hd)
    v: torch.Tensor,  # (b, t, nkv, hd)
    *,
    mask_kind: str,
    window: int = 0,
    attn_softcap: float = 0.0,
    qpos: Optional[torch.Tensor] = None,  # (b, s)
    kpos: Optional[torch.Tensor] = None,  # (b, t)
    kv_valid: Optional[torch.Tensor] = None,  # (b, t) bool — decode cache validity
    all_reduce: Optional[Callable] = None,
) -> torch.Tensor:
    """Quadratic GQA attention, f32 softmax. Returns (b, s, nh, hd).

    With ``all_reduce`` (``all_reduce(t, op)``, op "max" or "sum" over the
    ranks that hold the other keys), k and v are this rank's share of the
    keys and the softmax is partial: the row max, the row sum and the
    output are reduced over the shares."""
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(b, s, nkv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * (hd ** -0.5)
    if attn_softcap:
        scores = attn_softcap * torch.tanh(scores / attn_softcap)
    if qpos is None:
        qpos = torch.arange(s, device=q.device).expand(b, s)
    if kpos is None:
        kpos = torch.arange(t, device=q.device).expand(b, t)
    bias = _mask_bias(qpos, kpos, mask_kind, window)  # (b, s, t) or None
    if bias is not None:
        scores = scores + bias[:, None, None, :, :]
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, None, :], scores,
                             torch.full((), NEG_INF, device=q.device))
    if all_reduce is None:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    else:
        e = torch.exp(scores - all_reduce(torch.amax(scores, dim=-1, keepdim=True), "max"))
        probs = (e / all_reduce(torch.sum(e, dim=-1, keepdim=True), "sum")).to(q.dtype)
        out = all_reduce(torch.einsum("bkgst,btkh->bskgh", probs, v), "sum")
    return out.reshape(b, s, nh, hd)


def _project_qkv(p, x, kv_x, *, qk_norm):
    q = shards.einsum("bsd,dhk->bshk", x, p["wq"])
    k = shards.einsum("btd,dhk->bthk", kv_x, p["wk"])
    v = shards.einsum("btd,dhk->bthk", kv_x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if qk_norm:
        q = rms_norm_1d(q, p["q_norm"])
        k = rms_norm_1d(k, p["k_norm"])
    return q, k, v


def apply_attention(
    p: dict,
    x: torch.Tensor,  # (b, s, d)
    *,
    positions: torch.Tensor,  # (b, s) or (b, s, 3): rope ids only
    rope_type: str,
    rope_theta: float,
    mrope_sections=(),
    qk_norm: bool = False,
    mask_kind: str = "causal",
    window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill).  The mask
    runs on sequence indices (K1 takes no positions); ``positions`` only
    feed the rope, so M-RoPE's t / h / w ids may repeat or jump."""
    q, k, v = _project_qkv(p, x, x, qk_norm=qk_norm)
    q = rope_lib.apply_positional(q, positions, rope_type, rope_theta, mrope_sections)
    q = shd(q, "batch", "seq", "heads_act", "head_dim")
    k = rope_lib.apply_positional(k, positions, rope_type, rope_theta, mrope_sections)
    k = shd(k, "batch", None, "heads_act", "head_dim")
    v = shd(v, "batch", None, "heads_act", "head_dim")
    # The kernel reads (b, s, heads, hd) rows directly.
    out = kernel_ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(),
        mask_kind=mask_kind, window=window, attn_softcap=attn_softcap,
    )
    out = shd(out, "batch", "seq", "heads_act", "head_dim")
    return shards.einsum("bshk,hkd->bsd", out, p["wo"])


def apply_cross_attention(p: dict, x: torch.Tensor, kv) -> torch.Tensor:
    """Cross-attention of the decoder stream x (b, s, d) over the encoder's
    output: ``kv`` is either the precomputed (k, v) pair, each (b, t, nkv,
    hd) (``cross_kv``, the decode cache), or the raw (b, t, d) encoder
    output.  Every query sees every key: the plain ``attend_ref`` with a
    full mask, as in the JAX package, where it is no Pallas kernel."""
    if isinstance(kv, tuple):
        k, v = kv
        q = shards.einsum("bsd,dhk->bshk", x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
    else:
        q, k, v = _project_qkv(p, x, kv, qk_norm=False)
    out = shards.on_shards(lambda ql, kl, vl: attend_ref(ql, kl, vl, mask_kind="full"), q, k, v,
                           batched=(0, 1))
    return shards.einsum("bshk,hkd->bsd", out, p["wo"])


def cross_kv(p: dict, enc_out: torch.Tensor):
    """(k, v), each (b, t, nkv, hd), of the encoder output (b, t, d)."""
    k = shards.einsum("btd,dhk->bthk", enc_out, p["wk"])
    v = shards.einsum("btd,dhk->bthk", enc_out, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


# ---------------------------------------------------------------------------
# Decode path (single new token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int, dtype, device):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_attention_decode(
    p: dict,
    x: torch.Tensor,  # (b, 1, d) current-token activations
    cache: dict,  # {'k','v'}: (b, T, nkv, hd)
    index: int,  # absolute position of the token (same for the batch)
    *,
    positions: torch.Tensor,  # (b, 1) or (b, 1, 3): rope ids only
    rope_type: str,
    rope_theta: float,
    mrope_sections=(),
    qk_norm: bool = False,
    mask_kind: str = "causal",
    window: int = 0,
    attn_softcap: float = 0.0,
    long_context: bool = False,
):
    """One-token attention step.  Unlike the JAX package, which returns a
    new cache, the port writes the new key and value into ``cache`` in
    place (no copy of the whole cache per token) and returns it.

    A sliding-window layer's cache holds T <= window slots (the reference's
    ``min(max_len, sliding_window)``) as a ring buffer: position ``index``
    goes to slot ``index % T``, and each slot's absolute position (the
    newest one written there) feeds the window mask.  So decode equals the
    full-sequence forward past the window too.  (The reference writes with
    ``dynamic_update_slice``, which clamps every position past T - 1 into
    the last slot, and its mask then drops the wrong keys.)  Any other
    layer's cache holds every position: ``index`` must be below T.

    A DTensor cache stays where its placements put it (``long_context``
    selects the reference's long-context pspecs: no batch sharding, the
    sequence over ('data', 'model')): the new key and value are written on
    the shard that owns the slot only, and a sequence-sharded cache is
    attended shard by shard with a partial softmax (``_attend_sharded``),
    so decode moves no cache between ranks."""
    q, k, v = _project_qkv(p, x, x, qk_norm=qk_norm)
    q = rope_lib.apply_positional(q, positions, rope_type, rope_theta, mrope_sections)
    k = rope_lib.apply_positional(k, positions, rope_type, rope_theta, mrope_sections)
    ck, cv = cache["k"], cache["v"]
    b, T = x.shape[0], ck.shape[1]
    if mask_kind != "window" and index >= T:
        raise IndexError(f"decode position {index} beyond the cache's {T} slots")
    if isinstance(ck, DTensor):
        seq_axis = "kv_long" if long_context else "kv_seq"
        batch_axis = None if long_context else "dp_batch"
        for c in (ck, cv):
            if shd(c, batch_axis, seq_axis, None, None) is not c:
                raise ValueError(f"decode cache placed {c.placements}, not by the cache pspecs")
        out = _attend_sharded(q, k, v, ck, cv, index, mask_kind=mask_kind, window=window,
                              attn_softcap=attn_softcap)
        return shards.einsum("bshk,hkd->bsd", out, p["wo"]), cache
    slot = index % T
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    # the absolute position each slot holds; negative: not written yet
    kpos = index - torch.remainder(index - torch.arange(T, device=x.device), T)
    kpos = kpos.expand(b, T)
    valid = kpos >= 0
    # The query's mask position is its absolute position, not its rope id.
    qpos = torch.full((b, 1), index, device=x.device)
    out = attend_ref(
        q, ck, cv,
        mask_kind="window" if mask_kind == "window" else "full",
        window=window, attn_softcap=attn_softcap,
        qpos=qpos, kpos=kpos, kv_valid=valid,
    )
    y = shards.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, cache


def _attend_sharded(q, k, v, ck: DTensor, cv: DTensor, index: int, *, mask_kind: str,
                    window: int, attn_softcap: float) -> DTensor:
    """Decode attention of q (b, 1, nh, hd) over a DTensor cache (b, T, nkv,
    hd) whose batch and sequence dims may be sharded.  q, k and v take the
    cache's batch placement; the new k / v go into the local cache only on
    the rank whose sequence shard holds slot ``index % T``; each rank
    scores its own slots, and over sequence shards the softmax is partial
    (``attend_ref``'s ``all_reduce``): all-reduces of the row max, the row
    sum and the output (a few KB a token), never of the cache."""
    import torch.distributed._functional_collectives as funcol

    mesh = ck.device_mesh
    want = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                 for pl in ck.placements)
    q, k, v = (x if tuple(x.placements) == want else x.redistribute(mesh, want)
               for x in (q, k, v))
    seq_dims = [i for i, pl in enumerate(ck.placements) if isinstance(pl, Shard) and pl.dim == 1]
    coord = mesh.get_coordinate()
    shard, n_seq = 0, 1
    for i in seq_dims:  # row-major over the mesh dims that split the sequence
        shard, n_seq = shard * mesh.size(i) + coord[i], n_seq * mesh.size(i)
    ql, ckl, cvl = q.to_local(), ck.to_local(), cv.to_local()
    T, Tl = ck.shape[1], ckl.shape[1]
    slot = index % T
    if slot // Tl == shard:
        ckl[:, slot - shard * Tl] = k.to_local()[:, 0].to(ckl.dtype)
        cvl[:, slot - shard * Tl] = v.to_local()[:, 0].to(cvl.dtype)
    slots = shard * Tl + torch.arange(Tl, device=ckl.device)
    b = ql.shape[0]
    kpos = (index - torch.remainder(index - slots, T)).expand(b, Tl)
    qpos = torch.full((b, 1), index, device=ckl.device)
    reduce = None
    if n_seq > 1:
        def reduce(t, op):
            for i in seq_dims:
                t = funcol.all_reduce(t, op, (mesh, i))
            return t

    out = attend_ref(ql, ckl, cvl, mask_kind="window" if mask_kind == "window" else "full",
                     window=window, attn_softcap=attn_softcap, qpos=qpos, kpos=kpos,
                     kv_valid=kpos >= 0, all_reduce=reduce)
    return DTensor.from_local(out, mesh, want, run_check=False)
