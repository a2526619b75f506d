"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential scan), following arXiv:2405.04517 (port of
``repro/models/xlstm.py``).

mLSTM stabilized recurrence (per head):
    m_t = max(f̂_t + m_{t-1}, ĩ_t)                       (f̂ = log-forget)
    C_t = e^{f̂_t + m_{t-1} - m_t} C_{t-1} + e^{ĩ_t - m_t} v_t k_tᵀ
    n_t = e^{f̂_t + m_{t-1} - m_t} n_{t-1} + e^{ĩ_t - m_t} k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, e^{-m_t})          (q scaled dh^-1/2)

Chunk-parallel form: with b_t = Σ_{τ≤t} f̂_τ inside a chunk,
    m_t = b_t + max(m_0, cummax_τ≤t (ĩ_τ - b_τ)),
so the stabilizer is a cumulative max, and both the intra-chunk
contribution (decay-matrix masked q·kᵀ) and the inter-chunk contribution
(carried C) are plain matmuls.  The chunks run in a Python loop (the JAX
package's ``lax.scan``), as does the recurrent form, the decode path.  The
sLSTM is a sequential loop over tokens.  All of it is plain PyTorch, as it
is plain JAX in the package: none of it is a Pallas kernel.

A decode state is a dict: mLSTM {'C', 'n', 'm'} (the JAX package's tuple
(C, n, m)), sLSTM {'c', 'n', 'h', 'm'}.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation, truncated_normal
from repro_torch.parallel.compat import DTensor
from repro_torch.parallel.shards import Whole, on_channel_shards, on_shards
from repro_torch.parallel.sharding import shd

CHUNK = 256
NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def init_mlstm(gen, d: int, num_heads: int, num_layers: int, dtype, device) -> dict:
    d_in = 2 * d  # projection factor 2
    dh = d_in // num_heads
    out_std = 0.02 / max(1.0, (2.0 * num_layers) ** 0.5)

    def tn(shape, std=0.02):
        return truncated_normal(gen, shape, std, dtype, device)

    return {
        "w_up": tn((d, 2 * d_in)),  # [x | z-gate]
        # block-diagonal per-head q/k/v maps (xLSTM §mLSTM block)
        "wq": tn((num_heads, dh, dh)),
        "wk": tn((num_heads, dh, dh)),
        "wv": tn((num_heads, dh, dh)),
        "wi": tn((d_in, num_heads)),
        "wf": tn((d_in, num_heads)),
        "bi": torch.zeros((num_heads,), dtype=dtype, device=device),
        "bf": torch.full((num_heads,), 3.0, dtype=dtype, device=device),  # open forget gates
        "skip": torch.ones((d_in,), dtype=dtype, device=device),
        "w_down": tn((d_in, d), out_std),
    }


def _mlstm_qkvif(p, xa, heads: slice, cols: slice, kcols: slice):
    """q, k, v and the gates of the heads ``heads`` from ``xa`` (b, s,
    d_in), all of the channels: q and k at their columns ``kcols``, v at
    ``cols`` (every column for whole tensors)."""
    b, s, _ = xa.shape
    H, dh = p["wq"].shape[0], p["wq"].shape[1]
    xh = xa.reshape(b, s, H, dh)[:, :, heads]
    q = torch.einsum("bshk,hkj->bshj", xh, p["wq"][heads][..., kcols])
    k = torch.einsum("bshk,hkj->bshj", xh, p["wk"][heads][..., kcols])
    v = torch.einsum("bshk,hkj->bshj", xh, p["wv"][heads][..., cols])
    i_raw = (xa @ p["wi"][:, heads] + p["bi"][heads]).float()  # (b, s, heads)
    f_raw = (xa @ p["wf"][:, heads] + p["bf"][heads]).float()
    return q, k, v, i_raw, F.logsigmoid(f_raw)


def _mlstm_chunk(carry, q, k, v, i_raw, logf):
    """One chunk. carry = (C (b,H,dh,e), n (b,H,dh), m (b,H)).
    q,k: (b,l,H,dh); v: (b,l,H,e) (e = dh, or a block of v's columns);
    i_raw, logf: (b,l,H) f32."""
    C0, n0, m0 = carry
    l, dh = q.shape[1], q.shape[3]
    scale = dh ** -0.5
    bcs = torch.cumsum(logf, dim=1)  # (b,l,H) inclusive
    # stabilizer: m_t = b_t + max(m0, cummax(i_τ - b_τ))
    g = torch.cummax(i_raw - bcs, dim=1).values
    m = bcs + torch.maximum(m0[:, None], g)  # (b,l,H)
    # intra-chunk decay matrix  D_tj = exp(b_t - b_j + i_j - m_t),  j <= t
    S = bcs[:, :, None, :] - bcs[:, None, :, :] + i_raw[:, None, :, :]  # (b,t,j,H)
    tri = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    S = torch.where(tri[None, :, :, None], S, torch.full((), NEG, device=q.device))
    D = torch.exp(S - m[:, :, None, :])  # (b,t,j,H)
    qf, kf, vf = (a.float() for a in (q, k, v))
    scores = torch.einsum("bthk,bjhk->btjh", qf, kf) * scale
    w = scores * D  # w_tj = D_tj * (q_t . k_j) * scale
    num_intra = torch.einsum("btjh,bjhe->bthe", w, vf)
    den_intra = torch.sum(w, dim=2)  # (b,t,H) == sum_j w_tj  (n_t . q_t intra)
    # inter-chunk: decay from carry  exp(m0 + b_t - m_t)
    dec = torch.exp(m0[:, None] + bcs - m)  # (b,l,H)
    qd = qf * scale * dec[..., None]
    num = num_intra + torch.einsum("bthk,bhke->bthe", qd, C0)
    den = den_intra + torch.einsum("bthk,bhk->bth", qd, n0)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m))[..., None]
    # end-of-chunk carry
    bL = bcs[:, -1]  # (b,H)
    mL = m[:, -1]
    wC = torch.exp(bL[:, None] - bcs + i_raw - mL[:, None])  # (b,l,H)
    carried = torch.exp(m0 + bL - mL)
    C1 = carried[:, :, None, None] * C0 + torch.einsum("blh,blhk,blhe->bhke", wC, kf, vf)
    n1 = carried[:, :, None] * n0 + torch.einsum("blh,blhk->bhk", wC, kf)
    return (C1, n1, mL), h


def _mlstm_zero_carry(b: int, H: int, dh: int, device, e: Optional[int] = None):
    """The JAX package's carry for a sequence with no past: C = n = 0,
    m = -inf (C (b, H, dh, e), e = dh by default)."""
    return (torch.zeros((b, H, dh, e or dh), device=device),
            torch.zeros((b, H, dh), device=device),
            torch.full((b, H), -torch.inf, device=device))


def mlstm_cell(q, k, v, i_raw, logf, carry=None, chunk: Optional[int] = None):
    """Chunk-parallel mLSTM over a full sequence in chunks of ``min(chunk,
    s)`` tokens (default ``CHUNK``), which must divide ``s`` (as the JAX
    package asserts).
    q,k: (b,s,H,dh); v: (b,s,H,e); i_raw/logf: (b,s,H) f32.  Returns (h
    (b,s,H,e) f32, carry)."""
    b, s, H, dh = q.shape
    if carry is None:
        carry = _mlstm_zero_carry(b, H, dh, q.device, v.shape[3])
    l = min(chunk or CHUNK, s)
    if s % l:
        raise ValueError(f"mlstm_cell: {s} tokens are not a whole number of {l}-token chunks")
    hs = []
    # split, not a slice per chunk: a slice's backward writes its gradient
    # into zeros of the whole sequence, once per chunk
    for qc, kc, vc, ic, fc in zip(*(a.split(l, dim=1) for a in (q, k, v, i_raw, logf))):
        carry, h = _mlstm_chunk(carry, qc, kc, vc, ic, fc)
        hs.append(h)
    return torch.cat(hs, dim=1), carry


def mlstm_cell_recurrent(q, k, v, i_raw, logf, carry=None, reduce=Whole.reduce):
    """The recurrence one token at a time (the decode path; the JAX
    package's oracle for ``mlstm_cell``).  q, k and the carry's C and n may
    hold a block of the key dim (C's dim 2): then the two products that sum
    over it, C q and n q, are partial sums that ``reduce`` completes."""
    b, s, H, dh = v.shape
    if carry is None:
        carry = _mlstm_zero_carry(b, H, dh, q.device)
    scale = dh ** -0.5
    C, n, m = carry
    hs = []
    for t in range(s):
        qt, kt, vt = (a[:, t].float() for a in (q, k, v))  # (b,H,dh)
        it, ft = i_raw[:, t], logf[:, t]  # (b,H)
        m2 = torch.maximum(ft + m, it)
        fdec = torch.exp(ft + m - m2)[..., None]
        iin = torch.exp(it - m2)[..., None]
        C = fdec[..., None] * C + iin[..., None] * torch.einsum("bhk,bhe->bhke", kt, vt)
        n = fdec * n + iin * kt
        den = reduce(torch.einsum("bhk,bhk->bh", n, qt * scale))
        num = reduce(torch.einsum("bhke,bhk->bhe", C, qt * scale))
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m2))[..., None])
        m = m2
    return torch.stack(hs, dim=1), (C, n, m)


# Each leaf's inner-channel dim (its 'mlp' dim in ``parallel/sharding.py``'s
# rules); the per-head maps and the gates read every channel (whole).
CHANNELS = {"w_up": ("cols", 2), "skip": 0, "w_down": 0}
STATE_CHANNELS = {"C": 2, "n": 2, "m": None}


def _block_cols(start: int, c: int, dh: int):
    """(heads, v's columns) of the channels [start, start + c) of (H, dh)."""
    if c >= dh:
        return slice(start // dh, (start + c) // dh), slice(0, dh)
    return slice(start // dh, start // dh + 1), slice(start % dh, start % dh + c)


def _mlstm(x, p, ch, state, *, num_heads: int, decode: bool):
    """The mLSTM block on one block of inner channels (``ch``; ``Whole``
    for all of them): (its part of the output (b, s, d), a partial sum over
    the blocks; the new state with ``decode``).  q, k and the gates read
    every channel, so the block's x is gathered whole; the full-sequence
    cell runs on the block's columns of v (its heads' (dh x c) carries:
    no sum over the blocks), decode on the key rows of every head's carry
    that the state's placements give (all of them under the baseline
    rules; C q and n q are summed over the blocks)."""
    xi, z = torch.chunk(x @ p["w_up"], 2, dim=-1)  # this block's channels
    xa = ch.gather(xi)
    b, s, d_in = xa.shape
    dh = d_in // num_heads
    c = xi.shape[-1]
    start = ch.index * c
    every = slice(0, None)
    if decode:
        kc = dh // ch.count
        rows = slice(ch.index * kc, (ch.index + 1) * kc)
        q, k, v, i_raw, logf = _mlstm_qkvif(p, xa, slice(0, num_heads), every, rows)
        carry = (state["C"], state["n"], state["m"])
        h, (C, n, m) = mlstm_cell_recurrent(q, k, v, i_raw, logf, carry=carry, reduce=ch.reduce)
        state = {"C": C, "n": n, "m": m}
        h = h.reshape(b, s, d_in)[..., start:start + c]
    else:
        heads, cols = _block_cols(start, c, dh)
        q, k, v, i_raw, logf = _mlstm_qkvif(p, xa, heads, cols, every)
        h, _ = mlstm_cell(q, k, v, i_raw, logf, carry=state)
        h = h.reshape(b, s, c)
    hflat = h.to(x.dtype) + xi * p["skip"]
    return (hflat * F.silu(z)) @ p["w_down"], state


def apply_mlstm(p: dict, x: torch.Tensor, num_heads: int, state=None, decode: bool = False):
    """Full mLSTM block. x: (b, s, d) -> (b, s, d); with ``decode``, the
    recurrent form from ``state`` ({'C', 'n', 'm'}), returning (out, new
    state).  On a DTensor, on each rank's batch shard, the sequence whole,
    and its block of the inner channels (``parallel/shards.
    on_channel_shards``, as ``models/mamba.apply_mamba``): ``w_up``'s
    columns and ``w_down``'s rows of the block; x gathered for q, k and
    the gates; decode runs on the blocks that the state's placements give,
    and the state stays where ``mlstm_state_pspecs`` puts it."""
    fn = functools.partial(_mlstm, num_heads=num_heads, decode=decode)
    out, state = on_channel_shards(fn, x, p, CHANNELS, state, STATE_CHANNELS)
    out = shd(out, "batch", "seq", None)
    return (out, state) if decode else out


def mlstm_state_pspecs(long_context: bool = False) -> dict:
    """Logical pspecs of ``mlstm_state_spec``'s leaves (the reference's,
    whose tuple (C, n, m) the port keeps as a dict)."""
    ax = "kv_long" if long_context else "model"
    b = None if long_context else "dp_batch"
    return {"C": (b, None, ax, None), "n": (b, None, ax), "m": (b, None)}


def mlstm_state_spec(batch: int, d: int, num_heads: int) -> dict:
    dh = 2 * d // num_heads
    f32 = torch.float32
    return {"C": ((batch, num_heads, dh, dh), f32), "n": ((batch, num_heads, dh), f32),
            "m": ((batch, num_heads), f32)}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def init_slstm(gen, d: int, num_heads: int, num_layers: int, dtype, device) -> dict:
    dh = d // num_heads
    p = {}
    for g in "ifzo":
        p[f"w{g}"] = truncated_normal(gen, (d, d), 0.02, dtype, device)
        p[f"r{g}"] = truncated_normal(gen, (num_heads, dh, dh), 0.02, dtype, device)
        p[f"b{g}"] = torch.full((d,), 3.0 if g == "f" else 0.0, dtype=dtype, device=device)
    dff = (d * 4) // 3
    p["ffn_wi"] = truncated_normal(gen, (d, dff), 0.02, dtype, device)
    p["ffn_wg"] = truncated_normal(gen, (d, dff), 0.02, dtype, device)
    p["ffn_wo"] = truncated_normal(gen, (dff, d), 0.02 / max(1.0, (2.0 * num_layers) ** 0.5),
                                   dtype, device)
    return p


def _slstm_scan(p, x, num_heads: int, state=None):
    """x: (b, s, d).  A sequential loop over the tokens (the sLSTM's
    recurrence is not associative).  Returns (h (b, s, d) in x's type, the
    last state)."""
    b, s, d = x.shape
    dh = d // num_heads
    if state is None:
        z = torch.zeros((b, d), device=x.device)
        state = {"c": z, "n": z + 1e-6, "h": z, "m": z}
    # (b, d) per token; unbind, not x[:, t]: a slice's backward writes its
    # gradient into zeros of the whole sequence, once per token
    pre = {g: (x @ p[f"w{g}"] + p[f"b{g}"]).unbind(1) for g in "ifzo"}

    def rmul(h, r):  # block-diagonal per-head recurrent matmul
        return torch.einsum("bhk,hkj->bhj", h.reshape(b, num_heads, dh), r).reshape(b, d)

    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(s):
        h_prev = h.to(x.dtype)
        it = (pre["i"][t] + rmul(h_prev, p["ri"])).float()
        ft = (pre["f"][t] + rmul(h_prev, p["rf"])).float()
        zt = torch.tanh((pre["z"][t] + rmul(h_prev, p["rz"])).float())
        ot = torch.sigmoid((pre["o"][t] + rmul(h_prev, p["ro"])).float())
        logf = F.logsigmoid(ft)
        m2 = torch.maximum(logf + m, it)
        i_ = torch.exp(it - m2)
        f_ = torch.exp(logf + m - m2)
        c = f_ * c + i_ * zt
        n = f_ * n + i_
        h = ot * c / torch.clamp(n, min=1e-6)
        m = m2
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), {"c": c, "n": n, "h": h, "m": m}


def apply_slstm(p: dict, x: torch.Tensor, num_heads: int, act: str = "gelu", state=None,
                decode: bool = False):
    """sLSTM block: the scan, then its gated FFN (pf 4/3).  The blocks call
    it with the default ``act``, "gelu", whatever the config's ``act`` is,
    as the JAX package does.  On a DTensor, per batch shard as
    ``apply_mlstm``."""
    if isinstance(x, DTensor):
        return on_shards(lambda xl, pl, st: apply_slstm(pl, xl, num_heads, act, state=st,
                                                        decode=decode), x, p, state, batched=(1,))
    h, state = _slstm_scan(p, x, num_heads, state=state)
    y = activation(act)(h @ p["ffn_wg"]) * (h @ p["ffn_wi"])
    out = y @ p["ffn_wo"]
    return (out, state) if decode else out


def slstm_state_pspecs(long_context: bool = False) -> dict:
    ps = (None if long_context else "dp_batch", "kv_long" if long_context else "model")
    return {name: ps for name in "cnhm"}


def slstm_state_spec(batch: int, d: int) -> dict:
    return {name: ((batch, d), torch.float32) for name in "cnhm"}
