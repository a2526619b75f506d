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

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation, truncated_normal
from repro_torch.parallel.compat import DTensor
from repro_torch.parallel.shards import on_shards
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


def _mlstm_qkvif(p, xi):
    b, s, _ = xi.shape
    H, dh = p["wq"].shape[0], p["wq"].shape[1]
    xh = xi.reshape(b, s, H, dh)
    q = torch.einsum("bshk,hkj->bshj", xh, p["wq"])
    k = torch.einsum("bshk,hkj->bshj", xh, p["wk"])
    v = torch.einsum("bshk,hkj->bshj", xh, p["wv"])
    i_raw = (xi @ p["wi"] + p["bi"]).float()  # (b, s, H)
    f_raw = (xi @ p["wf"] + p["bf"]).float()
    return q, k, v, i_raw, F.logsigmoid(f_raw)


def _mlstm_chunk(carry, q, k, v, i_raw, logf):
    """One chunk. carry = (C (b,H,dh,dh), n (b,H,dh), m (b,H)).
    q,k,v: (b,l,H,dh); i_raw, logf: (b,l,H) f32."""
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


def _mlstm_zero_carry(b: int, H: int, dh: int, device):
    """The JAX package's carry for a sequence with no past: C = n = 0,
    m = -inf."""
    return (torch.zeros((b, H, dh, dh), device=device),
            torch.zeros((b, H, dh), device=device),
            torch.full((b, H), -torch.inf, device=device))


def mlstm_cell(q, k, v, i_raw, logf, carry=None, chunk: Optional[int] = None):
    """Chunk-parallel mLSTM over a full sequence in chunks of ``min(chunk,
    s)`` tokens (default ``CHUNK``), which must divide ``s`` (as the JAX
    package asserts).
    q,k,v: (b,s,H,dh); i_raw/logf: (b,s,H) f32.  Returns (h (b,s,H,dh)
    f32, carry)."""
    b, s, H, dh = q.shape
    if carry is None:
        carry = _mlstm_zero_carry(b, H, dh, q.device)
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


def mlstm_cell_recurrent(q, k, v, i_raw, logf, carry=None):
    """The recurrence one token at a time (the decode path; the JAX
    package's oracle for ``mlstm_cell``)."""
    b, s, H, dh = q.shape
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
        den = torch.einsum("bhk,bhk->bh", n, qt * scale)
        num = torch.einsum("bhke,bhk->bhe", C, qt * scale)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m2))[..., None])
        m = m2
    return torch.stack(hs, dim=1), (C, n, m)


def apply_mlstm(p: dict, x: torch.Tensor, num_heads: int, state=None, decode: bool = False):
    """Full mLSTM block. x: (b, s, d) -> (b, s, d); with ``decode``, the
    recurrent form from ``state`` ({'C', 'n', 'm'}), returning (out, new
    state).  On a DTensor, per batch shard with the sequence gathered
    (``parallel/shards.on_shards``), the state placed as x."""
    if isinstance(x, DTensor):
        out = on_shards(lambda xl, pl, st: apply_mlstm(pl, xl, num_heads, state=st,
                                                       decode=decode), x, p, state, batched=(1,))
        return (shd(out[0], "batch", "seq", None), out[1]) if decode else shd(
            out, "batch", "seq", None)
    xi, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    xi = shd(xi, "batch", "seq", None)
    q, k, v, i_raw, logf = _mlstm_qkvif(p, xi)
    if decode:
        carry = (state["C"], state["n"], state["m"])
        h, (C, n, m) = mlstm_cell_recurrent(q, k, v, i_raw, logf, carry=carry)
        state = {"C": C, "n": n, "m": m}
    else:
        h, _ = mlstm_cell(q, k, v, i_raw, logf, carry=state)
    b, s, H, dh = h.shape
    hflat = h.reshape(b, s, H * dh).to(x.dtype) + xi * p["skip"]
    out = shd((hflat * F.silu(z)) @ p["w_down"], "batch", "seq", None)
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
