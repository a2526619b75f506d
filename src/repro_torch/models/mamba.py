"""Mamba-1 selective SSM mixer, jamba's non-attention layers (port of
``repro/models/mamba.py``).

The prefill runs the sequence in chunks of about ``CHUNK`` tokens, as the
JAX package does: inside a chunk the linear recurrence h_t = Abar_t h_{t-1}
+ Bx_t is a prefix scan over the chunk's time axis, and the state is
carried from chunk to chunk by a Python loop (the package's ``lax.scan``).
PyTorch has no associative scan, so the prefix is a Hillis-Steele doubling
scan on the float32 (Abar, Bx) pairs: ceil(log2(l)) elementwise passes
over the chunk, out of place so that autograd sees every one.  Only one
chunk's (b, l, d_inner, d_state) tensors are ever built (268 MB each at
jamba's width, 2 x 256 tokens).  The scan sums in another order than
``jax.lax.associative_scan``; the tests hold the results at float32
tolerances.  The scan is plain PyTorch, as it is plain JAX in the package:
it is no Pallas kernel.

Decode is the O(1) recurrent update.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import truncated_normal

CHUNK = 256


def init_mamba(gen, d: int, *, expand: int, d_state: int, d_conv: int, num_layers: int,
               dtype, device) -> dict:
    """The JAX package's leaves; ``A_log`` and ``D`` are float32 whatever
    ``dtype`` is (a float32 leaf inside a bf16 tree)."""
    d_in = expand * d
    dt_rank = max(1, d // 16)
    out_std = 0.02 / max(1.0, (2.0 * num_layers) ** 0.5)
    # S4D-real initialization for A.
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=device).expand(d_in, d_state)
    return {
        "in_proj": truncated_normal(gen, (d, 2 * d_in), 0.02, dtype, device),
        "conv_w": truncated_normal(gen, (d_conv, d_in), 0.02, dtype, device),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": truncated_normal(gen, (d_in, dt_rank + 2 * d_state), 0.02, dtype, device),
        "dt_proj": truncated_normal(gen, (dt_rank, d_in), dt_rank ** -0.5, dtype, device),
        "dt_bias": torch.full((d_in,), math.log(math.expm1(0.01)), dtype=torch.float32,
                              device=device).to(dtype),
        "A_log": torch.log(A),
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": truncated_normal(gen, (d_in, d), out_std, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv along seq. x: (b, s, c), w: (k, c).  ``state``
    (b, k-1, c), if given, is the left context (decode).  Returns (out, the
    last k-1 inputs as the next state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (b, s+k-1, c)
    out = sum(xp[:, i: i + x.shape[1], :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return out + b, new_state


def _ssm_params(p, xc, d_state: int):
    """xc: (b, l, d_in) post-conv activations -> (dt, B, C), float32."""
    dt_rank = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"]  # (b, l, dt_rank + 2N)
    dt_raw, B, C = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"].float())  # (b, l, d_in)
    return dt.float(), B.float(), C.float()


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix of the pairs (a_t, b_t) along dim 1 under
    (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): (the running products of a,
    h_t for h_0 = 0).  Hillis-Steele: at offset 1, 2, 4, ... each element
    takes in the prefix that ends ``offset`` places before it."""
    offset = 1
    while offset < a.shape[1]:
        a_lo, b_lo = a[:, :-offset], b[:, :-offset]
        a_hi, b_hi = a[:, offset:], b[:, offset:]
        b = torch.cat([b[:, :offset], a_hi * b_lo + b_hi], dim=1)
        a = torch.cat([a[:, :offset], a_hi * a_lo], dim=1)
        offset *= 2
    return a, b


def _scan_chunk(h0, A, dt, B, C, x):
    """One chunk of the selective scan.
    h0: (b, d_in, N); dt: (b, l, d_in); B, C: (b, l, N); x: (b, l, d_in)."""
    Abar = torch.exp(dt[..., None] * (-torch.exp(A))[None, None])  # (b, l, d_in, N)
    Bx = (dt * x)[..., None] * B[:, :, None, :]  # (b, l, d_in, N)
    a_cum, h_intra = _prefix_scan(Abar, Bx)
    h = h_intra + a_cum * h0[:, None]  # (b, l, d_in, N)
    y = torch.einsum("bldn,bln->bld", h, C)
    return h[:, -1], y


def apply_mamba(p: dict, x: torch.Tensor, *, d_state: int, return_state: bool = False):
    """Full-sequence forward. x: (b, s, d) -> (b, s, d).  The sequence is
    cut into ``max(1, s // CHUNK)`` chunks of equal length, as in the JAX
    package, so ``s`` must be a multiple of that count.  With
    ``return_state``, also the decode state after the last token ({'conv',
    'ssm'}, as ``apply_mamba_decode`` takes it), so that decode can follow a
    prefill."""
    b, s, _ = x.shape
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, _ = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dt, B, C = _ssm_params(p, xc, d_state)
    xcf = xc.float()
    n_chunks = max(1, s // CHUNK)
    if s % n_chunks:
        raise ValueError(f"apply_mamba: {s} tokens do not split into {n_chunks} chunks of equal "
                         f"length (the JAX package's chunking: max(1, s // {CHUNK}) chunks)")
    l = s // n_chunks
    h = xcf.new_zeros((b, xi.shape[-1], d_state))
    ys = []
    for c in range(n_chunks):
        t = slice(c * l, (c + 1) * l)
        h, y = _scan_chunk(h, p["A_log"], dt[:, t], B[:, t], C[:, t], xcf[:, t])
        ys.append(y)
    y = torch.cat(ys, dim=1) + xcf * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if not return_state:
        return out
    k = p["conv_w"].shape[0]
    conv = torch.cat([xi.new_zeros((b, k - 1, xi.shape[-1])), xi], dim=1)[:, s:]
    return out, {"conv": conv, "ssm": h}


# ---------------------------------------------------------------------------
# Decode (recurrent)
# ---------------------------------------------------------------------------


def mamba_state_spec(batch: int, d: int, *, expand: int, d_state: int, d_conv: int,
                     dtype) -> dict:
    """{'conv': (shape, dtype), 'ssm': (shape, float32)} of one layer's
    decode state."""
    d_in = expand * d
    return {"conv": ((batch, d_conv - 1, d_in), dtype),
            "ssm": ((batch, d_in, d_state), torch.float32)}


def apply_mamba_decode(p: dict, x: torch.Tensor, state: dict, *, d_state: int):
    """x: (b, 1, d); state: {'conv', 'ssm'} -> (y (b, 1, d), new state)."""
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"], state=state["conv"])
    xc = F.silu(xc)
    dt, B, C = _ssm_params(p, xc, d_state)
    A = -torch.exp(p["A_log"])  # (d_in, N)
    xcf = xc.float()
    Abar = torch.exp(dt[:, 0, :, None] * A[None])  # (b, d_in, N)
    Bx = (dt[:, 0] * xcf[:, 0])[..., None] * B[:, 0, None, :]
    h = Abar * state["ssm"] + Bx  # (b, d_in, N)
    y = torch.einsum("bdn,bn->bd", h, C[:, 0]) + xcf[:, 0] * p["D"]
    y = y[:, None].to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_state.to(state["conv"].dtype), "ssm": h}
