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
jamba's width, 2 x 256 tokens), in the backward too: each chunk is
recomputed there (``_scan``).  The scan sums in another order than
``jax.lax.associative_scan``; the tests hold the results at float32
tolerances.  The scan is plain PyTorch, as it is plain JAX in the package:
it is no Pallas kernel.

Decode is the O(1) recurrent update.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.models.layers import truncated_normal
from repro_torch.parallel.shards import Whole, on_channel_shards
from repro_torch.parallel.sharding import shd

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


def _ssm_params(p, xc, d_state: int, ch=Whole):
    """xc: (b, l, c) post-conv activations of a block of channels -> (dt,
    B, C), float32.  ``x_proj`` sums over the channels, so with channel
    blocks its product is the one partial sum the mixer reduces (every
    channel needs the whole B and C)."""
    dt_rank = p["dt_proj"].shape[0]
    proj = ch.reduce(xc @ p["x_proj"])  # (b, l, dt_rank + 2N)
    dt_raw, B, C = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"].float())  # (b, l, c)
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
    # a copy of the last state: a view would keep all of h alive while the
    # next chunk holds it as its input
    return h[:, -1].clone(), y


def _scan(h, A, dt, B, C, x, n_chunks: int):
    """The chunks in turn from the state ``h``: (last state, y (b, s, c)).
    Under autograd each chunk's passes are recomputed in the backward
    (non-reentrant checkpointing), so that only one chunk's (b, l, c, N)
    tensors are alive at once, in the forward and in the backward (the
    recompute of a remat group included), and only the carried states are
    kept.  The recompute runs the same ops: the values are the same."""
    ys = []
    # split, not a slice per chunk: a slice's backward writes its gradient
    # into zeros of the whole sequence, once per chunk
    for parts in zip(*(t.chunk(n_chunks, dim=1) for t in (dt, B, C, x))):
        if torch.is_grad_enabled():
            h, y = ckpt.checkpoint(_scan_chunk, h, A, *parts, use_reentrant=False)
        else:
            h, y = _scan_chunk(h, A, *parts)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


# Each leaf's inner-channel dim (its 'mlp' dim in ``parallel/sharding.py``'s
# rules): ``in_proj``'s product is cut into [x | z], each split in blocks.
CHANNELS = {"in_proj": ("cols", 2), "conv_w": 1, "conv_b": 0, "x_proj": 0, "dt_proj": 1,
            "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}
STATE_CHANNELS = {"conv": 2, "ssm": 1}


def _mixer(x, p, ch, state, *, d_state: int, return_state: bool):
    """The full-sequence mixer on one block of inner channels (``ch``;
    ``Whole`` for all of them): x (b, s, d) and the block's params ->
    (its part of the output (b, s, d), a partial sum over the blocks; the
    block's decode state or None)."""
    b, s, _ = x.shape
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, _ = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dt, B, C = _ssm_params(p, xc, d_state, ch)
    xcf = xc.float()
    n_chunks = max(1, s // CHUNK)
    if s % n_chunks:
        raise ValueError(f"apply_mamba: {s} tokens do not split into {n_chunks} chunks of equal "
                         f"length (the JAX package's chunking: max(1, s // {CHUNK}) chunks)")
    h, y = _scan(xcf.new_zeros((b, xi.shape[-1], d_state)), p["A_log"], dt, B, C, xcf, n_chunks)
    y = y + xcf * p["D"]
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    if not return_state:
        return out, None
    k = p["conv_w"].shape[0]
    conv = torch.cat([xi.new_zeros((b, k - 1, xi.shape[-1])), xi], dim=1)[:, s:]
    return out, {"conv": conv, "ssm": h}


def apply_mamba(p: dict, x: torch.Tensor, *, d_state: int, return_state: bool = False):
    """Full-sequence forward. x: (b, s, d) -> (b, s, d).  The sequence is
    cut into ``max(1, s // CHUNK)`` chunks of equal length, as in the JAX
    package, so ``s`` must be a multiple of that count.  With
    ``return_state``, also the decode state after the last token ({'conv',
    'ssm'}, as ``apply_mamba_decode`` takes it), so that decode can follow a
    prefill.

    On a DTensor the mixer runs on each rank's batch shard, the sequence
    whole, and on its block of the inner channels, where the param rules
    put them (``parallel/shards.on_channel_shards``): ``in_proj``'s
    columns and ``out_proj``'s rows of the block (the block's part of the
    output is a partial sum, reduced where the sequence is split again),
    the conv, ``dt_proj``, ``A_log`` and ``D`` local; ``x_proj``'s product
    (dt, B, C) is all-reduced; the state (``return_state``) comes back on
    the blocks."""
    fn = functools.partial(_mixer, d_state=d_state, return_state=return_state)
    if torch.is_grad_enabled():
        # the mixer keeps only its input and params for the backward, which
        # reruns it (and, inside, each chunk's scan again): the sequence-wide
        # float32 tensors of a layer group's Mamba layers are not all kept
        # through the group's recompute
        fn = functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    out, state = on_channel_shards(fn, x, p, CHANNELS, state_channels=STATE_CHANNELS)
    out = shd(out, "batch", "seq", None)
    return (out, state) if return_state else out


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


def mamba_state_pspecs(long_context: bool = False) -> dict:
    """Logical pspecs of ``mamba_state_spec``'s leaves (the reference's)."""
    inner = "kv_long" if long_context else "model"
    b = None if long_context else "dp_batch"
    return {"conv": (b, None, inner), "ssm": (b, inner, None)}


def _decode(x, p, ch, state, *, d_state: int):
    """One token on one block of inner channels (``_mixer``'s split)."""
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"], state=state["conv"])
    xc = F.silu(xc)
    dt, B, C = _ssm_params(p, xc, d_state, ch)
    A = -torch.exp(p["A_log"])  # (c, N)
    xcf = xc.float()
    Abar = torch.exp(dt[:, 0, :, None] * A[None])  # (b, c, N)
    Bx = (dt[:, 0] * xcf[:, 0])[..., None] * B[:, 0, None, :]
    h = Abar * state["ssm"] + Bx  # (b, c, N)
    y = torch.einsum("bdn,bn->bd", h, C[:, 0]) + xcf[:, 0] * p["D"]
    y = y[:, None].to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_state.to(state["conv"].dtype), "ssm": h}


def apply_mamba_decode(p: dict, x: torch.Tensor, state: dict, *, d_state: int):
    """x: (b, 1, d); state: {'conv', 'ssm'} -> (y (b, 1, d), new state).
    On a DTensor, as ``apply_mamba`` on the blocks of inner channels that
    the state's placements give, x's batch split as the state's: the state
    stays where its pspecs put it (under the baseline rules its batch split
    over 'dp_batch' and every channel whole, so one block)."""
    fn = functools.partial(_decode, d_state=d_state)
    out, state = on_channel_shards(fn, x, p, CHANNELS, state, STATE_CHANNELS)
    return shd(out, "batch", "seq", None), state
