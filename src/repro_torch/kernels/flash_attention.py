"""Flash attention on the card: wrappers of ``csrc/flash_attention.cu`` (the
forward, K1) and ``csrc/flash_attention_bwd.cu`` (its backward), and the
``torch.autograd.Function`` that joins them for training.

The forward replaces ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``); its plain version is
``kernels/ref.py::flash_attention_ref``.  q, k and v are all float32
(tensor cores in 3xTF32, float32-class accuracy) or all bfloat16 (float32
accumulation, output in bfloat16); any other type raises.  The wrapper
counts its launches per type: float32 in ``flash_attention_cuda.launches``,
bfloat16 in ``flash_attention_cuda.launches_bf16``.

The backward has no TPU counterpart: the JAX package differentiates
``flash_attention_ref`` with XLA.  Its plain version is
``kernels/ref.py::flash_attention_bwd_ref`` (the autograd of
``flash_attention_ref``).  It takes the forward's types, float32 (3xTF32)
or bfloat16 (gradients in bfloat16); one call counts one launch, float32 in
``flash_attention_bwd_cuda.launches``, bfloat16 in
``flash_attention_bwd_cuda.launches_bf16``.  So ``FlashAttentionFn``
trains float32 and bfloat16 models on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
MASK_KINDS = {"full": 0, "causal": 1, "window": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_kind: str) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {x.device}")
        if x.dtype != q.dtype or x.dtype not in DTYPES:
            raise ValueError(f"q, k and v must all be float32 or all bfloat16; {name} is {x.dtype}")
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got {tuple(x.shape)}")
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if nkv == 0 or nh % nkv:
        raise ValueError(f"num_heads {nh} is not a multiple of num_kv_heads {nkv}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {HEAD_DIMS}")
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"mask_kind {mask_kind!r} not in {sorted(MASK_KINDS)}")


def _forward(q, k, v, mask_kind, window, attn_softcap,
             lse: Optional[torch.Tensor]) -> torch.Tensor:
    o = torch.empty_like(q)
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    lib = _build.load()
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, s, t, nh, nkv, hd, MASK_KINDS[mask_kind], int(window),
        float(attn_softcap), hd ** -0.5, DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    if q.dtype == torch.bfloat16:
        flash_attention_cuda.launches_bf16 += 1
    else:
        flash_attention_cuda.launches += 1
    return o


def _traced(q: torch.Tensor) -> bool:
    """Whether a call is traced: a fake tensor, or a dispatch mode on
    (``FlopCounterMode``, the dry-run's recorder)."""
    return isinstance(q, FakeTensor) or _get_current_dispatch_mode() is not None


# The entries are also custom ops, so that a fake tensor (the mesh dry-run)
# traces through them with no launch and FlopCounterMode counts them; an
# untraced call runs the implementation directly, without the op's
# dispatch.  The launch counters count in the implementations only.
def _fwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_kind: str, window: int,
              attn_softcap: float, with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, nh, _ = q.shape
    lse = torch.empty((b, nh, s) if with_lse else (0,), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, mask_kind, window, attn_softcap, lse if with_lse else None), lse


_fwd_op = torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                                  device_types="cuda")(_fwd_impl)


@_fwd_op.register_fake
def _(q, k, v, mask_kind, window, attn_softcap, with_lse):
    b, s, nh, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, nh, s) if with_lse else (0,), dtype=torch.float32)


def flash_attention_cuda(
    q: torch.Tensor,  # (b, s, nh, hd)
    k: torch.Tensor,  # (b, t, nkv, hd)
    v: torch.Tensor,  # (b, t, nkv, hd)
    *,
    mask_kind: str = "causal",
    window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    _check_qkv(q, k, v, mask_kind)
    fwd = _fwd_op if _traced(q) else _fwd_impl
    return fwd(q, k, v, mask_kind, int(window), float(attn_softcap), False)[0]


def flash_attention_lse_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    mask_kind: str = "causal", window: int = 0, attn_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 that also returns each row's log-sum-exp, float32 (b, nh, s), in
    base 2 of the scores times log2 e (``ref.flash_attention_lse_ref``):
    what the backward reads.  Counts as one K1 launch."""
    _check_qkv(q, k, v, mask_kind)
    fwd = _fwd_op if _traced(q) else _fwd_impl
    return fwd(q, k, v, mask_kind, int(window), float(attn_softcap), True)


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, *, mask_kind: str = "causal", window: int = 0, attn_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of K1 at (q, k, v) for the output cotangent ``do``,
    given K1's output ``o`` and ``lse`` (``flash_attention_lse_cuda``).
    q, k, v, o and do are all float32 or all bfloat16 (the gradients come
    in the same type); lse is float32."""
    _check_qkv(q, k, v, mask_kind)
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    for name, x, shape, dtype in (("o", o, q.shape, q.dtype), ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (b, nh, s), torch.float32)):
        if x.device != q.device or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {q.device}, got {x.dtype} on {x.device}")
        if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous of shape {tuple(shape)}, got {tuple(x.shape)}")
    bwd = _bwd_op if _traced(q) else _bwd_impl
    return bwd(q, k, v, o, lse, do, mask_kind, int(window), float(attn_softcap))


def _bwd_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
            do: torch.Tensor, mask_kind: str, window: int,
            attn_softcap: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, nh, hd = q.shape
    t, nkv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel copies 16-byte vectors)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, nh, s), dtype=torch.float32, device=q.device)
    lib = _build.load()
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        b, s, t, nh, nkv, hd, MASK_KINDS[mask_kind], int(window), float(attn_softcap),
        hd ** -0.5, DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    if q.dtype == torch.bfloat16:
        flash_attention_bwd_cuda.launches_bf16 += 1
    else:
        flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


_bwd_op = torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                                  device_types="cuda")(_bwd_impl)


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, mask_kind, window, attn_softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def visible_pairs(s: int, mask_kind: str, window: int) -> int:
    """(query, key) pairs a square (s x s) self-attention mask lets through."""
    if mask_kind == "full":
        return s * s
    if mask_kind == "window" and 0 < window < s:
        return window * (window + 1) // 2 + (s - window) * window
    return s * (s + 1) // 2


# FLOP formulas get shapes (torch.Size) in place of the tensors.
@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flop_formula(q, k, v, mask_kind, window, attn_softcap, with_lse, *args,
                      out_val=None, **kwargs) -> int:
    """QK^T and PV over the visible pairs: 4 b nh hd pairs."""
    b, s, nh, hd = q
    return 4 * b * nh * hd * visible_pairs(s, mask_kind, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flop_formula(q, k, v, o, lse, do, mask_kind, window, attn_softcap, *args,
                      out_val=None, **kwargs) -> int:
    """S, dP, dV, dQ and dK over the visible pairs: 10 b nh hd pairs."""
    b, s, nh, hd = q
    return 10 * b * nh * hd * visible_pairs(s, mask_kind, window)


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward, attention-backward kernel backward, in float32 or
    bfloat16; any other type raises.  For CUDA tensors only (the CPU
    differentiates the plain version with autograd).  The forward saves q,
    k, v, K1's output and its lse; under activation checkpointing they are
    dropped and the forward reruns in the backward pass (one more K1
    launch)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_kind: str, window: int, attn_softcap: float):
        if q.dtype not in DTYPES:
            raise NotImplementedError(
                f"training attention takes float32 or bfloat16, got {q.dtype}")
        o, lse = flash_attention_lse_cuda(q, k, v, mask_kind=mask_kind, window=window,
                                          attn_softcap=attn_softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(mask_kind=mask_kind, window=window, attn_softcap=attn_softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_bf16 = 0
flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_bf16 = 0
