"""Kernel dispatch by the input tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor takes the hand-written kernel, or the call raises.  There is no
override and no fallback.  ``launch_counts`` reads the kernels' launch
counters; ``reset_launch_counts`` sets them to 0.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import decide as dc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ref

# counter name -> (wrapper, the wrapper's attribute that counts the launches)
_COUNTERS = {
    "flash_attention": (fa.flash_attention_cuda, "launches"),
    "flash_attention_bf16": (fa.flash_attention_cuda, "launches_bf16"),
    "flash_attention_bwd": (fa.flash_attention_bwd_cuda, "launches"),
    "quantize_int8": (qz.quantize_int8_cuda, "launches"),
    "dequantize_int8": (qz.dequantize_int8_cuda, "launches"),
    "decide_dest": (dc.decide_dest_cuda, "launches"),
}


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def flash_attention(
    q, k, v, *, mask_kind="causal", window=0, attn_softcap=0.0, qpos=None, kpos=None,
):
    """GQA attention.  qpos/kpos are accepted for API parity with the decode
    path and ignored: train/prefill sequences are dense and left-aligned.

    On the card, a call that autograd records (grad enabled and an input
    that requires grad) goes through ``FlashAttentionFn``: K1 forward, the
    attention-backward kernel backward.  Any other call (prefill, serving,
    ``no_grad`` / ``inference_mode``) runs K1 alone.  On the CPU, autograd
    differentiates the plain version."""
    if _on_card(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return fa.FlashAttentionFn.apply(q, k, v, mask_kind, window, attn_softcap)
        return fa.flash_attention_cuda(q, k, v, mask_kind=mask_kind, window=window,
                                       attn_softcap=attn_softcap)
    return ref.flash_attention_ref(q, k, v, mask_kind=mask_kind, window=window,
                                   attn_softcap=attn_softcap)


def quantize_int8(x: torch.Tensor, *, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_card(x):
        return qz.quantize_int8_cuda(x, block=block)
    return ref.quantize_int8_ref(x, block=block)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    if _on_card(q):
        return qz.dequantize_int8_cuda(q, scale, block=block)
    return ref.dequantize_int8_ref(q, scale, block=block)


def decide_dest(jobs: torch.Tensor, sites: torch.Tensor, bw: torch.Tensor,
                **scalars) -> torch.Tensor:
    """The fused Algorithm-1 decide (K4) in float64: (B, K) int64
    destinations, -1 = stay.  ``scalars`` are the keyword arguments of
    ``decide.decide_dest_cuda`` (``core/policy_kernels.kernel_scalars``)."""
    if _on_card(jobs):
        return dc.decide_dest_cuda(jobs, sites, bw, **scalars)
    dc.check_decide_inputs(jobs, sites, bw)
    return ref.decide_dest_ref(jobs, sites, bw, **scalars)


def launch_counts() -> Dict[str, int]:
    return {name: getattr(w, attr) for name, (w, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for w, attr in _COUNTERS.values():
        setattr(w, attr, 0)
