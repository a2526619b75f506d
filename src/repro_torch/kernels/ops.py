"""Kernel dispatch by the input tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor takes the hand-written kernel, or the call raises.  There is no
override and no fallback.  ``launch_counts`` reads the kernels' launch
counters (``launch.<name>`` in ``repro_torch.spans``' registry);
``reset_launch_counts`` sets them to 0.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import spans
from repro_torch.kernels import decide as dc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ref
from repro_torch.parallel.compat import DTensor, Replicate, Shard

# the kernels whose wrappers count their launches, as ``launch.<name>``
LAUNCHES = ("flash_attention", "flash_attention_bf16", "flash_attention_bwd",
            "flash_attention_bwd_bf16", "quantize_int8", "dequantize_int8", "decide_dest",
            "grouped_gemm", "moe_rows")


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
    differentiates the plain version.

    DTensor inputs (a mesh) run the same local computation on each rank's
    shard: ``_local_qkv_placements`` first redistributes q, k and v so that
    the attention math is local, and the output has q's placements."""
    if isinstance(q, DTensor):
        return _flash_attention_sharded(q, k, v, mask_kind=mask_kind, window=window,
                                        attn_softcap=attn_softcap)
    if _on_card(q):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return fa.FlashAttentionFn.apply(q, k, v, mask_kind, window, attn_softcap)
        return fa.flash_attention_cuda(q, k, v, mask_kind=mask_kind, window=window,
                                       attn_softcap=attn_softcap)
    return ref.flash_attention_ref(q, k, v, mask_kind=mask_kind, window=window,
                                   attn_softcap=attn_softcap)


def _local_qkv_placements(q: DTensor, nkv: int) -> tuple:
    """Placements of q, k and v under which attention is local: the batch
    (dim 0) may stay sharded, the query heads (dim 2) too where the kv
    heads split over the same mesh dims into whole groups; the sequence,
    head_dim and any pending sum are replicated (a sequence-sharded q is
    gathered, as XLA gathers around the reference's Pallas call)."""
    mesh = q.device_mesh
    heads = [i for i, pl in enumerate(q.placements) if isinstance(pl, Shard) and pl.dim == 2]
    n = 1
    for i in heads:
        n *= mesh.size(i)
    keep = {0, 2} if nkv % n == 0 else {0}
    return tuple(pl if isinstance(pl, Shard) and pl.dim in keep else Replicate()
                 for pl in q.placements)


def _flash_attention_sharded(q, k, v, **kw):
    mesh = q.device_mesh
    want = _local_qkv_placements(q, k.shape[2])
    q, k, v = (x.redistribute(mesh, want) if tuple(x.placements) != want else x
               for x in (q, k, v))
    out = flash_attention(q.to_local().contiguous(), k.to_local().contiguous(),
                          v.to_local().contiguous(), **kw)
    return DTensor.from_local(out, mesh, want, run_check=False)


def _plain(x: torch.Tensor, name: str) -> None:
    if isinstance(x, DTensor):
        raise TypeError(f"{name} takes a plain tensor: quantize a DTensor's local shard "
                        "(optim/grad_compress.py) or its full value (checkpoints)")


def quantize_int8(x: torch.Tensor, *, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    _plain(x, "quantize_int8")
    if _on_card(x):
        return qz.quantize_int8_cuda(x, block=block)
    return ref.quantize_int8_ref(x, block=block)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    _plain(q, "dequantize_int8")
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


def grouped_mlp(xs: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                offsets: torch.Tensor, *, act: str, num_experts: int) -> torch.Tensor:
    """The routed experts' SwiGLU MLP (K5) on rows sorted by expert: group
    e (of this block's ``wg.shape[0]`` experts of ``num_experts``) takes
    rows ``offsets[e]:offsets[e + 1]``; rows outside every group give 0.
    On the card, and on fake tensors (the dry-run), ``GroupedMLPFn``: K5
    forward and backward; on the CPU the plain version, differentiated by
    autograd in its backward.  Either way the tensors kept for the backward
    have the buffer's shapes, not a group's, so a remat rerun that routes
    otherwise recomputes tensors of the same shapes."""
    if isinstance(xs, FakeTensor) or _on_card(xs):
        save = torch.is_grad_enabled() and any(t.requires_grad for t in (xs, wg, wi, wo))
        return gg.GroupedMLPFn.apply(xs, wg, wi, wo, offsets, act, num_experts, save)
    return _GroupedMLPRef.apply(xs, wg, wi, wo, offsets, act)


class _GroupedMLPRef(torch.autograd.Function):
    """``ref.grouped_mlp_ref`` forward, its autograd backward."""

    @staticmethod
    def forward(ctx, xs, wg, wi, wo, offsets, act: str):
        ctx.save_for_backward(xs, wg, wi, wo, offsets)
        ctx.act = act
        return ref.grouped_mlp_ref(xs, wg, wi, wo, offsets, act=act)

    @staticmethod
    def backward(ctx, dout):
        grads = ref.grouped_mlp_bwd_ref(dout, *ctx.saved_tensors, act=ctx.act)
        return (*grads, None, None)


def moe_rows_sum(src: torch.Tensor, inv: torch.Tensor, w, k: int) -> torch.Tensor:
    """(tokens, d): each token's k rows of ``src`` at ``inv``, weighted by
    its float32 gates ``w`` (or 1 where None), summed in float32 and rounded
    once: the MoE's combine, and its gather's backward."""
    if isinstance(src, FakeTensor) or _on_card(src):
        return gg.moe_rows_sum_cuda(src, inv, w, k)
    return ref.moe_rows_sum_ref(src, inv, w, k)


def moe_combine_bwd(src: torch.Tensor, dy: torch.Tensor, inv: torch.Tensor,
                    w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gated ``moe_rows_sum``'s backward: (d src, d w)."""
    if isinstance(src, FakeTensor) or _on_card(src):
        return gg.moe_combine_bwd_cuda(src, dy, inv, w)
    return ref.moe_combine_bwd_ref(src, dy, inv, w)


def launch_counts() -> Dict[str, int]:
    counted = spans.counts()
    return {name: counted.get("launch." + name, 0) for name in LAUNCHES}


def reset_launch_counts() -> None:
    spans.reset("launch.")
