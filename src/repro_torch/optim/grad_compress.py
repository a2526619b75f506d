"""Gradient compression for the cross-pod data-parallel reduction (port of
``repro/optim/grad_compress.py``): the paper's §VIII 'periodic
synchronization of compressed model deltas' applied to the gradient path.

``compress_roundtrip(grads)`` quantizes and dequantizes every float leaf of
at least one 256-element block through ``kernels/ops`` (K2 and K3 on the
card, one launch each per leaf), padding it to the block as the reference
does: it models the int8 traffic's loss.  The cross-pod all-gather needs
a mesh with a pod axis, which the port does not have yet.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.convert import tree_map
from repro_torch.kernels import ops as kops

BLOCK = 256


def _quant_leaf(g: torch.Tensor):
    flat = g.to(torch.float32).reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, (-n) % BLOCK)).contiguous()
    q, s = kops.quantize_int8(flat, block=BLOCK)
    return q, s, n


def _dequant_leaf(q, s, n, shape, dtype):
    flat = kops.dequantize_int8(q, s, block=BLOCK)
    return flat[:n].reshape(shape).to(dtype)


def compress_roundtrip(grads: Any) -> Any:
    """Quantize->dequantize every floating leaf (models int8 DCN traffic);
    leaves under one block and non-float leaves pass through."""

    def f(g):
        if not g.is_floating_point() or g.numel() < BLOCK:
            return g
        q, s, n = _quant_leaf(g)
        return _dequant_leaf(q, s, n, g.shape, g.dtype)

    return tree_map(f, grads)


def crosspod_allgather_mean_int8(grads: Any, axis_name: str = "pod") -> Any:
    raise NotImplementedError(
        "crosspod_allgather_mean_int8 needs shard_map over a pod mesh axis; the port's "
        "sharding layer is not ported yet (ROADMAP Queue 1, item 12)")
