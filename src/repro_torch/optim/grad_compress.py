"""Gradient compression for the cross-pod data-parallel reduction (port of
``repro/optim/grad_compress.py``): the paper's §VIII 'periodic
synchronization of compressed model deltas' applied to the gradient path.

``compress_roundtrip(grads)`` quantizes and dequantizes every float leaf of
at least one 256-element block through ``kernels/ops`` (K2 and K3 on the
card, one launch each per leaf), padding it to the block as the reference
does: it models the int8 traffic's loss.  On DTensor grads it works on
each rank's local shard.

``crosspod_allgather_mean_int8(grads, mesh, axis_name="pod")`` is the
cross-pod reduction itself: each leaf is quantized on this rank (K2), the
int8 payload and its scales are all-gathered over the mesh dim ``pod``,
and every pod's slice is dequantized (K3), summed and divided by the pod
count.  DCN bytes per pod are (P-1)/P · size/4 of a float32 ring
all-reduce.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from repro_torch.convert import tree_map
from repro_torch.kernels import ops as kops
from repro_torch.parallel.compat import DTensor, DeviceMesh
from repro_torch.parallel.shards import wrap_like

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
        if isinstance(g, DTensor):
            return wrap_like(f(g.to_local()), g)
        if not g.is_floating_point() or g.numel() < BLOCK:
            return g
        q, s, n = _quant_leaf(g)
        return _dequant_leaf(q, s, n, g.shape, g.dtype)

    return tree_map(f, grads)


def crosspod_allgather_mean_int8(grads: Any, mesh: DeviceMesh, axis_name: str = "pod") -> Any:
    """The mean over the pods of ``mesh``'s ``axis_name`` dim of each rank's
    grads (plain tensors, or DTensors by their local shards) by int8
    all-gather: quantize the local leaf, all-gather the payload and the
    scales over the pod group, dequantize each pod's slice, sum, divide by
    the pod count.  Leaves that are not float, or shorter than one block,
    take an all-reduce mean."""
    dim = mesh.mesh_dim_names.index(axis_name)
    group = (mesh, dim)
    npods = mesh.size(dim)

    def f(g):
        if isinstance(g, DTensor):
            return wrap_like(f(g.to_local()), g)
        if not g.is_floating_point() or g.numel() < BLOCK:
            return funcol.wait_tensor(funcol.all_reduce(g, "sum", group)) / npods
        q, s, n = _quant_leaf(g)
        # plain tensors (waited), whose pointers the kernel may take
        qs = funcol.wait_tensor(funcol.all_gather_tensor(q, 0, group))  # (npods * padded,) int8
        ss = funcol.wait_tensor(funcol.all_gather_tensor(s, 0, group))
        acc = torch.zeros(q.shape, dtype=torch.float32, device=g.device)
        for p in range(npods):
            acc = acc + kops.dequantize_int8(qs[p * q.numel():(p + 1) * q.numel()],
                                             ss[p * s.numel():(p + 1) * s.numel()], block=BLOCK)
        return (acc[:n] / npods).reshape(g.shape).to(g.dtype)

    return tree_map(f, grads)
