"""AdamW with mixed precision (port of ``repro/optim/adamw.py``): params in
their compute dtype, an f32 master copy and f32 moments, global-norm
clipping and weight decay.

Functional, as the reference: ``apply_updates`` returns new trees and
leaves its inputs as they are.  The optimizer state keeps the reference's
layout ``{"step", "master", "m", "v"}`` with ``step`` an int32 scalar, so
the GRNCKPT1 manifests of a training state match across the packages.
Every scalar of the update is a float32 tensor on the params' device (the
reference computes ``lr``, ``b1 ** step`` and ``b2 ** step`` in float32),
and every division is tensor by tensor (IEEE on the card too).

On DTensor params (a mesh) the state mirrors their placements: m, v and
master are made with ``zeros_like`` / ``to`` of each param, and ``step``
is replicated over the params' mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.convert import flatten_with_paths, tree_map, tree_map_with_path
from repro_torch.parallel.compat import DTensor, Replicate, distribute_tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_opt_state(params) -> Dict[str, Any]:
    leaf = flatten_with_paths(params)[0][1]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        step = distribute_tensor(step, mesh, (Replicate(),) * mesh.ndim, src_data_rank=None)
    return {
        "step": step,
        "master": tree_map(lambda x: x.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
        "v": tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves in the
    reference's order (keys sorted)."""
    leaves = [torch.sum(torch.square(x.float())) for _, x in flatten_with_paths(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def apply_updates(
    params,
    grads,
    state: Dict[str, Any],
    cfg: AdamWConfig,
    lr_scale=1.0,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params (compute dtype), new_state, metrics)."""
    dev = state["step"].device
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=dev)  # noqa: E731
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(f32(cfg.clip_norm) / torch.clamp(gnorm, min=1e-12), max=1.0)
    # a Python lr_scale becomes a device scalar by a fill, not a host copy
    # (a copy from the host would wait for the card)
    lr = (lr_scale.to(dev, torch.float32) if torch.is_tensor(lr_scale) else f32(lr_scale)) * cfg.lr
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(f32(cfg.b1), stepf)
    b2c = 1.0 - torch.pow(f32(cfg.b2), stepf)
    grad_of = dict(flatten_with_paths(grads))
    m_of, v_of = dict(flatten_with_paths(state["m"])), dict(flatten_with_paths(state["v"]))

    def upd(path, mp):
        g = grad_of[path].float() * scale
        m2 = cfg.b1 * m_of[path] + (1 - cfg.b1) * g
        v2 = cfg.b2 * v_of[path] + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * mp
        return m2, v2, mp - lr * delta

    out = tree_map_with_path(upd, state["master"])  # leaves: (m, v, master) tuples
    new_m, new_v, new_master = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    # A param of the master's dtype is the new master itself (no copy), as
    # in the reference; nothing updates either in place.
    master_of = dict(flatten_with_paths(new_master))
    new_params = tree_map_with_path(lambda path, p: master_of[path].to(p.dtype), params)
    new_state = {"step": step, "master": new_master, "m": new_m, "v": new_v}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
