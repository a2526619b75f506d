"""Train / eval steps (port of ``repro/train/train_step.py``): loss ->
grads -> (optional int8 compression of the grads) -> AdamW.  Functions of
(params, opt_state, batch) that return new trees, as in the reference;
eager PyTorch, with autograd in place of ``jax.value_and_grad``.

The batch may hold numpy arrays (``SyntheticLMDataset.batch``) or tensors;
it is moved to the params' device.  On DTensor params (a mesh) the step
runs on DTensors: a plain batch counts as replicated, a DTensor batch
(``SyntheticLMDataset.sharded_batch``) keeps its placements.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

from repro_torch import spans
from repro_torch.convert import flatten_with_paths, tree_map, tree_map_with_path
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig, apply_updates
from repro_torch.optim.grad_compress import compress_roundtrip
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.parallel.shards import mesh_scope


@dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    remat_policy: str = "full"
    grad_compress: bool = False  # int8 round-trip on grads (cross-pod DCN model)
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatch: int = 0  # >1: gradient accumulation over that many micro-batches


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _params_device(params) -> torch.device:
    return flatten_with_paths(params)[0][1].device


def value_and_grad(model: Model, params, batch, remat_policy: str):
    """((loss, metrics), grads) of ``model.loss`` at ``params``: the
    counterpart of ``jax.value_and_grad(..., has_aux=True)``.  The params
    themselves are left as they are (autograd runs on detached leaves).  A
    leaf the loss does not reach (the embedding table when the batch holds
    'embeds') gets a zero gradient, as JAX gives it.  Runs in the span
    ``train.fwd_bwd``."""
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    # grad on: remat reruns the forward in the backward
    with spans.span("train.fwd_bwd"), torch.enable_grad(), mesh_scope(params):
        loss, metrics = model.loss(live, batch, remat_policy=remat_policy)
        paths, leaves = zip(*flatten_with_paths(live))
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {p: torch.zeros_like(x) if g is None else g
                 for p, x, g in zip(paths, leaves, got)}
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map_with_path(lambda path, _: grads[path], params))


def make_train_step(model: Model, cfg: TrainStepConfig) -> Callable:
    def train_step(params, opt_state, batch):
        with mesh_scope(params):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        dev = _params_device(params)
        batch = _to_device(batch, dev)
        if cfg.microbatch and cfg.microbatch > 1:
            n = cfg.microbatch
            micro = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
                     for i in range(n)]
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in micro:
                (l, metrics), g = value_and_grad(model, params, mb, cfg.remat_policy)
                g_of = dict(flatten_with_paths(g))
                gsum = tree_map_with_path(lambda path, x: x + g_of[path], gsum)
                lsum = lsum + l
            nf = torch.full((), n, dtype=torch.float32, device=dev)  # IEEE division on the card
            grads = tree_map(lambda x: x / nf, gsum)
            loss = lsum / nf
        else:
            (loss, metrics), grads = value_and_grad(model, params, batch, cfg.remat_policy)
        if cfg.grad_compress:
            with spans.span("train.grad_compress"):
                grads = compress_roundtrip(grads)
        lr_scale = cosine_schedule(opt_state["step"] + 1, warmup=cfg.warmup_steps,
                                   total=cfg.total_steps)
        params, opt_state, om = apply_updates(params, grads, opt_state, cfg.opt, lr_scale)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_eval_step(model: Model, remat_policy: str = "none") -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, _to_device(batch, _params_device(params)),
                                       remat_policy=remat_policy)
        return {"loss": loss, **metrics}

    return eval_step
