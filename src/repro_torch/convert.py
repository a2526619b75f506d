"""Param trees across the package boundary, and tree helpers.

A param tree is nested dicts of tensors.  The port keeps the JAX package's
tree: the same keys, the stacked ``groups`` axis, ``wq`` as (d, nh, hd) and
``wo`` as (nh, hd, d).  So leaf paths and shapes match at this boundary,
for the tests and for GRNCKPT1 checkpoints.

``params_from_numpy`` takes the JAX package's tree as numpy arrays
(``jax.tree.map(np.asarray, params)``); ``params_to_numpy`` gives it back.
``train_state_from_numpy`` / ``train_state_to_numpy`` do the same for a
whole training state, the trainers' ``state_tree()``: ``{"params", "opt":
{"step", "master", "m", "v"}, "step"}``.  Leaves are ordered as jax
flattens a dict: keys sorted at every level.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve


def tree_map(fn: Callable[[Any], Any], tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree, _path=()):
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _path + (str(k),)) for k, v in tree.items()}
    return fn(_path, tree)


def flatten_with_paths(tree, _path=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in jax's dict flatten order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_paths(tree[k], _path + (str(k),)))
        return out
    return [(_path, tree)]


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def params_from_numpy(tree, device: DeviceLike = None) -> dict:
    dev = resolve(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def params_to_numpy(tree) -> dict:
    """Host copy of a tree (the gather before a checkpoint is written)."""
    return tree_map(to_numpy, tree)


def train_state_from_numpy(state, device: DeviceLike = None) -> dict:
    """A training state as numpy (e.g. ``jax.tree.map(np.asarray,
    trainer.state_tree())``) onto ``device``: params and optimizer state as
    tensors (``opt["step"]`` a 0-d int32 tensor), the top-level ``step`` as
    an int."""
    return {"params": params_from_numpy(state["params"], device),
            "opt": params_from_numpy(state["opt"], device),
            "step": int(state["step"])}


def train_state_to_numpy(state) -> dict:
    """Host copy of a training state; ``step`` as ``np.int32``, as the
    reference's ``state_tree()`` holds it."""
    return {"params": params_to_numpy(state["params"]), "opt": params_to_numpy(state["opt"]),
            "step": np.int32(state["step"])}
