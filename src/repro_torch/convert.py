"""Param trees across the package boundary, and tree helpers.

A param tree is nested dicts of tensors.  The port keeps the JAX package's
tree: the same keys, the stacked ``groups`` axis, ``wq`` as (d, nh, hd) and
``wo`` as (nh, hd, d).  So leaf paths and shapes match at this boundary,
for the tests and for GRNCKPT1 checkpoints.

``params_from_numpy`` takes the JAX package's tree as numpy arrays
(``jax.tree.map(np.asarray, params)``); ``params_to_numpy`` gives it back.
numpy has no bfloat16 of its own: an array whose ``dtype.name`` is
``"bfloat16"`` (the JAX package's, from ``ml_dtypes``, which the port never
imports) crosses as its raw 16-bit words, and ``params_to_numpy`` keeps a
bfloat16 leaf as a CPU tensor.  ``host_words`` gives any leaf to the
checkpoint codec as a numpy array and its dtype name, a bfloat16 leaf as
its 16-bit words.
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


BF16 = "bfloat16"


def _is_bf16(a) -> bool:
    """A bfloat16 tensor, or a numpy array of the JAX package's bfloat16."""
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.bfloat16
    return getattr(getattr(a, "dtype", None), "name", None) == BF16


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_words(x) -> Tuple[np.ndarray, str]:
    """(host array, dtype name) of a leaf: a bfloat16 leaf, tensor or JAX
    numpy array, as its raw 16-bit words (uint16) under ``"bfloat16"``,
    any other as itself under numpy's name for its dtype."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.detach().cpu().view(torch.int16).numpy().view(np.uint16), BF16
    if _is_bf16(x):
        return np.asarray(x).view(np.uint16), BF16
    a = _to_numpy(x)
    return a, str(a.dtype)


def bf16_words_to_f32(words: np.ndarray) -> np.ndarray:
    """bfloat16 words widened to float32, exactly (the high half of the word)."""
    return (words.astype(np.uint32) << 16).view(np.float32)


def bf16_from_words(words: np.ndarray) -> torch.Tensor:
    """A CPU bfloat16 tensor of the given 16-bit words (a copy)."""
    return torch.from_numpy(np.array(words, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)


def _leaf_to_tensor(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(dev, copy=True)
    if _is_bf16(a):
        return bf16_from_words(np.asarray(a).view(np.uint16)).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(tree, device: DeviceLike = None) -> dict:
    """A host tree (numpy arrays, the JAX package's bfloat16 among them, or
    CPU tensors) onto ``device``, bit for bit."""
    dev = resolve(device)
    return tree_map(lambda a: _leaf_to_tensor(a, dev), tree)


def _host(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return x.detach().cpu()
    return _to_numpy(x)


def params_to_numpy(tree) -> dict:
    """Host copy of a tree (the gather before a checkpoint is written):
    numpy arrays, and a bfloat16 leaf as a CPU tensor."""
    return tree_map(_host, tree)


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
