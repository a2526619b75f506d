"""The benchmark's inputs, made from ``--seed``: the weights and the token
batches.  Both sides of a comparison get them from here.

Weights: one normal draw on the device for every drawn leaf together, cut
at two standard deviations, each leaf its slice times its standard
deviation in its stored type; norm scales are ones.  The same seed and
sizes give the same weights on the same kind of device.

Batches: the synthetic language-model stream of the paper's training jobs
(a copy of its recurrence): each row starts at a random token and follows
t[i+1] = (a * t[i] + b) mod V, with a share ``p_noise`` of positions
replaced by random tokens; labels are the tokens shifted by one.  Batch
``step`` comes from a generator seeded with (seed << 20) ^ step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def draw_weights(specs: Dict[Tuple[str, ...], tuple], seed: int, device) -> dict:
    """A nested dict of leaves drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 63))
    n = sum(int(np.prod(shape)) for shape, _, std in specs.values() if std)
    buf = torch.empty(n, dtype=torch.float32, device=dev).normal_(generator=gen).clamp_(-2.0, 2.0)
    tree: dict = {}
    off = 0
    for path, (shape, dtype, std) in specs.items():
        numel = int(np.prod(shape))
        if std:
            leaf = (buf[off:off + numel].view(shape) * std).to(dtype)
            off += numel
        else:
            leaf = torch.ones(shape, dtype=dtype, device=dev)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    del buf
    return tree


def token_batches(seed: int, steps, batch: int, seq: int, vocab: int, *, a: int = 31, b: int = 7,
                  p_noise: float = 0.1) -> np.ndarray:
    """(len(steps), batch, seq + 1) int64 token rows of the given steps."""
    steps = list(steps)
    toks = np.empty((len(steps), batch, seq + 1), np.int64)
    noise = np.empty((len(steps), batch, seq), bool)
    rand = np.empty((len(steps), batch, seq), np.int64)
    for i, step in enumerate(steps):
        rng = np.random.default_rng((seed << 20) ^ step)
        toks[i, :, 0] = rng.integers(0, vocab, size=batch)
        noise[i] = rng.random((batch, seq)) < p_noise
        rand[i] = rng.integers(0, vocab, size=(batch, seq))
    for j in range(seq):
        nxt = (a * toks[:, :, j] + b) % vocab
        toks[:, :, j + 1] = np.where(noise[:, :, j], rand[:, :, j], nxt)
    return toks


class Batches:
    """``batch(step)`` for a trainer: a pool of ``pool`` batches made once on
    the device, batch ``step`` being pool entry ``step % pool`` (the stream
    repeats after ``pool`` steps, as an epoch does)."""

    def __init__(self, seed: int, mix: dict, vocab: int, device):
        rows = token_batches(seed % (1 << 62), range(mix["pool"]), mix["batch"], mix["seq"], vocab,
                             a=mix["a"], b=mix["b"], p_noise=mix["p_noise"])
        t = torch.from_numpy(rows.astype(np.int32)).to(device)
        self.tokens, self.labels = t[:, :, :-1].contiguous(), t[:, :, 1:].contiguous()
        self.pool = mix["pool"]

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        i = step % self.pool
        return {"tokens": self.tokens[i], "labels": self.labels[i]}
