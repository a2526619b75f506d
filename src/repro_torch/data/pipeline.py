"""Deterministic, resumable synthetic LM data (port of
``repro/data/pipeline.py``; numpy, identical streams).

Tokens follow a noisy affine recurrence (t_{i+1} = (a·t_i + b) mod V with
p_noise random replacements) so a model can learn structure.  batch(step)
is a pure function of (seed, step), so a job restored from a step-K
checkpoint -- possibly at another site after a migration -- resumes the
exact token stream with no state file.  The mesh-sharded variants of the
JAX package wait for the port's sharding layer (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    a: int = 31
    b: int = 7
    p_noise: float = 0.1

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        noise = rng.random((B, S)) < self.p_noise
        rand = rng.integers(0, V, size=(B, S))
        for i in range(S):
            nxt = (self.a * toks[:, i] + self.b) % V
            toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
