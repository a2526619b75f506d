"""Deterministic, resumable synthetic LM data (port of
``repro/data/pipeline.py``; numpy, identical streams).

Tokens follow a noisy affine recurrence (t_{i+1} = (a·t_i + b) mod V with
p_noise random replacements) so a model can learn structure.  batch(step)
is a pure function of (seed, step), so a job restored from a step-K
checkpoint -- possibly at another site after a migration -- resumes the
exact token stream with no state file.  ``sharded_batch`` and
``make_global_batch`` place a host batch on a device mesh as DTensors,
each rank taking its shard of the same host arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.parallel.compat import DeviceMesh, DTensor, distribute_tensor
from repro_torch.parallel.sharding import placements


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

    def sharded_batch(self, step: int, mesh: DeviceMesh, spec) -> Dict[str, DTensor]:
        """``batch(step)`` as DTensors on ``mesh``, every leaf placed by the
        PartitionSpec ``spec``: its full value is ``batch(step)``."""
        return make_global_batch(self.batch(step), mesh, {k: spec for k in ("tokens", "labels")})


def make_global_batch(host_batch: Dict[str, np.ndarray], mesh: DeviceMesh,
                      specs) -> Dict[str, DTensor]:
    """A host batch (the same arrays on every rank) as DTensors on ``mesh``,
    leaf ``k`` placed by ``specs[k]``; each rank keeps only its shard (no
    collective)."""
    return {k: distribute_tensor(torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device_type),
                                 mesh, placements(specs[k], mesh), src_data_rank=None)
            for k, v in host_batch.items()}
