"""Model façade (port of ``repro/models/model.py``): ``build_model(cfg)``
gives a ``Model`` with init / loss / forward / decode_step / init_cache.

``Model`` is a ``torch.nn.Module`` that holds no parameters: like the JAX
package it takes the param tree as an argument, so one tree serves both
sites of a migration and round-trips through GRNCKPT1 unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import transformer as tfm


class Model(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        tfm.check_ported(cfg)
        self.cfg = cfg

    def init(self, seed: int = 0, *, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """Random params from ``seed`` (or an explicit ``generator``, which
        draws them on its own device), placed on ``device`` (default: the
        card).  A CPU generator gives the same params on every device; one
        on the card draws a full-width model there in well under a second."""
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        return tfm.init_lm(gen, self.cfg, resolve(device))

    def loss(self, params: dict, batch: dict, *, remat_policy: str = "full"):
        """(loss, {"ce", "aux"}) for batch = {'tokens', 'labels'}, with
        autograd on: the training path."""
        return tfm.lm_loss(params, batch, self.cfg, remat_policy=remat_policy)

    @torch.inference_mode()
    def forward(self, params: dict, batch: dict):
        """(logits (b, s, vocab), aux) for batch = {'tokens': (b, s)}."""
        return tfm.lm_forward(params, batch, self.cfg)

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, batch: dict):
        return tfm.lm_decode_step(params, cache, batch, self.cfg)

    def cache_specs(self, batch: int, max_len: int) -> dict:
        return tfm.cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, *, device: DeviceLike = None) -> dict:
        return tfm.init_cache(self.cfg, batch, max_len, resolve(device))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
