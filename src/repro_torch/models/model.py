"""Model façade (port of ``repro/models/model.py``): ``build_model(cfg)``
gives a ``Model`` with init / loss / forward / decode_step / init_cache,
for decoder-only LMs and hybrids (``models/transformer.py``) and the
whisper encoder-decoder (``models/encdec.py``).

``Model`` is a ``torch.nn.Module`` that holds no parameters: like the JAX
package it takes the param tree as an argument, so one tree serves both
sites of a migration and round-trips through GRNCKPT1 unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm


class Model(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def init(self, seed: int = 0, *, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> dict:
        """Random params from ``seed`` (or an explicit ``generator``, which
        draws them on its own device), placed on ``device`` (default: the
        card).  A CPU generator gives the same params on every device; one
        on the card draws a full-width model there in well under a second."""
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        if self.cfg.is_encdec:
            return encdec_lib.init_encdec(gen, self.cfg, resolve(device))
        return tfm.init_lm(gen, self.cfg, resolve(device))

    def loss(self, params: dict, batch: dict, *, remat_policy: str = "full"):
        """(loss, {"ce", "aux"}) for batch = {'tokens' or 'embeds',
        'labels', optionally 'positions'} (an encoder-decoder: {'frames',
        'tokens', 'labels'}), with autograd on: the training path."""
        if self.cfg.is_encdec:
            return encdec_lib.encdec_loss(params, batch, self.cfg, remat_policy=remat_policy)
        return tfm.lm_loss(params, batch, self.cfg, remat_policy=remat_policy)

    @torch.inference_mode()
    def forward(self, params: dict, batch: dict):
        """(logits (b, s, vocab), aux) for batch = {'tokens': (b, s)} or
        {'embeds': (b, s, d)}, optionally with 'positions' (b, s) or, for
        M-RoPE, (b, s, 3) t / h / w ids; an encoder-decoder takes
        {'frames': (b, t, d), 'tokens': (b, s)}."""
        if self.cfg.is_encdec:
            return encdec_lib.encdec_forward(params, batch, self.cfg)
        return tfm.lm_forward(params, batch, self.cfg)

    @torch.inference_mode()
    def decode_step(self, params: dict, cache: dict, batch: dict):
        """(logits (b, vocab), cache) for batch = {'token': (b,) or
        'embeds': (b, 1, d), 'index': int, optionally 'positions' (b, 1) or
        (b, 1, 3)}; the cache is updated in place.  An encoder-decoder's
        cache comes from ``encdec.encdec_init_cache`` (the encoder's
        output's cross K / V)."""
        if self.cfg.is_encdec:
            return encdec_lib.encdec_decode_step(params, cache, batch, self.cfg)
        return tfm.lm_decode_step(params, cache, batch, self.cfg)

    def cache_specs(self, batch: int, max_len: int) -> dict:
        if self.cfg.is_encdec:
            return encdec_lib.encdec_cache_specs(self.cfg, batch, max_len)
        return tfm.cache_specs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, *, device: DeviceLike = None) -> dict:
        """The decode cache, all zeros as the JAX package's ``init_cache``
        makes it: a recurrent layer's state too (mLSTM m = 0 and sLSTM n = 0,
        not the -inf and 1e-6 its full-sequence form starts from), and an
        encoder-decoder's cross K / V."""
        return tfm.zeros_like_specs(self.cache_specs(batch, max_len), resolve(device))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
