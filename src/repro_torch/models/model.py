"""Model façade (port of ``repro/models/model.py``): ``build_model(cfg)``
gives a ``Model`` with init / loss / forward / decode_step / init_cache,
for decoder-only LMs and hybrids (``models/transformer.py``) and the
whisper encoder-decoder (``models/encdec.py``).

``Model`` is a ``torch.nn.Module`` that holds no parameters: like the JAX
package it takes the param tree as an argument, so one tree serves both
sites of a migration and round-trips through GRNCKPT1 unchanged.

``input_specs(shape_name)`` gives shape / dtype stand-ins and logical
partition specs for every input of an assigned shape (``configs.SHAPES``):
the mesh dry-run (``launch/dryrun.py``) places fake inputs by them.  A
param tree of DTensors (a mesh) runs through the same methods: plain
tensors made inside the model count as replicated
(``parallel/shards.mesh_scope``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.convert import tree_map
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import TensorSpec
from repro_torch.parallel.shards import mesh_scope


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
        with mesh_scope(params):
            if self.cfg.is_encdec:
                return encdec_lib.encdec_loss(params, batch, self.cfg, remat_policy=remat_policy)
            return tfm.lm_loss(params, batch, self.cfg, remat_policy=remat_policy)

    def forward(self, params: dict, batch: dict):
        """(logits (b, s, vocab), aux) for batch = {'tokens': (b, s)} or
        {'embeds': (b, s, d)}, optionally with 'positions' (b, s) or, for
        M-RoPE, (b, s, 3) t / h / w ids; an encoder-decoder takes
        {'frames': (b, t, d), 'tokens': (b, s)}."""
        with mesh_scope(params, inference=True):
            if self.cfg.is_encdec:
                return encdec_lib.encdec_forward(params, batch, self.cfg)
            return tfm.lm_forward(params, batch, self.cfg)

    def decode_step(self, params: dict, cache: dict, batch: dict, *,
                    long_context: bool = False):
        """(logits (b, vocab), cache) for batch = {'token': (b,) or
        'embeds': (b, 1, d), 'index': int, optionally 'positions' (b, 1) or
        (b, 1, 3)}; the cache is updated in place.  An encoder-decoder's
        cache comes from ``encdec.encdec_init_cache`` (the encoder's
        output's cross K / V).  ``long_context`` changes only the sharding
        of a DTensor cache, as in the reference."""
        with mesh_scope(params, inference=True):
            if self.cfg.is_encdec:
                return encdec_lib.encdec_decode_step(params, cache, batch, self.cfg)
            return tfm.lm_decode_step(params, cache, batch, self.cfg, long_context=long_context)

    def cache_specs(self, batch: int, max_len: int, long_context: bool = False):
        """(TensorSpec tree, logical-pspec tree) of the decode cache."""
        if self.cfg.is_encdec:
            return encdec_lib.encdec_cache_specs(self.cfg, batch, max_len)
        return tfm.cache_specs(self.cfg, batch, max_len, long_context)

    def init_cache(self, batch: int, max_len: int, *, device: DeviceLike = None) -> dict:
        """The decode cache, all zeros as the JAX package's ``init_cache``
        makes it: a recurrent layer's state too (mLSTM m = 0 and sLSTM n = 0,
        not the -inf and 1e-6 its full-sequence form starts from), and an
        encoder-decoder's cross K / V."""
        return tfm.zeros_like_specs(self.cache_specs(batch, max_len)[0], resolve(device))

    def input_specs(self, shape_name) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(TensorSpec tree, logical-axis pspec tree) for the given assigned
        shape (a name of ``SHAPES``, or a ``ShapeSpec``), the reference's.
        Decode shapes include the cache (under 'cache') and the position
        'index' (a 0-d int32)."""
        cfg = self.cfg
        shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
        B, S = shape.global_batch, shape.seq_len
        dt = getattr(torch, cfg.dtype)
        i32 = torch.int32
        long = shape.name == "long_500k"

        if shape.kind in ("train", "prefill"):
            specs: Dict[str, Any] = {}
            pspecs: Dict[str, Any] = {}
            if cfg.is_encdec:
                specs["frames"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model), dt)
                pspecs["frames"] = ("batch", None, None)
                specs["tokens"] = TensorSpec((B, S), i32)
                pspecs["tokens"] = ("batch", "seq")
            elif cfg.input_mode == "embeddings":
                specs["embeds"] = TensorSpec((B, S, cfg.d_model), dt)
                pspecs["embeds"] = ("batch", "seq", None)
            else:
                specs["tokens"] = TensorSpec((B, S), i32)
                pspecs["tokens"] = ("batch", "seq")
            if cfg.rope_type == "mrope":
                specs["positions"] = TensorSpec((B, S, 3), i32)
                pspecs["positions"] = ("batch", "seq", None)
            if shape.kind == "train":
                specs["labels"] = TensorSpec((B, S), i32)
                pspecs["labels"] = ("batch", "seq")
            return specs, pspecs

        # decode: one new token against a cache of size S
        cache_sds, cache_ps = self.cache_specs(B, S, long_context=long)
        specs = {"cache": cache_sds, "index": TensorSpec((), i32)}
        pspecs = {"cache": cache_ps, "index": ()}
        bax = None if long else "dp_batch"
        if cfg.input_mode == "embeddings" and not cfg.is_encdec:
            specs["embeds"] = TensorSpec((B, 1, cfg.d_model), dt)
            pspecs["embeds"] = (bax, None, None)
        else:
            specs["token"] = TensorSpec((B,), i32)
            pspecs["token"] = (bax,)
        if cfg.rope_type == "mrope":
            specs["positions"] = TensorSpec((B, 1, 3), i32)
            pspecs["positions"] = (bax, None, None)
        return specs, pspecs

    def dummy_batch(self, shape_name: str, *, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None):
        """A random batch matching ``input_specs``, drawn from ``generator``
        (default: a CPU generator seeded 0) and placed on ``device``: ids in
        [0, vocab) (a 0-d id, such as 'index', in [0, 2)), floats N(0, 1)."""
        specs, _ = self.input_specs(shape_name)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        dev = resolve(device)

        def draw(s: TensorSpec):
            if not s.dtype.is_floating_point:
                hi = self.cfg.vocab_size if s.shape else 1
                x = torch.randint(0, max(hi, 2), s.shape, generator=gen, device=gen.device,
                                  dtype=s.dtype)
            else:
                x = torch.randn(s.shape, generator=gen, device=gen.device).to(s.dtype)
            return x.to(dev)

        return tree_map(draw, specs)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
