"""whisper-tiny's encoder-decoder in the port on the CPU against the JAX
package, with the JAX package's weights carried across
(``convert.params_from_numpy``) and inputs (frame embeddings and tokens)
made with numpy from a seed: cross-attention, the reduced model's forward,
loss and every gradient, decode from the encoder's cross K / V, GRNCKPT1
bytes, and the launchers' refusals.

The reduced config has 1 encoder layer over 24 frames, 2 decoder layers,
d 64, 4 query heads over 2 kv heads of 16, LayerNorm and tanh-GELU, as in
the reference's ``reduced()``.

Tolerances: float32 on both sides, differing in the order of sums only:
attention outputs and logits 1e-5 (abs and rel), the repo's whole-model
standard; the loss 1e-6 relative; gradients 1e-4 of each leaf's largest
element (autograd and XLA's autodiff sum the backward's products in other
orders); decode against the reference's decode 1e-5, and against the
port's own teacher-forced forward at the reference's prefill / decode
tolerance, 2e-4 (``tests/test_models.py::test_prefill_decode_equivalence``).
bf16: the repo's bf16 tolerance, 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild_model
from repro_torch.checkpoint import serializer as ser
from repro_torch.configs import base, get_config
from repro_torch.convert import flatten_with_paths, params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.train.train_step import value_and_grad

ARCH = "whisper-tiny"
TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4
DECODE_TOL = 2e-4
BF16_TOL = 2e-2
MODES = ("full", "int8", "delta-int8")


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    host = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    # LayerNorm biases initialise to 0 in both packages: seeded nonzero
    # ones show a bias added in the wrong place, or not at all
    rng = np.random.default_rng(11)
    host = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype)
        if str(p[-1].key) == "bias" else a, host)
    return jcfg, jmodel, jax.tree.map(jnp.asarray, host), cfg, build_model(cfg), \
        params_from_numpy(host, "cpu"), host


@pytest.fixture(scope="module")
def reduced():
    return _pair()


def _batch(cfg, seed, b, s, labels=False):
    """frames ~ N(0, 1) (b, encoder_seq, d) and tokens (b, s); with
    ``labels``, labels with some -1 (masked)."""
    rng = np.random.default_rng(seed)
    out = {"frames": rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
           "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(-1, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# Cross-attention, LayerNorm, GELU
# ---------------------------------------------------------------------------


def test_cross_attention_matches_reference(reduced):
    """The first decoder layer's cross-attention over a raw encoder output
    and over its precomputed (k, v), and cross_kv itself."""
    cfg, host = reduced[3], reduced[6]
    p = {k: v[0] for k, v in host["dec_groups"]["cross_attn"].items()}
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jattn.apply_cross_attention(jp, jnp.asarray(x), jnp.asarray(enc))
    got = attn.apply_cross_attention(tp, torch.from_numpy(x), torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    jk, jv = jattn.cross_kv(jp, jnp.asarray(enc))
    k, v = attn.cross_kv(tp, torch.from_numpy(enc))
    for g, w in ((k, jk), (v, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    got_kv = attn.apply_cross_attention(tp, torch.from_numpy(x), (k, v))
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_layernorm_and_gelu_match_reference():
    """LayerNorm (scale, bias, eps 1e-6, the biased variance) and
    jax.nn.gelu's default tanh form, on whisper's width."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 7, 384)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(384).astype(np.float32),
         "bias": rng.standard_normal(384).astype(np.float32)}
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "layernorm")
    got = layers.apply_norm(params_from_numpy(p, "cpu"), torch.from_numpy(x), "layernorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    want = jlayers.activation("gelu")(jnp.asarray(x))
    got = layers.activation("gelu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------


def _param_count_gap(cfg) -> int:
    """What the JAX package's analytic ``param_count`` leaves out of the
    built tree: it counts each norm as one d-vector, but a LayerNorm has a
    scale and a bias (2 per encoder layer, 3 per decoder layer, the final
    norm), and it leaves out the encoder's final norm (scale and bias)."""
    return (2 * cfg.encoder_layers + 3 * cfg.num_layers + 1) * cfg.d_model + 2 * cfg.d_model


def test_config_copy_and_param_count_match_reference():
    for reduce in (False, True):
        j, t = jget_config(ARCH), get_config(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in t.__dataclass_fields__}
        assert base.param_count(t) == jbase.param_count(j)
    n = sum(x.numel() for _, x in flatten_with_paths(build_model(t).init(0, device="cpu")))
    jn = sum(x.size for x in jax.tree.leaves(jax.eval_shape(jbuild_model(j).init, jax.random.PRNGKey(0))))
    assert n == jn == base.param_count(t) + _param_count_gap(t)
    full = get_config(ARCH)
    assert base.param_count(full) == 53_740_800
    assert base.param_count(full) + _param_count_gap(full) == 53_749_632


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Same leaf paths, shapes and dtypes as the JAX init: embed,
    pos_embed, enc_groups, enc_norm, dec_groups (with cross_attn, norm3),
    final_norm."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    ours = [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flatten_with_paths(build_model(cfg).init(0, device="cpu"))]
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype)
    jp = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    theirs = [("/".join(str(k.key) for k in p), tuple(x.shape), str(x.dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert ours == theirs
    assert ("pos_embed/table", (32768, cfg.d_model), dtype) in ours


def test_forward_matches_reference(reduced):
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    jb, tb = _both(_batch(cfg, 1, 2, 40))
    want, jaux = jax.jit(jmodel.forward)(jparams, jb)
    got, aux = model.forward(params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert float(aux) == float(jaux) == 0.0
    enc = encdec.encode(params, tb["frames"], cfg)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jencdec.encode(jparams, jb["frames"], jcfg)),
                               atol=TOL, rtol=TOL)


def test_loss_and_grads_match_reference(reduced):
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    jb, tb = _both(_batch(cfg, 2, 2, 40, labels=True))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    (loss, m), grads = value_and_grad(model, params, tb, "full")
    for got, want in ((loss, jloss), (m["ce"], jm["ce"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=0)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    ours = flatten_with_paths(grads)
    assert [p for p, _ in ours] == [tuple(str(k.key) for k in p) for p, _ in jleaves]
    for (path, g), (_, w) in zip(ours, jleaves):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0,
                                   err_msg="/".join(path))


def test_decode_matches_reference_decode_and_the_forward(reduced):
    """encdec_init_cache (the encoder and each layer's cross K / V) and
    step-by-step decode against the reference's, its caches, and the
    port's own teacher-forced forward over the same tokens."""
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    S = 12
    jb, tb = _both(_batch(cfg, 3, 2, S))
    jcache = jencdec.encdec_init_cache(jparams, jb["frames"], jcfg, 2, S)
    cache = encdec.encdec_init_cache(params, tb["frames"], cfg, 2, S)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["cross"][name].numpy(), np.asarray(jcache["cross"][name]),
                                   atol=TOL, rtol=TOL)
    jstep = jax.jit(jmodel.decode_step)
    steps = []
    for i in range(S):
        want, jcache = jstep(jparams, jcache, {"token": jb["tokens"][:, i], "index": jnp.int32(i)})
        got, cache = model.decode_step(params, cache, {"token": tb["tokens"][:, i], "index": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        steps.append(got)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["self"][name].numpy(), np.asarray(jcache["self"][name]),
                                   atol=TOL, rtol=TOL)
    full, _ = model.forward(params, tb)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_init_cache_specs_match_reference():
    """Model.init_cache: zeros of the reference's cache shapes, cross K / V
    included."""
    cfg = get_config(ARCH).reduced()
    cache = build_model(cfg).init_cache(2, 12, device="cpu")
    jspecs, _ = jbuild_model(jget_config(ARCH).reduced()).cache_specs(2, 12)
    for part in ("self", "cross"):
        for name in ("k", "v"):
            assert tuple(cache[part][name].shape) == jspecs[part][name].shape
            assert not cache[part][name].any()


def test_bf16_forward_matches_reference():
    jcfg, jmodel, jparams, cfg, model, params, _ = _pair("bfloat16")
    jb, tb = _both(_batch(cfg, 6, 2, 24))
    want, _ = jax.jit(jmodel.forward)(jparams, jb)
    got, _ = model.forward(params, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_grnckpt1_bytes_identical_to_reference(mode):
    """The enc_groups / dec_groups tree in bf16: the same GRNCKPT1 bytes
    from both packages in every mode (delta-int8 against a perturbed
    base)."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype="bfloat16")
    host = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(4)
    jb = jax.tree.map(lambda a: (a.astype(np.float32) + rng.standard_normal(a.shape).astype(np.float32)
                                 * 1e-2).astype(a.dtype), host) if mode == "delta-int8" else None
    want = jser.to_bytes(jser.serialize_tree(host, mode=mode, base=jb))
    got = ser.to_bytes(ser.serialize_tree(params_from_numpy(host, "cpu"), mode=mode,
                                          base=params_from_numpy(jb, "cpu") if jb is not None else None,
                                          device="cpu"))
    assert got == want


def test_serve_refuses_whisper_as_the_reference():
    """Both launchers' serve demo takes decoder-only token models."""
    with pytest.raises(SystemExit) as want:
        jserve.main(["--arch", ARCH, "--smoke"])
    with pytest.raises(SystemExit) as got:
        serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert str(got.value) == str(want.value) == "serve demo targets token-input decoder-only archs"


def test_train_without_frames_raises_a_clear_error(reduced, tmp_path):
    """The synthetic LM stream has no frames: the reference's loss fails
    with a bare KeyError; the port's trainer says what is missing."""
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    toks = _batch(cfg, 5, 2, 8)["tokens"]
    with pytest.raises(KeyError, match="frames"):
        jmodel.loss(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    with pytest.raises(ValueError, match="needs 'frames'"):
        train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                             "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
