"""The seven attention-family architectures (qwen3-1.7b, gemma2-2b,
granite-moe-1b-a400m, qwen2.5-32b, qwen1.5-32b, phi3.5-moe-42b-a6.6b and
qwen2-vl-7b) in the port on the CPU against the JAX package, at their
``reduced()`` sizes, with the JAX package's weights carried across
(``convert.params_from_numpy``) and inputs made with numpy from a seed.

The qkv biases initialise to zeros in both packages, so every pair here
first sets them to the same seeded nonzero values: a bias added in the
wrong place, or not at all, then shows.  qwen2-vl is fed embeddings and
three distinct position streams (a patch grid, then text), since one
stream repeated three times rotates every M-RoPE section by the same angle
and is plain RoPE.

Tolerances: float32 on both sides, differing only in the order of sums:
logits and MoE outputs 1e-5; the loss 1e-6 relative; gradients 1e-4 of
each leaf's largest element (autograd and XLA's autodiff sum the
backward's products in other orders, over two to four layers).  Decode
against the reference's decode 1e-5 as the dense model's
(tests/test_torch_models.py).  bf16: the repo's bf16 tolerance, 2e-2.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import base, get_config
from repro_torch.convert import flatten_with_paths, params_from_numpy
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.train.train_step import value_and_grad

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from chip_smoke import mrope_positions  # noqa: E402

ARCHS = ("qwen3-1.7b", "gemma2-2b", "granite-moe-1b-a400m", "qwen2.5-32b", "qwen1.5-32b",
         "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b")
TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
# The reference's own prefill-vs-decode tolerance
# (tests/test_models.py::test_prefill_decode_equivalence).
DECODE_TOL = 2e-4


# seeded qkv biases: std 0.5, near the size of a reduced model's projections
BIAS_STD = 0.5


def _with_biases(tree, seed=11):
    """``tree`` (numpy leaves) with every qkv bias set to seeded nonzero
    values."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bq", "bk", "bv"):
                out[k] = (rng.standard_normal(v.shape) * BIAS_STD).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree)


def _pair(arch, dtype="float32"):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    host = _with_biases(jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))))
    jparams = jax.tree.map(jnp.asarray, host)
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params_from_numpy(host, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def reduced(request):
    return _pair(request.param)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _inputs(cfg, seed, b, s):
    """{name: numpy array}: tokens, or for an embeddings-input model
    embeddings and (b, s, 3) positions of a 2 x 3 patch grid then text."""
    if cfg.input_mode != "embeddings":
        return {"tokens": _tokens(seed, b, s, cfg.vocab_size)}
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
            "positions": mrope_positions(b, 2, 3, s - 6).numpy().astype(np.int32)}


def _both(batch):
    """(the JAX package's batch, the port's) of a numpy batch."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_param_count_match_reference(arch):
    for reduce in (False, True):
        j, t = jget_config(arch), get_config(arch)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in t.__dataclass_fields__}
        assert base.param_count(t) == jbase.param_count(j)
        assert base.active_param_count(t) == jbase.active_param_count(j)
    n = sum(x.numel() for _, x in flatten_with_paths(build_model(t).init(0, device="cpu")))
    assert n == base.param_count(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch, dtype):
    """Same leaf paths, shapes and dtypes as the JAX init (the MoE router in
    float32 in a bf16 model), so checkpoints line up."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    ours = [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flatten_with_paths(build_model(cfg).init(0, device="cpu"))]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    jp = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    theirs = [("/".join(str(k.key) for k in p), tuple(x.shape), str(x.dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert ours == theirs
    if cfg.moe:
        assert ("groups/b0/moe/router", (cfg.num_groups, 64, 4), "float32") in ours
    assert any(p.endswith("attn/bq") for p, _, _ in ours) == cfg.qkv_bias


def test_forward_matches_reference(reduced):
    jcfg, jmodel, jparams, cfg, model, params = reduced
    jb, tb = _both(_inputs(cfg, 1, 2, 40))  # 40 > gemma2's reduced window of 16
    want, jaux = jmodel.forward(jparams, jb)
    got, aux = model.forward(params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=0)
    assert (float(aux) > 0) == cfg.moe


def test_loss_and_grads_match_reference(reduced):
    """lm_loss (ce and aux) and every gradient against jax.value_and_grad
    (qwen2-vl's embedding table, which embeddings never reach, at 0 on
    both)."""
    jcfg, jmodel, jparams, cfg, model, params = reduced
    toks = _tokens(2, 2, 40, cfg.vocab_size + 1) - 1  # some labels -1: masked
    batch = {**_inputs(cfg, 2, 2, 40), "labels": toks}
    if "tokens" in batch:
        batch["tokens"] = np.clip(toks, 0, None)
    jb, tb = _both(batch)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    (loss, m), grads = value_and_grad(model, params, tb, "full")
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]), (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=0)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    ours = flatten_with_paths(grads)
    assert [p for p, _ in ours] == [tuple(str(k.key) for k in p) for p, _ in jleaves]
    for (path, g), (_, w) in zip(ours, jleaves):
        w = np.asarray(w)
        if "embeds" in batch and path == ("embed", "table"):
            assert not g.any() and not w.any()
            continue
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0,
                                   err_msg="/".join(path))


def test_decode_matches_reference_decode(reduced):
    """Below the window, step-by-step decode equals the reference's decode
    and its cache; qwen2-vl's steps take embeddings and (b, 1, 3)
    positions."""
    jcfg, jmodel, jparams, cfg, model, params = reduced
    S = 12
    inp = _inputs(cfg, 3, 2, S)
    jcache = jmodel.init_cache(2, S)
    cache = model.init_cache(2, S, device="cpu")
    jstep = jax.jit(jmodel.decode_step)
    for i in range(S):
        if "tokens" in inp:
            jb, tb = _both({"token": inp["tokens"][:, i]})
        else:
            jb, tb = _both({"embeds": inp["embeds"][:, i:i + 1],
                            "positions": inp["positions"][:, i:i + 1]})
        want, jcache = jstep(jparams, jcache, {**jb, "index": jnp.int32(i)})
        got, cache = model.decode_step(params, cache, {**tb, "index": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for blk in cache:
        np.testing.assert_allclose(cache[blk]["k"].numpy(), np.asarray(jcache[blk]["k"]),
                                   atol=TOL, rtol=TOL)


def test_gemma2_decode_past_window_matches_reference_forward():
    """Decode over 28 positions with the reduced window of 16: the local
    layers' cache is a ring of 16 slots.  Held against the reference's
    full-sequence lm_forward, not its decode: the reference's decode writes
    every position past 15 into the last slot (dynamic_update_slice clamps),
    so from index 16 on it drops the wrong keys and leaves lm_forward
    (1.9e-3 at index 16).  2e-4: the reference's own prefill-vs-decode
    tolerance."""
    jcfg, jmodel, jparams, cfg, model, params = _pair("gemma2-2b")
    S = 28
    assert cfg.sliding_window == 16 < S
    toks = _tokens(4, 2, S, cfg.vocab_size)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    cache = model.init_cache(2, S, device="cpu")
    assert cache["b0"]["k"].shape[2] == 16 and cache["b1"]["k"].shape[2] == S
    steps = []
    for i in range(S):
        lg, cache = model.decode_step(params, cache, {"token": torch.from_numpy(toks[:, i]), "index": i})
        steps.append(lg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), np.asarray(want),
                               atol=DECODE_TOL, rtol=DECODE_TOL)


@pytest.mark.parametrize("impl,s", [("dense", 40), ("capacity", 64), ("capacity", 512)])
def test_moe_matches_reference(impl, s):
    """apply_moe (dense dispatch) and apply_moe_capacity (one block, and two
    blocks of 256 where capacity drops tokens) against the reference's."""
    rng = np.random.default_rng(5)
    d, f, E, k = 64, 32, 4, 2
    p = {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.3,
         "wi": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
         "wg": rng.standard_normal((E, d, f)).astype(np.float32) * 0.1,
         "wo": rng.standard_normal((E, f, d)).astype(np.float32) * 0.1}
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    if impl == "dense":
        want = jmoe.apply_moe({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                              top_k=k, act="silu", impl="dense")
        got = moe.apply_moe(params_from_numpy(p, "cpu"), torch.from_numpy(x), top_k=k, act="silu")
    else:
        want = jmoe.apply_moe_capacity({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                                       top_k=k, act="silu")
        got = moe.apply_moe_capacity(params_from_numpy(p, "cpu"), torch.from_numpy(x), top_k=k,
                                     act="silu")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=TOL, atol=0)


def test_topk_stable_breaks_ties_to_the_lower_index():
    x = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.0, 0.0]])
    vals, idx = moe.topk_stable(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 3, 0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    """The reduced model in bf16 (the MoE router in float32), the JAX
    package's bf16 weights carried across bit for bit."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, "bfloat16")
    assert all(x.dtype == (torch.float32 if p[-1] == "router" else torch.bfloat16)
               for p, x in flatten_with_paths(params))
    jb, tb = _both(_inputs(cfg, 6, 2, 24))
    want, _ = jmodel.forward(jparams, jb)
    got, _ = model.forward(params, tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


def use_plain_stand_ins(monkeypatch, tmp_path):
    """chip_smoke, imported, with the kernels' wrappers swapped for their
    plain versions, counting as the kernels do, and the card's timers,
    profiler and synchronisation stubbed, so that a phase the card runs at
    full width runs on the CPU at the reduced sizes.  The plain versions
    stand in computed in float32 and rounded to the inputs' type, as the
    kernels keep their scores in float32: the phases hold K1 to the float32
    plain version on inputs whose scores bf16 cannot carry."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, quantize as qz, ref

    def counting(wrapper, attr, plain):
        def call(*args, **kw):
            bf16 = args[0].dtype == torch.bfloat16 and hasattr(wrapper, attr + "_bf16")
            name = attr + "_bf16" if bf16 else attr
            setattr(wrapper, name, getattr(wrapper, name) + 1)
            return plain(*args, **kw)
        return call

    def in_f32(fn):
        """``fn`` on float32 copies of its tensors, its outputs back in the first's type."""
        def call(*args, **kw):
            out = fn(*(x.float() for x in args), **kw)
            return tuple(o.to(args[0].dtype) for o in out) if isinstance(out, tuple) else out.to(args[0].dtype)
        return call

    k1 = counting(fa.flash_attention_cuda, "launches", in_f32(ref.flash_attention_ref))
    k1_lse = counting(fa.flash_attention_cuda, "launches", lambda q, k, v, **kw: (
        in_f32(ref.flash_attention_ref)(q, k, v, **kw), ref.flash_attention_lse_ref(q.float(), k.float(), **kw)))
    bwd = counting(fa.flash_attention_bwd_cuda, "launches", lambda q, k, v, o, lse, do, **kw: in_f32(
        ref.flash_attention_bwd_ref)(q, k, v, do, **kw))
    for mod in (fa, chip_smoke):
        monkeypatch.setattr(mod, "flash_attention_cuda", k1)
        monkeypatch.setattr(mod, "flash_attention_lse_cuda", k1_lse)
        monkeypatch.setattr(mod, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(qz, "quantize_int8_cuda",
                        counting(qz.quantize_int8_cuda, "launches", ref.quantize_int8_ref))
    monkeypatch.setattr(qz, "dequantize_int8_cuda",
                        counting(qz.dequantize_int8_cuda, "launches", ref.dequantize_int8_ref))
    monkeypatch.setattr(ops, "_on_card", lambda x: x.device.type == "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "_profiled", lambda fn, **kw: (fn(), 1.0, []))
    monkeypatch.setattr(chip_smoke, "get_config", lambda arch: dataclasses.replace(
        get_config(arch).reduced(), dtype="bfloat16"))
    monkeypatch.setattr(chip_smoke.tempfile, "tempdir", str(tmp_path))
    ops.reset_launch_counts()
    return chip_smoke


def test_chip_smoke_archs_phase_on_cpu(monkeypatch, tmp_path):
    """chip_smoke's [archs] phase, the sequence the card runs at full width,
    on the CPU at the reduced sizes in bf16 (use_plain_stand_ins), so every
    launch count the phase derives and every check it makes runs here."""
    chip_smoke = use_plain_stand_ins(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, "ARCH_PREFILL", {"gemma2-2b": (1, 40)})  # past the window 16
    monkeypatch.setattr(chip_smoke, "ARCH_PREFILL_DEFAULT", (2, 24))
    monkeypatch.setattr(chip_smoke, "ARCH_CARD_CPU_SEQ", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 16)
    for name, value in (("MOE_LIFE_STEPS", 4), ("MOE_LIFE_PREEMPT", 2), ("MOE_LIFE_SAVE_EVERY", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "ARCH_FLASH_CASES", {
        "gemma2-2b local": (1, 40, 40, 4, 2, 16, "window", 16, 50.0),
        "gemma2-2b global": (2, 24, 24, 4, 2, 16, "causal", 0, 0.0)})
    total = chip_smoke.phase_archs(torch.device("cpu"))
    # per arch: 4 prefills at full depth (two, the decoded tokens', the
    # restored params'), and at one group's depth its forward, a step (2 x
    # its layers of K1 under remat "full", its layers of the backward) and
    # the prefill its decode is held to; granite's lifecycle at 2 layers:
    # the unmigrated run and sites A + B, 4 steps each, then one int8 save
    # and restore of the state's 4 x 12 float leaves (params, master, m, v)
    cfgs = {a: chip_smoke.get_config(a) for a in chip_smoke.ARCHS}
    group = {a: len(c.block_pattern) for a, c in cfgs.items()}
    steps = 2 * 4
    assert total["flash_attention_bf16"] == sum(
        4 * c.num_layers + 4 * group[a] for a, c in cfgs.items()) + 2 * 2 * steps
    assert total["flash_attention_bwd_bf16"] == sum(group.values()) + 2 * steps
    assert total["quantize_int8"] == total["dequantize_int8"] == 4 * 12
    # per arch the float32 prefill at full depth its float32 decode is held
    # to; granite's step again in float32 (one layer): K1 twice, its
    # backward once
    assert total["flash_attention"] == sum(c.num_layers for c in cfgs.values()) + 2
    assert total["flash_attention_bwd"] == 1
    assert total["decide_dest"] == 0
