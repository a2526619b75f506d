"""jamba-v0.1-52b's Mamba mixer and the reduced jamba model in the port on
the CPU against the JAX package, with the JAX package's weights carried
across (``convert.params_from_numpy``) and inputs made with numpy from a
seed.

The mixer is held at 512 tokens (two 256-token chunks: the state crosses
a chunk boundary), at 528 (two chunks of 264) and at 100 (one), and its
decode step by step.  The whole reduced model (16 layers: 14 Mamba, 2
attention, 8 MoE) is held for the forward, the loss and every gradient,
decode, GRNCKPT1 bytes and the launchers.

Tolerances: float32 on both sides.  The port's prefix scan is a
Hillis-Steele doubling scan, the reference's ``jax.lax.associative_scan``
another tree of the same products, so they differ in the order of their
float32 products and sums only: mixer outputs and logits 1e-5 (abs and
rel), the repo's whole-model standard; the loss 1e-6 relative; gradients
1e-4 of each leaf's largest element (autograd and XLA's autodiff sum the
backward's products in other orders, through 16 layers); decode against
the reference's decode 1e-5.  bf16: the repo's bf16 tolerance, 2e-2.
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
from repro.models import mamba as jmamba
from repro.models.model import build_model as jbuild_model
from repro_torch.checkpoint import serializer as ser
from repro_torch.configs import base, get_config
from repro_torch.convert import flatten_with_paths, params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import mamba
from repro_torch.models.model import build_model
from repro_torch.train.train_step import value_and_grad

ARCH = "jamba-v0.1-52b"
TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
MODES = ("full", "int8", "delta-int8")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The sequential loops here run many small ops: on a few threads they
    do not wait on the pool the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    host = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jcfg, jmodel, jax.tree.map(jnp.asarray, host), cfg, build_model(cfg), \
        params_from_numpy(host, "cpu"), host


@pytest.fixture(scope="module")
def reduced():
    return _pair()


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _mixer(reduced):
    """The first group's first Mamba layer: (JAX params, port params)."""
    host = reduced[6]
    p = {k: v[0] for k, v in host["groups"]["b0"]["mamba"].items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p, "cpu")


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------


def test_prefix_scan_matches_the_sequential_recurrence():
    """The doubling scan against h_t = a_t h_{t-1} + b_t one step at a time
    (and the running product of a), at lengths that are and are not powers
    of two."""
    rng = np.random.default_rng(0)
    for length in (1, 7, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, length, 3, 4)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, length, 3, 4)).astype(np.float32))
        got_a, got_b = mamba._prefix_scan(a, b)
        h, prod = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
        for t in range(length):
            h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
            torch.testing.assert_close(got_b[:, t], h, atol=TOL, rtol=TOL)
            torch.testing.assert_close(got_a[:, t], prod, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [512, 528, 100])
def test_apply_mamba_matches_reference(reduced, s):
    """512 and 528 tokens run as two chunks, 100 as one."""
    cfg = reduced[3]
    jp, p = _mixer(reduced)
    x = _x(s, 2, s, cfg.d_model)
    want = jax.jit(lambda p, x: jmamba.apply_mamba(p, x, d_state=cfg.mamba_d_state))(jp, jnp.asarray(x))
    got = mamba.apply_mamba(p, torch.from_numpy(x), d_state=cfg.mamba_d_state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_apply_mamba_refuses_unequal_chunks(reduced):
    """513 tokens do not split into two equal chunks: the reference's
    reshape fails; the port says why."""
    _, p = _mixer(reduced)
    with pytest.raises(ValueError, match="chunks of equal"):
        mamba.apply_mamba(p, torch.zeros((1, 513, reduced[3].d_model)), d_state=reduced[3].mamba_d_state)


def test_apply_mamba_decode_matches_reference_and_the_prefill(reduced):
    """16 decode steps from the zero state against the reference's; and a
    512-token prefill's state (``return_state``) followed by 16 decode
    steps against the forward over all 528 tokens."""
    cfg = reduced[3]
    jp, p = _mixer(reduced)
    N = cfg.mamba_d_state
    x = _x(7, 2, 528, cfg.d_model)
    spec = mamba.mamba_state_spec(2, cfg.d_model, expand=cfg.mamba_expand, d_state=N,
                                  d_conv=cfg.mamba_d_conv, dtype=torch.float32)
    state = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in spec.items()}
    jstate = jax.tree.map(jnp.asarray, jmamba.init_mamba_state(
        2, cfg.d_model, expand=cfg.mamba_expand, d_state=N, d_conv=cfg.mamba_d_conv,
        dtype=jnp.float32))
    jstep = jax.jit(lambda p, x, st: jmamba.apply_mamba_decode(p, x, st, d_state=N))
    for t in range(16):
        want, jstate = jstep(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        got, state = mamba.apply_mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), state, d_state=N)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(state["ssm"].numpy(), np.asarray(jstate["ssm"]), atol=TOL, rtol=TOL)

    xt = torch.from_numpy(x)
    whole = mamba.apply_mamba(p, xt, d_state=N)
    head, state = mamba.apply_mamba(p, xt[:, :512], d_state=N, return_state=True)
    np.testing.assert_allclose(head.numpy(), whole[:, :512].numpy(), atol=TOL, rtol=TOL)
    for t in range(512, 528):
        got, state = mamba.apply_mamba_decode(p, xt[:, t:t + 1], state, d_state=N)
        np.testing.assert_allclose(got.numpy(), whole[:, t:t + 1].numpy(), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------


def test_config_copy_and_param_count_match_reference():
    for reduce in (False, True):
        j, t = jget_config(ARCH), get_config(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
            {f: getattr(j, f) for f in t.__dataclass_fields__}
        assert base.param_count(t) == jbase.param_count(j)
        assert base.active_param_count(t) == jbase.active_param_count(j)
    n = sum(x.numel() for _, x in flatten_with_paths(build_model(t).init(0, device="cpu")))
    assert n == base.param_count(t)
    assert base.param_count(get_config(ARCH)) == 51_570_315_264


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Same leaf paths, shapes and dtypes as the JAX init: in a bf16 model
    the Mamba layers' A_log and D and the MoE router stay float32."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    ours = [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flatten_with_paths(build_model(cfg).init(0, device="cpu"))]
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype)
    jp = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    theirs = [("/".join(str(k.key) for k in p), tuple(x.shape), str(x.dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert ours == theirs
    f32 = {p for p, _, dt in ours if dt == "float32"}
    if dtype == "bfloat16":
        assert f32 == {f"groups/b{i}/mamba/{leaf}" for i in (0, 1, 2, 3, 5, 6, 7)
                       for leaf in ("A_log", "D")} | {f"groups/b{i}/moe/router" for i in (1, 3, 5, 7)}


def test_forward_matches_reference(reduced):
    """512 tokens: every Mamba layer runs two chunks."""
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    toks = _tokens(1, 2, 512, cfg.vocab_size)
    want, jaux = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL, atol=0)


def test_loss_and_grads_match_reference(reduced):
    """lm_loss (ce and the MoE aux) and every gradient against
    jax.value_and_grad."""
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    toks = _tokens(2, 2, 40, cfg.vocab_size + 1) - 1  # some labels -1: masked
    batch = {"tokens": np.clip(toks, 0, None), "labels": toks}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, m), grads = value_and_grad(model, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      "full")
    for got, want in ((loss, jloss), (m["ce"], jm["ce"]), (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=0)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    ours = flatten_with_paths(grads)
    assert [p for p, _ in ours] == [tuple(str(k.key) for k in p) for p, _ in jleaves]
    for (path, g), (_, w) in zip(ours, jleaves):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0,
                                   err_msg="/".join(path))


def test_decode_matches_reference_decode(reduced):
    """Step-by-step decode through the Mamba conv and SSM states and the
    attention caches against the reference's decode, and its states."""
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    S = 12
    toks = _tokens(3, 2, S, cfg.vocab_size)
    jcache = jmodel.init_cache(2, S)
    cache = model.init_cache(2, S, device="cpu")
    jstep = jax.jit(jmodel.decode_step)
    for i in range(S):
        want, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i]), "index": jnp.int32(i)})
        got, cache = model.decode_step(params, cache, {"token": torch.from_numpy(toks[:, i]), "index": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for blk in cache:
        for name in cache[blk]:
            np.testing.assert_allclose(cache[blk][name].numpy(), np.asarray(jcache[blk][name]),
                                       atol=TOL, rtol=TOL, err_msg=f"{blk}/{name}")


def test_bf16_forward_matches_reference():
    """The reduced model in bf16 (A_log, D and the router in float32), the
    JAX package's bf16 weights carried across bit for bit."""
    jcfg, jmodel, jparams, cfg, model, params, _ = _pair("bfloat16")
    toks = _tokens(6, 2, 24, cfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_grnckpt1_bytes_identical_to_reference(mode):
    """The bf16 tree with its float32 A_log, D and router leaves: the same
    GRNCKPT1 bytes from both packages in every mode (delta-int8 against a
    perturbed base)."""
    jcfg = jget_config(ARCH).reduced()
    host = jax.tree.map(np.asarray, jbuild_model(dataclasses.replace(jcfg, dtype="bfloat16")).init(
        jax.random.PRNGKey(1)))
    later = params_from_numpy(host, "cpu")
    base_t = {**later, "final_norm": {"scale": later["final_norm"]["scale"] * 2}}
    b = base_t if mode == "delta-int8" else None
    jb = jax.tree.map(np.asarray, {**host, "final_norm": {"scale": host["final_norm"]["scale"] * 2}}) \
        if b is not None else None
    want = jser.to_bytes(jser.serialize_tree(host, mode=mode, base=jb))
    got = ser.to_bytes(ser.serialize_tree(later, mode=mode, base=b, device="cpu"))
    assert got == want
    assert ser.tree_bytes(later) == jser.tree_bytes(host)


def test_launchers_serve_and_train_the_reduced_model(tmp_path, capsys):
    """``serve --arch jamba-v0.1-52b --smoke`` and ``train --smoke`` on the
    CPU, as the JAX package's launchers run it."""
    assert serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                                "--prompt-len", "4", "--tokens", "4"]) == 0
    assert "[serve] generated 8 tokens" in capsys.readouterr().out
    assert train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "16", "--save-every", "1",
                                "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert '"status": "done"' in out and '"step": 2' in out
