"""xlstm-1.3b's mLSTM and sLSTM cells and the reduced xlstm model in the
port on the CPU against the JAX package, with the JAX package's weights
carried across (``convert.params_from_numpy``) and inputs made with numpy
from a seed.

The cells are held at 512 tokens: the chunk-parallel mLSTM runs two
256-token chunks (its carry crosses a chunk boundary), the recurrent mLSTM
and the sLSTM 512 sequential steps.  The whole reduced model (16 blocks:
14 mLSTM, 2 sLSTM) is held for the forward, the loss and every gradient,
decode, GRNCKPT1 bytes and the launchers.

Tolerances: float32 on both sides, differing in the order of sums only.
The mLSTM cells on N(0, 1) inputs: the reference's own cell tolerance
(``tests/test_models.py::test_mlstm_chunked_matches_recurrent``, 2e-5 abs
and 2e-4 rel), since h = num / max(|den|, e^-m) magnifies the rounding of
num where den nears 0; the port's chunked mLSTM against its recurrent form
the same.  The sLSTM scan, logits and decode against the reference's
decode 1e-5 (abs and rel), the repo's whole-model standard; the loss 1e-6
relative; gradients 1e-4 of each leaf's largest element (autograd and
XLA's autodiff sum the backward's products in other orders), but the
sLSTM's input-gate bias against its block's input-gate weights' largest
gradient: a bias on every ĩ_t cancels in the stabilized ratio c_t / n_t
except through n_0 = 1e-6, so its gradient (~1e-13) is what is left of
summing terms of that weight gradient's size (~1e-8) that cancel, and its
rounding is relative to them.  bf16: the repo's bf16 tolerance, 2e-2.
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
from repro.models import xlstm as jxlstm
from repro.models.model import build_model as jbuild_model
from repro_torch.checkpoint import serializer as ser
from repro_torch.configs import base, get_config
from repro_torch.convert import flatten_with_paths, params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import xlstm
from repro_torch.models.model import build_model
from repro_torch.train.train_step import value_and_grad

ARCH = "xlstm-1.3b"
TOL = 1e-5
CELL_ATOL, CELL_RTOL = 2e-5, 2e-4
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


def _cell_inputs(seed, b=2, s=512, H=4, dh=32):
    """q, k, v ~ N(0, 1); input gates ~ N(0, 1); log forget gates of
    N(3, 1) pre-activations, as the blocks' open forget gates give."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, H, dh)).astype(np.float32) for _ in range(3))
    i_raw = rng.standard_normal((b, s, H)).astype(np.float32)
    logf = np.asarray(jax.nn.log_sigmoid(rng.standard_normal((b, s, H)) + 3.0), np.float32)
    return q, k, v, i_raw, logf


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol, err_msg=what)


def _cell_close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CELL_ATOL, rtol=CELL_RTOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# The cells
# ---------------------------------------------------------------------------


def test_mlstm_cell_matches_reference():
    """Two 256-token chunks: h and the final carry (C, n, m)."""
    inp = _cell_inputs(0)
    want_h, want_c = jax.jit(jxlstm.mlstm_cell)(*map(jnp.asarray, inp))
    got_h, got_c = xlstm.mlstm_cell(*map(torch.from_numpy, inp))
    _cell_close(got_h, want_h)
    for g, w, name in zip(got_c, want_c, "Cnm"):
        _cell_close(g, w, what=name)


def test_mlstm_cell_recurrent_matches_reference_and_the_chunked_form():
    """512 sequential steps from the zero carry against the reference's
    recurrent oracle, and against the port's own chunk-parallel form."""
    inp = _cell_inputs(1)
    want_h, want_c = jax.jit(jxlstm.mlstm_cell_recurrent)(*map(jnp.asarray, inp))
    t_inp = tuple(map(torch.from_numpy, inp))
    got_h, got_c = xlstm.mlstm_cell_recurrent(*t_inp)
    _cell_close(got_h, want_h)
    for g, w, name in zip(got_c, want_c, "Cnm"):
        _cell_close(g, w, what=name)
    chunked_h, chunked_c = xlstm.mlstm_cell(*t_inp)
    _cell_close(chunked_h, got_h.numpy())
    for g, w, name in zip(chunked_c, got_c, "Cnm"):
        _cell_close(g, w.numpy(), what=name)


def test_mlstm_cell_refuses_a_partial_chunk():
    """300 tokens are not a whole number of 256-token chunks: the reference
    asserts; the port says why."""
    inp = tuple(torch.from_numpy(a[:, :300]) for a in _cell_inputs(2))
    with pytest.raises(ValueError, match="256-token chunks"):
        xlstm.mlstm_cell(*inp)


def test_slstm_scan_matches_reference(reduced):
    """The first sLSTM block's scan over 512 tokens: h and the last state."""
    cfg, host = reduced[3], reduced[6]
    p = {k: v[0] for k, v in host["groups"]["b7"]["slstm"].items()}
    x = np.random.default_rng(3).standard_normal((2, 512, cfg.d_model)).astype(np.float32)
    want_h, want_st = jax.jit(lambda p, x: jxlstm._slstm_scan(p, x, cfg.num_heads))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got_h, got_st = xlstm._slstm_scan(params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg.num_heads)
    _close(got_h, want_h)
    for name in "cnhm":
        _close(got_st[name], want_st[name], what=name)


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------


def _param_count_gap(cfg) -> int:
    """What the JAX package's analytic ``param_count`` leaves out of the
    built tree: each sLSTM block's four block-diagonal recurrent maps r_g
    (4 x H x dh x dh), less the second norm it counts in every block (an
    mLSTM or sLSTM block has only norm1)."""
    d, H = cfg.d_model, cfg.num_heads
    n_slstm = cfg.num_groups * cfg.block_pattern.count("slstm")
    return n_slstm * 4 * H * (d // H) ** 2 - cfg.num_layers * d


def test_config_copy_and_param_count_match_reference():
    """The config and its analytic count are the reference's; the built
    tree has the reference tree's size, which the analytic count misses by
    ``_param_count_gap``."""
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
    assert base.param_count(full) == 1_994_590_544
    assert base.param_count(full) + _param_count_gap(full) == 2_019_658_064


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Same leaf paths, shapes and dtypes as the JAX init: mLSTM and sLSTM
    blocks hold norm1 and their mixer, no norm2 or MLP."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    ours = [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flatten_with_paths(build_model(cfg).init(0, device="cpu"))]
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype)
    jp = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    theirs = [("/".join(str(k.key) for k in p), tuple(x.shape), str(x.dtype))
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert ours == theirs
    assert not any("norm2" in p or "mlp" in p for p, _, _ in ours)


def test_forward_matches_reference(reduced):
    """512 tokens: two mLSTM chunks, 512 sLSTM steps."""
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    toks = _tokens(1, 2, 512, cfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert float(aux) == 0.0


def test_loss_and_grads_match_reference(reduced):
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    toks = _tokens(2, 2, 40, cfg.vocab_size + 1) - 1  # some labels -1: masked
    batch = {"tokens": np.clip(toks, 0, None), "labels": toks}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, m), grads = value_and_grad(model, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      "full")
    for got, want in ((loss, jloss), (m["ce"], jm["ce"])):
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=0)
    jleaves = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    ours = flatten_with_paths(grads)
    assert [p for p, _ in ours] == [tuple(str(k.key) for k in p) for p, _ in jleaves]
    want = {path: np.asarray(w) for path, w in
            ((tuple(str(k.key) for k in p), w) for p, w in jleaves)}
    for path, g in ours:
        w = want[path]
        assert np.abs(w).max() > 0, path
        scale = np.abs(w).max()
        if path[-2:] == ("slstm", "bi"):
            scale = max(scale, np.abs(want[path[:-1] + ("wi",)]).max())
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg="/".join(path))


def test_decode_matches_reference_decode(reduced):
    """Step-by-step decode from the zero cache (mLSTM m = 0, sLSTM n = 0, as
    the reference's init_cache makes it) against the reference's decode,
    and every state."""
    jcfg, jmodel, jparams, cfg, model, params, _ = reduced
    S = 12
    toks = _tokens(3, 2, S, cfg.vocab_size)
    jcache = jmodel.init_cache(2, S)
    cache = model.init_cache(2, S, device="cpu")
    jstep = jax.jit(jmodel.decode_step)
    for i in range(S):
        want, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i]), "index": jnp.int32(i)})
        got, cache = model.decode_step(params, cache, {"token": torch.from_numpy(toks[:, i]), "index": i})
        _close(got, want)
    for blk, kind in zip(sorted(cache), cfg.block_pattern):
        names = "Cnm" if kind == "mlstm" else "cnhm"
        want = jcache[blk] if kind == "slstm" else dict(zip("Cnm", jcache[blk]))
        for name in names:
            _close(cache[blk][name], want[name], what=f"{blk}/{name}")


def test_bf16_forward_matches_reference():
    jcfg, jmodel, jparams, cfg, model, params, _ = _pair("bfloat16")
    toks = _tokens(6, 2, 24, cfg.vocab_size)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_grnckpt1_bytes_identical_to_reference(mode):
    """The reduced model's bf16 tree: the same GRNCKPT1 bytes from both
    packages in every mode (delta-int8 against a perturbed base)."""
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


def test_launchers_serve_and_train_the_reduced_model(tmp_path, capsys):
    """``serve --arch xlstm-1.3b --smoke`` and ``train --smoke`` on the CPU."""
    assert serve_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                                "--prompt-len", "4", "--tokens", "4"]) == 0
    assert "[serve] generated 8 tokens" in capsys.readouterr().out
    assert train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "16", "--save-every", "1",
                                "--ckpt-mode", "int8", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert '"status": "done"' in out and '"step": 2' in out
