"""The port's dense LM on the CPU against the JAX package, with the JAX
package's weights carried across (``convert.params_from_numpy``).

Tolerances: both sides run float32 on the CPU and differ only in the order
of their sums, so logits agree to 1e-5 (abs and rel).  Prefill against
step-by-step decode inside the port compares two different attention
computations (flash vs. the quadratic decode path): 1e-5 as well."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import greedy_decode as jgreedy_decode
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import flatten_with_paths, params_from_numpy
from repro_torch.launch.serve import greedy_decode
from repro_torch.models.model import build_model

TOL = 1e-5


@pytest.fixture(scope="module")
def reduced():
    """micro-lm().reduced(): 2 layers, d 64, GQA 4/2, hd 16, vocab 256."""
    jcfg = jget_config("micro-lm").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("micro-lm").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_config_copy_matches_reference():
    for arch in ("micro-lm", "micro-lm-100m"):
        for reduce in (False, True):
            j, t = jget_config(arch), get_config(arch)
            if reduce:
                j, t = j.reduced(), t.reduced()
            assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
                {f: getattr(j, f) for f in t.__dataclass_fields__}


def test_registry_builds_every_assigned_arch():
    """All ten assigned architectures are in the port's registry, as in the
    JAX package's, and each builds and draws its reduced model."""
    from repro.configs.registry import ASSIGNED as JASSIGNED
    from repro_torch.configs.registry import ASSIGNED

    assert sorted(ASSIGNED) == sorted(JASSIGNED) and len(ASSIGNED) == 10
    for arch in ASSIGNED:
        cfg = get_config(arch)
        params = build_model(cfg.reduced()).init(0, device="cpu")
        assert flatten_with_paths(params), arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ["micro-lm", "micro-lm-100m"])
def test_init_tree_matches_reference(arch):
    """Same leaf paths and shapes as the JAX init, so checkpoints line up."""
    cfg = get_config(arch).reduced()
    ours = [("/".join(p), tuple(x.shape), x.dtype) for p, x in
            flatten_with_paths(build_model(cfg).init(0, device="cpu"))]
    jp = jax.eval_shape(jbuild_model(jget_config(arch).reduced()).init, jax.random.PRNGKey(0))
    theirs = [("/".join(str(k.key) for k in p), tuple(x.shape), torch.float32)
              for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert ours == theirs
    assert len(ours) == 11


def test_init_is_seeded_and_device_independent():
    cfg = get_config("micro-lm").reduced()
    a = build_model(cfg).init(7, device="cpu")
    b = build_model(cfg).init(7, device="cpu")
    c = build_model(cfg).init(8, device="cpu")
    la, lb, lc = (dict(flatten_with_paths(t)) for t in (a, b, c))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la[("embed", "table")], lc[("embed", "table")])


def test_forward_matches_lm_forward(reduced):
    jcfg, jmodel, jparams, cfg, model, params = reduced
    toks = _tokens(1, 2, 24, cfg.vocab_size)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_decode_matches_lm_decode_step(reduced):
    jcfg, jmodel, jparams, cfg, model, params = reduced
    toks = _tokens(2, 2, 12, cfg.vocab_size)
    jcache = jmodel.init_cache(2, 12)
    cache = model.init_cache(2, 12, device="cpu")
    for i in range(12):
        want, jcache = jmodel.decode_step(
            jparams, jcache, {"token": jnp.asarray(toks[:, i]), "index": jnp.int32(i)})
        got, cache = model.decode_step(params, cache, {"token": torch.from_numpy(toks[:, i]), "index": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(cache["b0"]["k"].numpy(), np.asarray(jcache["b0"]["k"]),
                               atol=TOL, rtol=TOL)


def test_prefill_equals_stepwise_decode(reduced):
    *_, cfg, model, params = reduced
    toks = torch.from_numpy(_tokens(3, 2, 12, cfg.vocab_size))
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(2, 12, device="cpu")
    steps = []
    for i in range(12):
        lg, cache = model.decode_step(params, cache, {"token": toks[:, i], "index": i})
        steps.append(lg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=TOL, rtol=TOL)


def test_greedy_decode_tokens_match_reference(reduced):
    jcfg, jmodel, jparams, cfg, model, params = reduced
    prompt = _tokens(4, 3, 8, cfg.vocab_size)
    want = jgreedy_decode(jmodel, jparams, jnp.asarray(prompt), 12, 20)
    got = greedy_decode(model, params, torch.from_numpy(prompt).long(), 12, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_width_micro_lm_forward():
    """micro-lm at full width (8 layers, d 384, 6 x 64 heads, vocab 32000),
    b=1, s=16, with the JAX package's weights."""
    jmodel = jbuild_model(jget_config("micro-lm"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = _tokens(5, 1, 16, 32000)
    want, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = build_model(get_config("micro-lm")).forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (1, 16, 32000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
