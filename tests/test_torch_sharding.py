"""The port's sharding specs against the JAX package's, on the CPU.

Shape-only: the full-width param trees of the ten assigned architectures
come from ``Model.init`` under a FakeTensorMode (port) and
``jax.eval_shape`` (reference), never allocated.  The meshes are the
reference tests' ``FakeMesh`` stand-ins (axis names and sizes, no
devices): 16 x 16 ('data', 'model') and 2 x 16 x 16 ('pod', 'data',
'model').  Checked: ``param_pspecs`` leaf by leaf, the optimizer state's
specs, ``logical_spec`` with pruning and overrides, the strategy tables,
``shd``'s resolved spec, ``Model.input_specs`` / ``cache_specs`` (shapes,
dtypes, logical pspecs) for every arch x ``shapes()``, and the argument
bytes per device the specs imply.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.parallel import sharding as jsh
from repro.parallel import strategies as jstrategies
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.launch.dryrun import spec_bytes
from repro_torch.models.layers import TensorSpec
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import sharding as sh
from repro_torch.parallel import strategies


class FakeMesh:
    """Carry axis names+sizes without devices (the reference tests')."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape)


MESHES = {"16x16": FakeMesh(("data", "model"), (16, 16)),
          "2x16x16": FakeMesh(("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def port_shapes(arch):
    with FakeTensorMode():
        params = build_model(get_config(arch)).init(0, device="cpu")
    return _spec_tree(params)


@functools.lru_cache(maxsize=None)
def ref_shapes(arch):
    return jax.eval_shape(jbuild_model(jget_config(arch)).init, jax.random.PRNGKey(0))


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return TensorSpec(tuple(tree.shape), tree.dtype)


def _entry(a):
    """A spec entry in a form both packages share."""
    if a is None or isinstance(a, str):
        return a
    if isinstance(a, tuple):
        return tuple(a)
    return "UNCONSTRAINED"  # the sentinel of either package


def _norm(spec, ndim):
    out = [_entry(a) for a in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _ref_leaves(tree, path=()):
    """(path, leaf) of a reference tree; a logical-name tuple is a leaf,
    and the mLSTM state's (C, n, m) tuple is read under the port's keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and tree and isinstance(tree[0], (tuple, jax.ShapeDtypeStruct)):
        for name, v in zip("Cnm", tree):
            yield from _ref_leaves(v, path + (name,))
    else:
        yield path, tree


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _ref_pspec_leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, JP)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ASSIGNED))
def test_param_pspecs_match_reference(arch, mesh):
    m = MESHES[mesh]
    got = dict(_port_leaves(sh.param_pspecs(port_shapes(arch), sh.DEFAULT_RULES, m)))
    shapes = dict(_port_leaves(port_shapes(arch)))
    want = {tuple(str(k.key) for k in p): s for p, s in
            _ref_pspec_leaves(jsh.param_pspecs(ref_shapes(arch), jsh.DEFAULT_RULES, m)).items()}
    assert set(got) == set(want)
    for path, spec in got.items():
        nd = len(shapes[path].shape)
        assert _norm(spec, nd) == _norm(want[path], nd), (arch, path)
    assert spec_bytes(port_shapes(arch), sh.param_pspecs(port_shapes(arch), sh.DEFAULT_RULES, m),
                      dict(zip(m.axis_names, m.devices.shape))) == _ref_bytes(
        ref_shapes(arch), jsh.param_pspecs(ref_shapes(arch), jsh.DEFAULT_RULES, m), m)


def _ref_bytes(sds, pspecs, mesh) -> int:
    """The reference's spec-implied bytes per device (the same formula)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    flat = jax.tree_util.tree_leaves(sds)
    specs = jax.tree_util.tree_leaves(pspecs, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for s, p in zip(flat, specs):
        n = 1
        for a in p:
            for x in (a if isinstance(a, tuple) else (a,)):
                n *= sizes.get(x, 1) if isinstance(x, str) else 1
        total += int(np.prod(s.shape)) * s.dtype.itemsize // n
    return total


def test_opt_state_mirrors_param_sharding():
    cfg = get_config("qwen3-1.7b").reduced()
    with FakeTensorMode():
        params = build_model(cfg).init(0, device="cpu")
        opt = init_opt_state(params)
    mesh = MESHES["16x16"]
    specs = sh.param_pspecs(params, sh.DEFAULT_RULES, mesh)
    opt_specs = sh.param_pspecs(opt, sh.DEFAULT_RULES, mesh)
    for k in ("m", "v", "master"):
        assert opt_specs[k] == specs
    assert opt_specs["step"] == sh.P()
    jsds = jax.eval_shape(jbuild_model(jget_config("qwen3-1.7b").reduced()).init,
                          jax.random.PRNGKey(0))
    jopt = jsh.param_pspecs(jax.eval_shape(jinit_opt_state, jsds), jsh.DEFAULT_RULES, mesh)
    want = {tuple(str(k.key) for k in p): s for p, s in _ref_pspec_leaves(jopt["m"]).items()}
    for path, spec in _port_leaves(opt_specs["m"]):
        assert _norm(spec, 4) == _norm(want[path], 4)


def test_logical_spec_prunes_missing_axes():
    for mod, P in ((sh, sh.P), (jsh, JP)):
        with mod.force_mesh_axes(("data", "model")):
            assert tuple(mod.logical_spec("batch", "seq")) == ("data", "model")
            assert tuple(mod.logical_spec("batch", "*", "kv_long")) == tuple(
                mod.logical_spec("batch", "*", "kv_long"))
        with mod.force_mesh_axes(("pod", "data", "model")):
            assert tuple(mod.logical_spec("batch", "seq")) == (("pod", "data"), "model")
    names = ("batch", "dp_batch", "seq", "kv_seq", "kv_long", "*", "mlp_act", "vocab")
    for mesh in (("data", "model"), ("pod", "data", "model")):
        with sh.force_mesh_axes(mesh), jsh.force_mesh_axes(mesh):
            for n in names:
                for m in names:
                    assert _norm(sh.logical_spec(n, m), 2) == _norm(jsh.logical_spec(n, m), 2)


def test_rules_override():
    rules = sh.DEFAULT_RULES.with_overrides(seq=None, mlp_act="model")
    with sh.use_rules(rules), sh.force_mesh_axes(("data", "model")):
        assert sh.logical_spec("seq") == sh.P(None)
        assert sh.logical_spec("mlp_act") == sh.P("model")


def test_strategy_tables_match_reference():
    assert sorted(strategies.STRATEGIES) == sorted(jstrategies.STRATEGIES)
    for name, rules in strategies.STRATEGIES.items():
        assert rules.rules == jstrategies.get_strategy(name).rules, name
    with pytest.raises(KeyError):
        strategies.get_strategy("nope")


SHD_CASES = [
    ((128, 4096, 2048), ("batch", "seq", "embed_act"), "baseline", "16x16"),
    ((128, 1, 2048), ("batch", "seq", "embed_act"), "baseline", "2x16x16"),
    ((8, 4096, 6144), ("batch", "seq", "mlp_act"), "tp-ffn", "16x16"),
    ((8, 4096, 16, 128), ("batch", "seq", "heads_act", "head_dim"), "tp-ffn", "2x16x16"),
    ((4, 1, 49155), ("batch", "seq", "vocab_act"), "decode-tp", "16x16"),
    ((2, 128, 8, 1, 32768), ("*", "*", "*", "*", "kv_seq"), "baseline", "16x16"),
    ((16, 32, 4, 256, 1024), ("expert_act", "batch", None, None), "baseline", "2x16x16"),
    ((1, 524288, 2048), ("batch", "seq", None), "seq-data", "16x16"),
    ((24, 8, 3, 7), ("batch", "seq", "mlp_act", "vocab_act"), "small-repl", "2x16x16"),
]


@pytest.mark.parametrize("shape,names,rules,mesh", SHD_CASES)
def test_shd_resolved_spec_matches_reference(shape, names, rules, mesh, monkeypatch):
    m = MESHES[mesh]
    sizes = dict(zip(m.axis_names, m.devices.shape))
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: seen.append(s) or x)
    monkeypatch.setattr(jsh, "_mesh_axis_sizes", lambda: sizes)
    with jsh.use_rules(jstrategies.get_strategy(rules)), jsh.force_mesh_axes(m.axis_names):
        jsh.shd(jax.ShapeDtypeStruct(shape, np.float32), *names)
    with sh.use_rules(strategies.get_strategy(rules)):
        got = sh.resolve_spec(shape, names, m.axis_names, sizes)
    assert _norm(got, len(shape)) == _norm(seen[0], len(shape))


def _cells():
    return [(a, s) for a in ASSIGNED for s in get_config(a).shapes()]


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_match_reference(arch, shape):
    specs, logical = build_model(get_config(arch)).input_specs(shape)
    jspecs, jlogical = jbuild_model(jget_config(arch)).input_specs(shape)
    got, want = dict(_port_leaves(specs)), dict(_ref_leaves(jspecs))
    assert set(got) == set(want)
    for path, s in got.items():
        assert tuple(s.shape) == tuple(want[path].shape), path
        assert str(s.dtype).removeprefix("torch.") == str(want[path].dtype), path
    glog, wlog = dict(_port_leaves(logical)), dict(_ref_leaves(jlogical))
    assert glog == {p: tuple(v) for p, v in wlog.items()}
    for mesh in MESHES.values():
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        with sh.force_mesh_axes(mesh.axis_names), jsh.force_mesh_axes(mesh.axis_names):
            ps = {p: sh.logical_spec(*v) for p, v in glog.items()}
            jps = {p: jsh.logical_spec(*v) for p, v in wlog.items()}
        for p in ps:
            assert _norm(ps[p], len(got[p].shape)) == _norm(jps[p], len(got[p].shape)), p
        mine = sum(spec_bytes(got[p], ps[p], sizes) for p in got)
        ref = 0
        for p, s in want.items():
            n = 1
            for a in jps[p]:
                for x in (a if isinstance(a, tuple) else (a,)):
                    n *= sizes.get(x, 1) if isinstance(x, str) else 1
            ref += int(np.prod(s.shape)) * s.dtype.itemsize // n
        assert mine == ref


def test_cache_specs_long_context_pspecs():
    """decode_step(long_context=) changes only the sharding: the cache
    shapes are the same, its pspecs the reference's long-context ones."""
    for arch in ("jamba-v0.1-52b", "xlstm-1.3b"):
        model, jmodel = build_model(get_config(arch)), jbuild_model(jget_config(arch))
        short, short_ps = model.cache_specs(1, 64)
        long, long_ps = model.cache_specs(1, 64, long_context=True)
        assert short == long
        _, jlong_ps = jmodel.cache_specs(1, 64, long_context=True)
        assert dict(_port_leaves(long_ps)) == {p: tuple(v) for p, v in _ref_leaves(jlong_ps)}
        assert dict(_port_leaves(long_ps)) != dict(_port_leaves(short_ps))


def test_dummy_batch_matches_input_specs():
    model = build_model(get_config("qwen2-vl-7b").reduced())
    specs, _ = model.input_specs("decode_32k")
    b1 = model.dummy_batch("decode_32k", generator=torch.Generator().manual_seed(3), device="cpu")
    b2 = model.dummy_batch("decode_32k", generator=torch.Generator().manual_seed(3), device="cpu")
    for (path, s), (_, x), (_, y) in zip(_port_leaves(specs), _port_leaves(b1), _port_leaves(b2)):
        assert tuple(x.shape) == tuple(s.shape) and x.dtype == s.dtype, path
        assert torch.equal(x, y)
    assert 0 <= int(b1["index"]) < 2
    assert 0 <= int(b1["positions"].min()) and int(b1["positions"].max()) < model.cfg.vocab_size
    assert b1["embeds"].dtype == torch.float32 and float(b1["embeds"].std()) > 0.5
