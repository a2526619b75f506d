"""The MoE on expert shards (EP) and the capacity dispatch, in a real 2-rank
world on the CPU.

Two processes join a ``gloo`` world (a ``FileStore``, no network) and run
the reduced granite-moe-1b-a400m, phi3.5-moe-42b-a6.6b and jamba-v0.1-52b
in float32, from the JAX package's init, on a (1, 2) ('data', 'model')
mesh (the experts split over 'model': each rank runs 2 of the 4) and on a
(2, 1) one (the batch split over 'data').  Mamba's chunk is cut to 16
tokens in the port, as in ``tests/test_torch_mixer_shards.py``.

Held against the JAX package and the unsharded port: the logits (1e-5),
the loss (1e-5) and every gradient (1e-4 of its leaf's max; the router's
is where an aux loss counted on both ranks would show) of
``value_and_grad``; decode step by step from an empty cache placed by its
pspecs (1e-5 a step).  On (1, 2) a recorder of the functional collectives'
inputs finds none of an expert weight's local block, through the forward,
the gradients and decode, and one MoE layer run alone makes its (b s k,
d) buffer of routed rows and no dense (2 or 4, b, s, d) dispatch.  Under
the ``moe-blocked`` rules with ``REPRO_MOE_IMPL=capacity`` granite's
forward, loss and gradients at 512 tokens (one 256-token block a rank on
(1, 2)) equal the reference's capacity dispatch; at 48 tokens (24 a rank
on (1, 2), against a 48-token block) the capacity path raises.  One launch
of the two workers serves every test; each worker's output goes to a file,
and both are killed on a timeout.
"""
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b")
CAPACITY_ARCH = ARCHS[0]
MESHES = ((1, 2), (2, 1))
B, S, CAP_S, CHUNK = 2, 48, 512, 16
DECODE_STEPS = 6
ATOL_LOGITS, RTOL_LEAF = 1e-5, 1e-4
WORKER_TIMEOUT = 600
COLLECTIVES = ("all_", "reduce_", "broadcast")  # the functional collectives' names


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _unflatten(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tokens(vocab: int, s: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, vocab, (B, s + 1)).astype(np.int32)


def _tag(shape) -> str:
    return "x".join(map(str, shape))


def _moe_layer(tree: dict) -> dict:
    """The params of the first MoE layer of group 0."""
    for _, p in sorted(tree["groups"].items()):
        if "moe" in p:
            return {k: v[0] for k, v in p["moe"].items()}
    raise AssertionError("no MoE layer")


def _worker(rank: int, work: str) -> None:
    """One rank of the 2-rank world (run by the ``world`` fixture)."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mamba, moe
    from repro_torch.models.model import build_model
    from repro_torch.parallel.compat import distribute_tensor
    from repro_torch.parallel.sharding import (
        force_mesh_axes, logical_spec, mesh_names_sizes, param_pspecs, placements, resolve_spec,
        use_rules)
    from repro_torch.parallel.strategies import get_strategy
    from repro_torch.train.train_step import value_and_grad

    class Recorder(TorchDispatchMode):
        """(op name, input shape) of every functional collective, and the
        shape of every tensor any op returns."""

        def __init__(self):
            super().__init__()
            self.collectives, self.outputs = set(), set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if (func.namespace == "_c10d_functional" and name.startswith(COLLECTIVES)
                    and args and isinstance(args[0], torch.Tensor)):
                self.collectives.add((name, tuple(args[0].shape)))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.outputs.add(tuple(o.shape))
            return out

    mamba.CHUNK = CHUNK
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), 2),
                            rank=rank, world_size=2, timeout=timedelta(minutes=3))
    out, meta = {}, {}

    def load(arch):
        with np.load(os.path.join(work, f"{arch}.npz")) as z:
            return params_from_numpy(_unflatten(dict(z)), "cpu")

    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        names, sizes = mesh_names_sizes(mesh)

        def place(x, spec):
            if isinstance(x, dict):
                return {k: place(x[k], spec[k]) for k in x}
            return distribute_tensor(x, mesh, placements(spec, mesh), src_data_rank=None)

        def batch_of(toks, s):
            host = {"tokens": toks[:, :s], "labels": toks[:, 1:s + 1]}
            spec = logical_spec("batch", "seq")
            return make_global_batch(host, mesh, {"tokens": spec, "labels": spec})

        def forward_and_grads(model, dp, batch, key, rec=None):
            with rec or contextlib.nullcontext():
                logits, _ = model.forward(dp, {"tokens": batch["tokens"]})
                (loss, _), grads = value_and_grad(model, dp, batch, "full")
            out[f"{key}/logits"] = logits.full_tensor().numpy()
            out[f"{key}/loss"] = np.array(float(loss.full_tensor()))
            for k, g in _flat(grads).items():
                out[f"{key}/grad/{k}"] = g.full_tensor().numpy()

        for arch in ARCHS:
            key = f"{_tag(shape)}/{arch}"
            cfg = get_config(arch).reduced()
            model = build_model(cfg)
            params = load(arch)
            toks = _tokens(cfg.vocab_size, S)
            rec = Recorder()  # the model's collectives, not the test's reads
            with force_mesh_axes(names):
                dp = place(params, param_pspecs(params, mesh=mesh))
                batch = batch_of(toks, S)
            forward_and_grads(model, dp, batch, key, rec)
            _, pspecs = model.cache_specs(B, DECODE_STEPS)
            zeros = model.init_cache(B, DECODE_STEPS, device="cpu")
            with force_mesh_axes(names):
                cache = {blk: {k: distribute_tensor(
                    zeros[blk][k], mesh, placements(resolve_spec(
                        tuple(zeros[blk][k].shape), pspecs[blk][k], names, sizes), mesh),
                    src_data_rank=None) for k in zeros[blk]} for blk in zeros}
            steps = []
            for i in range(DECODE_STEPS):
                with rec:
                    got, cache = model.decode_step(dp, cache, {
                        "token": torch.from_numpy(toks[:, i]), "index": i})
                steps.append(got.full_tensor().numpy())
            out[f"{key}/decode"] = np.stack(steps, 1)
            meta[f"{key}/collectives"] = sorted(rec.collectives)
            # one MoE layer alone: the buffers it makes
            p = _moe_layer(params)
            with force_mesh_axes(names):
                pd = place({"moe": p}, param_pspecs({"moe": p}, mesh=mesh))["moe"]
                x = distribute_tensor(
                    torch.from_numpy(np.random.default_rng(5).standard_normal(
                        (B, S, cfg.d_model)).astype(np.float32)),
                    mesh, placements(logical_spec("batch", "seq", None), mesh), src_data_rank=None)
            rec = Recorder()
            with rec:
                y, aux = moe.apply_moe(pd, x, top_k=cfg.top_k, act=cfg.act)
            out[f"{key}/layer_y"] = y.full_tensor().numpy()
            out[f"{key}/layer_aux"] = np.array(float(aux.full_tensor()))
            meta[f"{key}/layer_outputs"] = sorted(rec.outputs)
            meta[f"{key}/layer_collectives"] = sorted(rec.collectives)

        # the capacity dispatch under moe-blocked, selected by REPRO_MOE_IMPL
        cfg = get_config(CAPACITY_ARCH).reduced()
        model = build_model(cfg)
        params = load(CAPACITY_ARCH)
        key = f"{_tag(shape)}/capacity"
        os.environ["REPRO_MOE_IMPL"] = "capacity"
        try:
            with use_rules(get_strategy("moe-blocked")):
                with force_mesh_axes(names):
                    dp = place(params, param_pspecs(params, mesh=mesh))
                    batch = batch_of(_tokens(cfg.vocab_size, CAP_S), CAP_S)
                forward_and_grads(model, dp, batch, key)
                with force_mesh_axes(names):
                    short = batch_of(_tokens(cfg.vocab_size, S), S)
                try:
                    model.forward(dp, {"tokens": short["tokens"]})
                    meta[f"{key}/short"] = "ran"
                except ValueError as e:
                    meta[f"{key}/short"] = f"ValueError: {e}"
        finally:
            del os.environ["REPRO_MOE_IMPL"]
    dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(work, "out.npz"), **out)
        with open(os.path.join(work, "meta.json"), "w") as f:
            json.dump(meta, f)


def _jflat(tree) -> dict:
    import jax

    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _references(jparams: dict) -> dict:
    """The JAX package's logits, loss, gradients and decode logits of each
    arch, one MoE layer's output, and granite's capacity run."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.models import moe as jmoe

    def forward_and_grads(jmodel, p, toks, s):
        jb = {"tokens": jnp.asarray(toks[:, :s]), "labels": jnp.asarray(toks[:, 1:s + 1])}
        logits, _ = jax.jit(lambda p, b: jmodel.forward(p, b))(p, {"tokens": jb["tokens"]})
        (loss, _), grads = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b),
                                                      has_aux=True))(p, jb)
        return {"logits": np.asarray(logits), "loss": float(loss), "grads": _jflat(grads)}

    ref = {}
    for arch in ARCHS:
        cfg = jget_config(arch).reduced()
        jmodel = jbuild_model(cfg)
        toks = _tokens(cfg.vocab_size, S)
        ref[arch] = forward_and_grads(jmodel, jparams[arch], toks, S)
        cache = jmodel.init_cache(B, DECODE_STEPS)
        step = jax.jit(jmodel.decode_step)
        steps = []
        for i in range(DECODE_STEPS):
            got, cache = step(jparams[arch], cache, {"token": jnp.asarray(toks[:, i]),
                                                     "index": jnp.int32(i)})
            steps.append(np.asarray(got))
        ref[arch]["decode"] = np.stack(steps, 1)
        p = _moe_layer(jparams[arch])
        x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
        y, aux = jmoe.apply_moe(p, jnp.asarray(x), top_k=cfg.top_k, act=cfg.act, impl="dense")
        ref[arch]["layer_y"], ref[arch]["layer_aux"] = np.asarray(y), float(aux)
    cfg = jget_config(CAPACITY_ARCH).reduced()
    prev = os.environ.get("REPRO_MOE_IMPL")
    os.environ["REPRO_MOE_IMPL"] = "capacity"
    try:
        ref["capacity"] = forward_and_grads(jbuild_model(cfg), jparams[CAPACITY_ARCH],
                                            _tokens(cfg.vocab_size, CAP_S), CAP_S)
    finally:
        if prev is None:
            del os.environ["REPRO_MOE_IMPL"]
        else:
            os.environ["REPRO_MOE_IMPL"] = prev
    return ref


def _unsharded(arrays: dict) -> dict:
    """The unsharded port's logits, loss and gradients of each arch."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import mamba
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad

    prev, mamba.CHUNK = mamba.CHUNK, CHUNK
    try:
        got = {}
        for arch in ARCHS:
            cfg = get_config(arch).reduced()
            model = build_model(cfg)
            params = params_from_numpy(_unflatten(arrays[arch]), "cpu")
            toks = _tokens(cfg.vocab_size, S)
            batch = {"tokens": torch.from_numpy(toks[:, :S]),
                     "labels": torch.from_numpy(toks[:, 1:])}
            logits, _ = model.forward(params, {"tokens": batch["tokens"]})
            (loss, _), grads = value_and_grad(model, params, batch, "full")
            got[arch] = {"logits": logits.numpy(), "loss": float(loss),
                         "grads": {k: g.numpy() for k, g in _flat(grads).items()}}
        return got
    finally:
        mamba.CHUNK = prev


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's init written for the workers; the two workers' run
    (output to files, both killed on a timeout); the references."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model

    work = str(tmp_path_factory.mktemp("moe"))
    jparams, arrays = {}, {}
    for i, arch in enumerate(ARCHS):
        jparams[arch] = jbuild_model(jget_config(arch).reduced()).init(jax.random.PRNGKey(30 + i))
        arrays[arch] = _jflat(jparams[arch])
        np.savez(os.path.join(work, f"{arch}.npz"), **arrays[arch])
    env = {k: v for k, v in os.environ.items() if k != "REPRO_MOE_IMPL"}
    env["PYTHONPATH"] = SRC
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import test_torch_moe_shards as t; "
            "t._worker(int(sys.argv[1]), sys.argv[2])")
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), work], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        ref = _references(jparams)  # while the workers run
        unsharded = _unsharded(arrays)
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"rank{r}.log")) as f:
            assert p.returncode == 0, f.read()[-3000:]
    with open(os.path.join(work, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(work, "out.npz")) as z:
        out = dict(z)
    return {"meta": meta, "out": out, "ref": ref, "unsharded": unsharded}


def _hold(out: dict, key: str, want: dict) -> None:
    np.testing.assert_allclose(out[f"{key}/logits"], want["logits"], atol=ATOL_LOGITS, rtol=0)
    assert abs(float(out[f"{key}/loss"]) - want["loss"]) <= ATOL_LOGITS
    got = {k[len(f"{key}/grad/"):] for k in out if k.startswith(f"{key}/grad/")}
    assert got == set(want["grads"])
    for k, w in want["grads"].items():
        atol = RTOL_LEAF * float(np.abs(w).max())
        np.testing.assert_allclose(out[f"{key}/grad/{k}"], w, atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("against", ["reference", "unsharded"])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match(world, arch, shape, against):
    want = world["ref" if against == "reference" else "unsharded"][arch]
    _hold(world["out"], f"{_tag(shape)}/{arch}", want)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(world, arch, shape):
    got = world["out"][f"{_tag(shape)}/{arch}/decode"]
    np.testing.assert_allclose(got, world["ref"][arch]["decode"], atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(world, arch, shape):
    out, ref = world["out"], world["ref"][arch]
    key = f"{_tag(shape)}/{arch}"
    np.testing.assert_allclose(out[f"{key}/layer_y"], ref["layer_y"], atol=ATOL_LOGITS, rtol=0)
    assert abs(float(out[f"{key}/layer_aux"]) - ref["layer_aux"]) <= ATOL_LOGITS


@pytest.mark.parametrize("arch", ARCHS)
def test_no_rank_gathers_or_runs_all_experts(world, arch):
    """On (1, 2): no collective of the forward, the gradients or decode
    takes an expert weight's local block (2 of 4 experts) as its input, so
    no rank gathers another's experts; one MoE layer makes its (b s k, d)
    buffer of routed rows, the sequence whole, and no dense dispatch
    buffer, its block's (2, b, s, d) or all experts' (4, b, s, d), nor the
    whole (4, d, f) weights."""
    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    E, d, f = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    blocks = {(E // 2, d, f), (E // 2, f, d)}
    meta = world["meta"]
    key = f"1x2/{arch}"
    seen = [tuple(c) for c in meta[f"{key}/collectives"] + meta[f"{key}/layer_collectives"]]
    assert seen, "no collective recorded"
    for op, shp in seen:
        assert tuple(shp[-3:]) not in blocks, (op, shp)
    outputs = {tuple(s) for s in meta[f"{key}/layer_outputs"]}
    assert (B * S * cfg.top_k, d) in outputs
    assert (E // 2, B, S, d) not in outputs and (E, B, S, d) not in outputs
    assert not outputs & {(E, d, f), (E, f, d)}


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_capacity_under_moe_blocked_matches_reference(world, shape):
    _hold(world["out"], f"{_tag(shape)}/capacity", world["ref"]["capacity"])


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_capacity_raises_on_a_shard_shorter_than_its_block(world, shape):
    """48 tokens make one 48-token block: a rank of (1, 2) holds 24 of them
    and raises; (2, 1) keeps the sequence whole and runs."""
    got = world["meta"][f"{_tag(shape)}/capacity/short"]
    if shape == (1, 2):
        assert got.startswith("ValueError") and "multiple of the block 48" in got, got
    else:
        assert got == "ran"


def test_capacity_is_selected_by_impl_and_environment(monkeypatch):
    """``apply_moe(impl="capacity")`` and ``REPRO_MOE_IMPL=capacity`` run
    ``apply_moe_capacity``, as the reference's do; ``impl="dense"`` wins
    over the variable."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(CAPACITY_ARCH).reduced()
    gen = torch.Generator().manual_seed(2)
    p = moe.init_moe(gen, cfg.d_model, cfg.expert_d_ff, cfg.num_experts, 2, torch.float32, "cpu")
    # every token's top expert is expert 0, past its capacity of 48 of 64
    p["router"][:, 0] = 1.0
    x = torch.randn((B, 64, cfg.d_model), generator=gen).abs()
    kw = dict(top_k=cfg.top_k, act=cfg.act)
    cap_default, cap_aux = moe.apply_moe_capacity(p, x, **kw)
    dense, _ = moe.apply_moe(p, x, impl="dense", **kw)
    assert not torch.equal(cap_default, dense)
    got, aux = moe.apply_moe(p, x, impl="capacity", **kw)
    assert torch.equal(got, cap_default) and torch.equal(aux, cap_aux)
    monkeypatch.setenv("REPRO_MOE_IMPL", "capacity")
    assert torch.equal(moe.apply_moe(p, x, **kw)[0], cap_default)
    assert torch.equal(moe.apply_moe(p, x, impl="dense", **kw)[0], dense)
    with pytest.raises(ValueError, match="multiple of the block"):
        moe.apply_moe_capacity(p, x[:, :48], block=32, **kw)
