"""The sharding layer on a real 2-rank world, on the CPU.

Two processes join a ``gloo`` world (a ``FileStore``, no network) and run
the reduced qwen3-1.7b in float32 on a 1 x 2 ('data', 'model') mesh under
the baseline rules (the sequence split over 'model'): the forward, the
loss, every gradient and one AdamW step against the unsharded port and the
JAX package (1e-5 on logits, 1e-4 per leaf); the loss and every gradient
of one model of each other block kind, and gemma2's decode over a
sequence-sharded cache, against both too; the optimizer state's
placements; ``sharded_batch``; an unsharded checkpoint restored onto the
mesh (``CheckpointManager.restore(shardings=)``) bit for bit, and saved
again from the DTensors to the same bytes; and
``crosspod_allgather_mean_int8`` over two pods against the reference's
under ``shard_map`` on 2 CPU devices.  One launch of the two workers serves
every test; the module-level worker imports no JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ARCH = "qwen3-1.7b"
B, S = 2, 32
ATOL_LOGITS, ATOL_LEAF = 1e-5, 1e-4
WORKER_TIMEOUT = 400


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


# one model of each other block kind: MoE, Mamba + MoE, mLSTM / sLSTM,
# local / global attention, the encoder-decoder
FAMILIES = ("granite-moe-1b-a400m", "jamba-v0.1-52b", "xlstm-1.3b", "gemma2-2b", "whisper-tiny")
_FAMILY_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                "frames": ("batch", None, None)}
DECODE_STEPS, DECODE_CACHE = 22, 24  # past gemma2-smoke's 16-token window


def _family_batch(cfg) -> dict:
    from repro_torch.data.pipeline import SyntheticLMDataset

    host = SyntheticLMDataset(cfg.vocab_size, S, B, seed=6).batch(0)
    if cfg.is_encdec:
        rng = np.random.default_rng(8)
        host["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return host


def _pod_grads(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"w": (rng.standard_normal((5, 300)) * (1 + rank)).astype(np.float32),
            "b": rng.standard_normal(100).astype(np.float32)}


def _family_params(work: str, arch: str) -> dict:
    """The reference's init of ``arch``'s reduced config (written by
    ``world``) as port params."""
    from repro_torch.convert import params_from_numpy

    with np.load(os.path.join(work, f"family_{arch}.npz")) as z:
        return params_from_numpy(_unflatten(dict(z)), "cpu")


def _worker(rank: int, work: str) -> None:
    """One rank of the 2-rank world (run by the ``world`` fixture)."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import SyntheticLMDataset, make_global_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.optim.grad_compress import crosspod_allgather_mean_int8
    from repro_torch.parallel.compat import DTensor, distribute_tensor
    from repro_torch.parallel.sharding import (
        force_mesh_axes, logical_spec, named_shardings, param_pspecs, placements)
    from repro_torch.train.train_step import TrainStepConfig, make_train_step, value_and_grad

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), 2),
                            rank=rank, world_size=2, timeout=timedelta(minutes=3))
    out = {}
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    with np.load(os.path.join(work, "params.npz")) as z:
        params = params_from_numpy(_unflatten(dict(z)), "cpu")
    host = SyntheticLMDataset(cfg.vocab_size, S, B, seed=4).batch(0)
    with force_mesh_axes(("data", "model")):
        spec = logical_spec("batch", "seq")
        specs = param_pspecs(params, mesh=mesh)
        def place(x, s):
            if isinstance(x, dict):
                return {k: place(x[k], s[k]) for k in x}
            return distribute_tensor(x, mesh, placements(s, mesh), src_data_rank=None)

        dparams = place(params, specs)
        batch = make_global_batch(host, mesh, {"tokens": spec, "labels": spec})
        ds = SyntheticLMDataset(cfg.vocab_size, S, B, seed=4)
        sharded = ds.sharded_batch(0, mesh, spec)
    out["sharded_batch_equal"] = all(torch.equal(sharded[k].full_tensor(), torch.from_numpy(v))
                                     for k, v in host.items())
    out["batch_placements"] = str(batch["tokens"].placements)
    logits, _ = model.forward(dparams, {"tokens": batch["tokens"]})
    out["logits"] = logits.full_tensor().numpy()
    (loss, _), grads = value_and_grad(model, dparams, batch, "full")
    out["loss"] = float(loss.full_tensor())
    for k, g in _flat(grads).items():
        out["grad/" + k] = g.full_tensor().numpy()
    opt = init_opt_state(dparams)
    opt = init_opt_state(dparams)
    flat_p = _flat(dparams)
    out["opt_mirrors"] = all(_flat(opt[part])[k].placements == v.placements
                             for part in ("m", "v", "master") for k, v in flat_p.items())
    step = make_train_step(model, TrainStepConfig(remat_policy="full"))
    p2, _, _ = step(dparams, opt, batch)
    for k, x in _flat(p2).items():
        out["step/" + k] = x.full_tensor().numpy()
    # elastic restore of the unsharded checkpoint onto the mesh, then a save
    # from the DTensors
    mgr = CheckpointManager(os.path.join(work, "ckpt"), "job0")
    like = {"params": params, "opt": init_opt_state(params), "step": np.int32(0)}
    tree, _ = mgr.restore(like, device="cpu",
                          shardings=named_shardings(param_pspecs(like, mesh=mesh), mesh))
    out["restored_dtensor"] = all(isinstance(x, DTensor) for x in _flat(tree["params"]).values())
    for k, x in _flat({"params": tree["params"], "opt": tree["opt"]}).items():
        out["restored/" + k] = x.full_tensor().numpy()
    resave = CheckpointManager(os.path.join(work, f"resave{rank}"), "job0")
    info = resave.save(3, {"params": tree["params"], "opt": tree["opt"], "step": np.int32(3)})
    out["resave_path"] = info.path
    # the other block kinds on the mesh, from the reference's init: loss and
    # every gradient, kept for the test to hold against the JAX package's,
    # and against the unsharded port (each rank computes that one locally)
    for arch in FAMILIES:
        fcfg = get_config(arch).reduced()
        fmodel = build_model(fcfg)
        fparams = _family_params(work, arch)
        fhost = _family_batch(fcfg)
        with force_mesh_axes(("data", "model")):
            fd = place(fparams, param_pspecs(fparams, mesh=mesh))
            fbatch = make_global_batch(fhost, mesh, {k: logical_spec(*_FAMILY_AXES[k][:v.ndim])
                                                     for k, v in fhost.items()})
        (dl, _), dg = value_and_grad(fmodel, fd, fbatch, "full")
        (pl, _), pg = value_and_grad(fmodel, fparams, {k: torch.from_numpy(v)
                                                       for k, v in fhost.items()}, "full")
        out[f"family/{arch}/loss"] = np.array([float(dl.full_tensor()), float(pl)])
        for k, g in _flat(dg).items():
            out[f"family/{arch}/grad/{k}"] = g.full_tensor().numpy()
        pg = _flat(pg)
        out[f"family/{arch}/grad_gap"] = np.array(max(
            float((g.full_tensor() - pg[k]).abs().max()) for k, g in _flat(dg).items()))
    # decode over a cache whose sequence is split over 'model' (the partial
    # softmax and the owner-shard writes), gemma2's ring buffer wrapping
    dcfg = get_config("gemma2-2b").reduced()
    dmodel = build_model(dcfg)
    dparams = _family_params(work, "gemma2-2b")
    toks = torch.from_numpy(_family_batch(dcfg)["tokens"][:, :DECODE_STEPS])
    with force_mesh_axes(("data", "model")):
        ddp = place(dparams, param_pspecs(dparams, mesh=mesh))
        specs, pspecs = dmodel.cache_specs(B, DECODE_CACHE)
        zeros = dmodel.init_cache(B, DECODE_CACHE, device="cpu")
        dcache = {blk: {k: distribute_tensor(zeros[blk][k], mesh, placements(
            logical_spec(*pspecs[blk][k]), mesh), src_data_rank=None) for k in zeros[blk]}
            for blk in zeros}
    out["decode_cache_placements"] = str(dcache["b0"]["k"].placements)
    pcache = dmodel.init_cache(B, DECODE_CACHE, device="cpu")
    gaps, steps = [], []
    for i in range(DECODE_STEPS):
        if i == dcfg.sliding_window:  # the caches before the ring buffer wraps
            for b in dcache:
                for k in dcache[b]:
                    out[f"decode_cache_unwrapped/{b}/{k}"] = dcache[b][k].full_tensor().numpy()
        got, dcache = dmodel.decode_step(ddp, dcache, {"token": toks[:, i], "index": i})
        want, pcache = dmodel.decode_step(dparams, pcache, {"token": toks[:, i], "index": i})
        gaps.append(float((got.full_tensor() - want).abs().max()))
        steps.append(got.full_tensor().numpy())
    out["decode_gap"] = np.array(max(gaps))
    out["decode_logits"] = np.stack(steps, 1)
    out["decode_cache_gap"] = np.array(max(
        float((dcache[b][k].full_tensor() - pcache[b][k]).abs().max())
        for b in pcache for k in pcache[b]))
    # two pods: rank r holds pod r's gradients
    pods = make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
    got = crosspod_allgather_mean_int8(
        {k: torch.from_numpy(v) for k, v in _pod_grads(rank).items()}, pods)
    for k, v in got.items():
        out["crosspod/" + k] = v.numpy()
    dist.destroy_process_group()
    if rank == 0:
        meta = {k: v for k, v in out.items() if not isinstance(v, np.ndarray)}
        np.savez(os.path.join(work, "out.npz"),
                 **{k: v for k, v in out.items() if isinstance(v, np.ndarray)})
        with open(os.path.join(work, "meta.json"), "w") as f:
            json.dump(meta, f)


@pytest.mark.parametrize("arch", FAMILIES)
def test_block_kinds_on_the_mesh_match_unsharded(world, arch):
    """Loss and every gradient of each block kind on the 1 x 2 mesh (the
    sequence split; recurrent scans, MoE routing and its aux loss on each
    rank's shard, cross-attention) against the same step unsharded and
    against the JAX package's ``value_and_grad`` of its loss, from the
    reference's init (1e-5 on the loss, 1e-4 per leaf)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro_torch.configs import get_config

    out = world["out"]
    loss = out[f"family/{arch}/loss"]
    assert abs(loss[0] - loss[1]) <= ATOL_LOGITS
    assert float(out[f"family/{arch}/grad_gap"]) <= ATOL_LEAF
    jloss, jflat = world["ref"][arch]
    assert abs(loss[0] - jloss) <= ATOL_LOGITS
    got = {k[len(f"family/{arch}/grad/"):] for k in out if k.startswith(f"family/{arch}/grad/")}
    assert got == set(jflat)
    for k, w in jflat.items():
        np.testing.assert_allclose(out[f"family/{arch}/grad/{k}"], w, atol=ATOL_LEAF, rtol=0,
                                   err_msg=k)


def test_decode_over_a_sequence_sharded_cache(world):
    """gemma2's decode with its caches' sequence split over 'model':
    every step's logits and the final caches (the ring buffer wrapped)
    within 1e-5 of the unsharded decode's (the projections' sums split
    otherwise).  Against the JAX package: its decode's logits and caches
    while the ring buffer has not wrapped (1e-5), and its full-sequence
    forward at every step (2e-4, the reference's own prefill-vs-decode
    tolerance; past the window its decode drops the wrong keys, see
    ``test_torch_archs``)."""
    out = world["out"]
    assert world["meta"]["decode_cache_placements"] == "(Shard(dim=1), Shard(dim=2))"  # (groups, b, T, ..)
    assert float(out["decode_gap"]) <= ATOL_LOGITS
    assert float(out["decode_cache_gap"]) <= ATOL_LOGITS
    steps, cache, forward = world["ref"]["decode"]
    for i, want in enumerate(steps):
        np.testing.assert_allclose(out["decode_logits"][:, i], want, atol=ATOL_LOGITS, rtol=0,
                                   err_msg=str(i))
    for k, w in cache.items():
        np.testing.assert_allclose(out["decode_cache_unwrapped/" + k], w, atol=ATOL_LOGITS,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(out["decode_logits"], forward, atol=2e-4, rtol=2e-4)


def _references(family_jparams) -> dict:
    """The JAX package's values the workers' results are held to: each
    family's loss and gradients; gemma2's decode before its ring buffer
    wraps (logits a step, the caches) and its forward over the tokens."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro_torch.configs import get_config

    ref = {}
    for arch in FAMILIES:
        jmodel = jbuild_model(jget_config(arch).reduced())
        jb = {k: jnp.asarray(v) for k, v in _family_batch(get_config(arch).reduced()).items()}
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
            family_jparams[arch], jb)
        ref[arch] = (float(jloss), _jflat(jgrads))
    cfg = get_config("gemma2-2b").reduced()
    jmodel = jbuild_model(jget_config("gemma2-2b").reduced())
    jparams = family_jparams["gemma2-2b"]
    toks = _family_batch(cfg)["tokens"][:, :DECODE_STEPS]
    jcache = jmodel.init_cache(B, DECODE_CACHE)
    jstep = jax.jit(jmodel.decode_step)
    steps = []
    for i in range(cfg.sliding_window):
        want, jcache = jstep(jparams, jcache, {"token": jnp.asarray(toks[:, i]),
                                               "index": jnp.int32(i)})
        steps.append(np.asarray(want))
    forward, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    ref["decode"] = (steps, _jflat(jcache), np.asarray(forward))
    return ref


def _jflat(tree) -> dict:
    import jax

    return {"/".join(str(k.key) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference init written for the workers, an unsharded checkpoint
    of it, the two workers' run; their outputs."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.convert import params_from_numpy
    from repro_torch.optim.adamw import init_opt_state

    work = str(tmp_path_factory.mktemp("mesh"))
    jparams = jbuild_model(jget_config(ARCH).reduced()).init(jax.random.PRNGKey(2))
    flat = _jflat(jparams)
    np.savez(os.path.join(work, "params.npz"), **flat)
    family_jparams = {}
    for i, arch in enumerate(FAMILIES):
        family_jparams[arch] = jbuild_model(jget_config(arch).reduced()).init(
            jax.random.PRNGKey(10 + i))
        np.savez(os.path.join(work, f"family_{arch}.npz"), **_jflat(family_jparams[arch]))
    params = params_from_numpy(_unflatten(flat), "cpu")
    state = {"params": params, "opt": init_opt_state(params), "step": np.int32(3)}
    info = CheckpointManager(os.path.join(work, "ckpt"), "job0").save(3, state)
    env = dict(os.environ, PYTHONPATH=SRC)
    code = f"import sys; sys.path.insert(0, {HERE!r}); import test_torch_mesh as t; t._worker(int(sys.argv[1]), sys.argv[2])"
    # each rank writes to a file: a rank that fills a pipe no one reads
    # would stall the other in a collective
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), work], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        ref = _references(family_jparams)  # while the workers run
        for p in procs:
            p.wait(timeout=WORKER_TIMEOUT)
    finally:
        for p in procs:  # neither rank outlives a timeout or a failure
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
        arrays = dict(z)
    return {"work": work, "meta": meta, "out": arrays, "jparams": jparams, "params": params,
            "saved": info.path, "state": state, "ref": ref}


def _reference_loss_grads(jparams):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.data.pipeline import SyntheticLMDataset as JData
    from repro.models import build_model as jbuild_model

    jmodel = jbuild_model(jget_config(ARCH).reduced())
    host = JData(jget_config(ARCH).reduced().vocab_size, S, B, seed=4).batch(0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    logits, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jb["tokens"]})
    (loss, _), grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    return logits, loss, grads


def test_sharded_forward_loss_and_grads_match(world):
    import jax

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten_with_paths
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad

    out = world["out"]
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    host = SyntheticLMDataset(cfg.vocab_size, S, B, seed=4).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    want_logits, _ = model.forward(world["params"], {"tokens": batch["tokens"]})
    (want_loss, _), want_grads = value_and_grad(model, world["params"], batch, "full")
    jlogits, jloss, jgrads = _reference_loss_grads(world["jparams"])
    np.testing.assert_allclose(out["logits"], want_logits.numpy(), atol=ATOL_LOGITS, rtol=0)
    np.testing.assert_allclose(out["logits"], np.asarray(jlogits), atol=ATOL_LOGITS, rtol=0)
    assert abs(world["meta"]["loss"] - float(want_loss)) <= ATOL_LOGITS
    assert abs(world["meta"]["loss"] - float(jloss)) <= ATOL_LOGITS
    jflat = _jflat(jgrads)
    port = {"/".join(p): g for p, g in flatten_with_paths(want_grads)}
    assert set(jflat) == set(port)
    for k in jflat:
        np.testing.assert_allclose(out["grad/" + k], port[k].numpy(), atol=ATOL_LEAF, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(out["grad/" + k], jflat[k], atol=ATOL_LEAF, rtol=0, err_msg=k)


def test_sharded_adamw_step_matches_unsharded(world):
    from repro_torch.configs import get_config
    from repro_torch.convert import flatten_with_paths
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.train_step import TrainStepConfig, make_train_step

    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    host = SyntheticLMDataset(cfg.vocab_size, S, B, seed=4).batch(0)
    params = world["params"]
    p2, _, _ = make_train_step(model, TrainStepConfig(remat_policy="full"))(
        params, init_opt_state(params), host)
    for path, x in flatten_with_paths(p2):
        np.testing.assert_allclose(world["out"]["step/" + "/".join(path)], x.numpy(),
                                   atol=ATOL_LEAF, rtol=0, err_msg="/".join(path))


def test_opt_state_and_batch_placements(world):
    meta = world["meta"]
    assert meta["opt_mirrors"]
    assert meta["batch_placements"] == "(Shard(dim=0), Shard(dim=1))"  # batch, seq over model


def test_sharded_batch_full_value(world):
    assert world["meta"]["sharded_batch_equal"]


def test_elastic_restore_bit_identical_and_save_bytes(world):
    from repro_torch.convert import flatten_with_paths

    meta, out = world["meta"], world["out"]
    assert meta["restored_dtensor"]
    state = world["state"]
    for path, x in flatten_with_paths({"params": state["params"], "opt": state["opt"]}):
        assert np.array_equal(out["restored/" + "/".join(path)], x.numpy()), path
    with open(world["saved"], "rb") as f, open(meta["resave_path"], "rb") as g:
        assert f.read() == g.read()


def test_crosspod_two_pods_matches_reference(world, tmp_path):
    """The reference's crosspod_allgather_mean_int8 under shard_map over a
    2-device pod mesh (a process of its own, with 2 host devices)."""
    grads = [_pod_grads(r) for r in (0, 1)]
    np.savez(tmp_path / "g.npz", **{f"{r}/{k}": v for r, g in enumerate(grads) for k, v in g.items()})
    code = f"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim.grad_compress import crosspod_allgather_mean_int8
z = np.load({str(tmp_path / "g.npz")!r})
mesh = Mesh(np.array(jax.devices()[:2]), ("pod",))
out = {{}}
for k in ("w", "b"):
    stacked = jnp.stack([jnp.asarray(z[f"0/{{k}}"]), jnp.asarray(z[f"1/{{k}}"])])
    f = shard_map(lambda g: crosspod_allgather_mean_int8({{"x": g[0]}}, "pod")["x"][None],
                  mesh=mesh, in_specs=P("pod"), out_specs=P("pod"))
    out[k] = np.asarray(f(stacked))
np.savez({str(tmp_path / "want.npz")!r}, **out)
"""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    with open(tmp_path / "ref.log", "w") as log:  # killed by run() on its timeout
        r = subprocess.run([sys.executable, "-c", code], env=env, stdout=log,
                           stderr=subprocess.STDOUT, timeout=300)
    assert r.returncode == 0, (tmp_path / "ref.log").read_text()[-3000:]
    with np.load(tmp_path / "want.npz") as want:
        for k in ("w", "b"):
            np.testing.assert_array_equal(world["out"]["crosspod/" + k], want[k][0], err_msg=k)
            np.testing.assert_array_equal(want[k][0], want[k][1])
