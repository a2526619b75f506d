"""Mamba and the mLSTM on channel shards, in a real 2-rank world on the CPU.

Two processes join a ``gloo`` world (a ``FileStore``, no network) and run
the reduced jamba-v0.1-52b and xlstm-1.3b in float32, from the JAX
package's init, on a (1, 2) ('data', 'model') mesh (the mixers' inner
channels split over 'model') and on a (2, 1) one (the batch split over
'data').  The chunk length is cut to 16 tokens in the port, so 48 tokens
run three chunks and every carried state crosses two chunk boundaries;
the reference runs one chunk (chunking changes the sums' order only).

Held against the JAX package: the logits (1e-5), the loss (1e-5) and
every gradient (1e-4) of ``value_and_grad``; decode step by step from an
empty cache placed by its pspecs (1e-5 a step); and, for a Mamba layer,
a sharded 48-token prefill's state followed by sharded decode steps
against the reference's decode of all the tokens (1e-5).  After a decode
step every recurrent state a mixer returns is placed as its pspecs say,
and no state is all-gathered: ``CommDebugMode`` counts the step's
collectives, and a recorder of the collectives' inputs finds none of a
state's local shape.  One launch of the two workers serves every test;
each worker's output goes to a file, and both are killed on a timeout.
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
ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
MESHES = ((1, 2), (2, 1))
B, S, CHUNK = 2, 48, 16
DECODE_STEPS = 6
ATOL_LOGITS, ATOL_LEAF = 1e-5, 1e-4
WORKER_TIMEOUT = 600


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


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(3).integers(0, vocab, (B, S + 1)).astype(np.int32)


def _mixer_x(d: int) -> np.ndarray:
    return np.random.default_rng(5).standard_normal((B, S + DECODE_STEPS, d)).astype(np.float32)


def _tag(shape) -> str:
    return "x".join(map(str, shape))


def _worker(rank: int, work: str) -> None:
    """One rank of the 2-rank world (run by the ``world`` fixture)."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mamba, xlstm
    from repro_torch.models.model import build_model
    from repro_torch.parallel.compat import DTensor, distribute_tensor
    from repro_torch.parallel.sharding import (
        force_mesh_axes, logical_spec, mesh_names_sizes, param_pspecs, placements, resolve_spec)
    from repro_torch.train.train_step import value_and_grad

    class Collectives(TorchDispatchMode):
        """(op name, input shape) of every functional collective."""

        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "_c10d_functional" and args and isinstance(args[0], torch.Tensor):
                self.seen.append((func.__name__.split(".")[0], tuple(args[0].shape)))
            return func(*args, **(kwargs or {}))

    mamba.CHUNK = xlstm.CHUNK = CHUNK
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), 2),
                            rank=rank, world_size=2, timeout=timedelta(minutes=3))
    out, meta = {}, {}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        names, sizes = mesh_names_sizes(mesh)

        def place(x, spec):
            if isinstance(x, dict):
                return {k: place(x[k], spec[k]) for k in x}
            return distribute_tensor(x, mesh, placements(spec, mesh), src_data_rank=None)

        def pspec_placements(t, names_):
            return placements(resolve_spec(tuple(t.shape), names_, names, sizes), mesh)

        def decode(model, cfg, dp, toks, long, key):
            """Decode from an empty cache placed by its pspecs (the
            long-context ones with ``long``: the states' channels split
            over both mesh dims); then each recurrent mixer of group 0 once
            more, directly: the state it returns, its placements and the
            collectives of the call."""
            _, pspecs = model.cache_specs(B, DECODE_STEPS, long_context=long)
            zeros = model.init_cache(B, DECODE_STEPS, device="cpu")
            with force_mesh_axes(names):
                cache = {blk: {k: distribute_tensor(zeros[blk][k], mesh, pspec_placements(
                    zeros[blk][k], pspecs[blk][k]), src_data_rank=None) for k in zeros[blk]}
                    for blk in zeros}
            steps = []
            for i in range(DECODE_STEPS):
                rec = Collectives()
                with CommDebugMode() as comm, rec:
                    got, cache = model.decode_step(dp, cache, {
                        "token": torch.from_numpy(toks[:, i]), "index": i}, long_context=long)
                steps.append(got.full_tensor().numpy())
            out[f"{key}/decode"] = np.stack(steps, 1)
            meta[f"{key}/decode_comms"] = {str(k): v for k, v in comm.get_comm_counts().items()}
            meta[f"{key}/decode_collectives"] = sorted(set(rec.seen))
            gp = _index(dp["groups"], 0)
            with force_mesh_axes(names):
                xd = distribute_tensor(torch.from_numpy(_mixer_x(cfg.d_model)[:, :1]), mesh,
                                       placements(logical_spec(None if long else "batch", None,
                                                               None), mesh), src_data_rank=None)
            states, shapes = {}, set()
            for i, kind in enumerate(cfg.block_pattern):
                blk = f"b{i}"
                if kind not in ("mamba", "mlstm"):
                    continue
                st = {k: v[0] for k, v in cache[blk].items()}
                shapes |= {tuple(v.to_local().shape) for v in st.values()}
                rec = Collectives()
                with rec:
                    if kind == "mamba":
                        _, new = mamba.apply_mamba_decode(gp[blk]["mamba"], xd, st,
                                                          d_state=cfg.mamba_d_state)
                    else:
                        _, new = xlstm.apply_mlstm(gp[blk]["mlstm"], xd, cfg.num_heads, state=st,
                                                   decode=True)
                states[blk] = all(
                    isinstance(new[k], DTensor)
                    and tuple(new[k].placements) == pspec_placements(new[k], pspecs[blk][k][1:])
                    for k in new)
                meta[f"{key}/mixer_collectives/{blk}"] = sorted(set(rec.seen))
            meta[f"{key}/state_placed_by_pspecs"] = states
            meta[f"{key}/state_local_shapes"] = sorted(shapes)

        for arch in ARCHS:
            key = f"{_tag(shape)}/{arch}"
            cfg = get_config(arch).reduced()
            model = build_model(cfg)
            with np.load(os.path.join(work, f"{arch}.npz")) as z:
                params = params_from_numpy(_unflatten(dict(z)), "cpu")
            toks = _tokens(cfg.vocab_size)
            host = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
            with force_mesh_axes(names):
                dp = place(params, param_pspecs(params, mesh=mesh))
                spec = logical_spec("batch", "seq")
                batch = make_global_batch(host, mesh, {"tokens": spec, "labels": spec})
            logits, _ = model.forward(dp, {"tokens": batch["tokens"]})
            out[f"{key}/logits"] = logits.full_tensor().numpy()
            (loss, _), grads = value_and_grad(model, dp, batch, "full")
            out[f"{key}/loss"] = np.array(float(loss.full_tensor()))
            for k, g in _flat(grads).items():
                out[f"{key}/grad/{k}"] = g.full_tensor().numpy()
            for long in (False, True):
                decode(model, cfg, dp, toks, long, f"{key}/long" if long else key)
        # a Mamba layer: a sharded prefill's state, then sharded decode steps
        cfg = get_config(ARCHS[0]).reduced()
        with np.load(os.path.join(work, f"{ARCHS[0]}.npz")) as z:
            p = params_from_numpy({k[len("groups/b0/mamba/"):]: z[k][0] for k in z.files
                                   if k.startswith("groups/b0/mamba/")}, "cpu")
        with force_mesh_axes(names):
            pd = place({"mamba": p}, param_pspecs({"mamba": p}, mesh=mesh))["mamba"]
            xs = distribute_tensor(torch.from_numpy(_mixer_x(cfg.d_model)), mesh, placements(
                logical_spec("batch", "seq", None), mesh), src_data_rank=None)
        head, state = mamba.apply_mamba(pd, xs[:, :S], d_state=cfg.mamba_d_state,
                                        return_state=True)
        ys = [head.full_tensor()]
        for t in range(S, S + DECODE_STEPS):
            y, state = mamba.apply_mamba_decode(pd, xs[:, t:t + 1], state,
                                                d_state=cfg.mamba_d_state)
            ys.append(y.full_tensor())
        out[f"{_tag(shape)}/mamba_prefill_decode"] = torch.cat(ys, 1).numpy()
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
    arch, and its Mamba layer's decode of the mixer inputs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model
    from repro.models import mamba as jmamba

    ref = {}
    for arch in ARCHS:
        cfg = jget_config(arch).reduced()
        jmodel = jbuild_model(cfg)
        toks = _tokens(cfg.vocab_size)
        jb = {"tokens": jnp.asarray(toks[:, :S]), "labels": jnp.asarray(toks[:, 1:])}
        logits, _ = jax.jit(jmodel.forward)(jparams[arch], {"tokens": jb["tokens"]})
        (loss, _), grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
            jparams[arch], jb)
        cache = jmodel.init_cache(B, DECODE_STEPS)
        step = jax.jit(jmodel.decode_step)
        steps = []
        for i in range(DECODE_STEPS):
            got, cache = step(jparams[arch], cache, {"token": jnp.asarray(toks[:, i]),
                                                     "index": jnp.int32(i)})
            steps.append(np.asarray(got))
        ref[arch] = {"logits": np.asarray(logits), "loss": float(loss), "grads": _jflat(grads),
                     "decode": np.stack(steps, 1)}
    cfg = jget_config(ARCHS[0]).reduced()
    N = cfg.mamba_d_state
    p = {k: v[0] for k, v in jparams[ARCHS[0]]["groups"]["b0"]["mamba"].items()}
    state = jmamba.init_mamba_state(B, cfg.d_model, expand=cfg.mamba_expand, d_state=N,
                                    d_conv=cfg.mamba_d_conv, dtype=jnp.float32)
    jstep = jax.jit(lambda p, x, st: jmamba.apply_mamba_decode(p, x, st, d_state=N))
    x = _mixer_x(cfg.d_model)
    ys = []
    for t in range(S + DECODE_STEPS):
        y, state = jstep(p, jnp.asarray(x[:, t:t + 1]), state)
        ys.append(np.asarray(y))
    ref["mamba_decode"] = np.concatenate(ys, 1)
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's init written for the workers; the two workers' run
    (output to files, both killed on a timeout); the references."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild_model

    work = str(tmp_path_factory.mktemp("mixers"))
    jparams = {}
    for i, arch in enumerate(ARCHS):
        jparams[arch] = jbuild_model(jget_config(arch).reduced()).init(jax.random.PRNGKey(20 + i))
        np.savez(os.path.join(work, f"{arch}.npz"), **_jflat(jparams[arch]))
    env = dict(os.environ, PYTHONPATH=SRC)
    code = (f"import sys; sys.path.insert(0, {HERE!r}); import test_torch_mixer_shards as t; "
            "t._worker(int(sys.argv[1]), sys.argv[2])")
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), work], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        ref = _references(jparams)  # while the workers run
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
        arrays = dict(z)
    return {"meta": meta, "out": arrays, "ref": ref}


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(world, arch, shape):
    out, ref = world["out"], world["ref"][arch]
    key = f"{_tag(shape)}/{arch}"
    np.testing.assert_allclose(out[f"{key}/logits"], ref["logits"], atol=ATOL_LOGITS, rtol=0)
    assert abs(float(out[f"{key}/loss"]) - ref["loss"]) <= ATOL_LOGITS
    got = {k[len(f"{key}/grad/"):] for k in out if k.startswith(f"{key}/grad/")}
    assert got == set(ref["grads"])
    for k, w in ref["grads"].items():
        np.testing.assert_allclose(out[f"{key}/grad/{k}"], w, atol=ATOL_LEAF, rtol=0, err_msg=k)


@pytest.mark.parametrize("long", [False, True], ids=["", "long"])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(world, arch, shape, long):
    """From an empty cache placed by the pspecs, or by the long-context
    ones (which change only the placements, as in the reference)."""
    got = world["out"][f"{_tag(shape)}/{arch}" + ("/long" if long else "") + "/decode"]
    np.testing.assert_allclose(got, world["ref"][arch]["decode"], atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_mamba_prefill_then_decode_matches_reference(world, shape):
    np.testing.assert_allclose(world["out"][f"{_tag(shape)}/mamba_prefill_decode"],
                               world["ref"]["mamba_decode"], atol=ATOL_LOGITS, rtol=0)


@pytest.mark.parametrize("long", [False, True], ids=["", "long"])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_states_stay_where_their_pspecs_put_them(world, arch, shape, long):
    """Every Mamba / mLSTM state a decode step returns is placed as its
    pspecs say, and no collective of the step (the whole model's, and each
    mixer's alone) takes a state's local shard as its input.  Under the
    baseline pspecs the states are whole over 'model', so the mixers run
    on whole channels; under the long-context ones their channels are
    split over both mesh dims, and ``CommDebugMode`` counts the blocks'
    all-reduces (dt, B and C; the mLSTM's C q and n q)."""
    meta = world["meta"]
    key = f"{_tag(shape)}/{arch}" + ("/long" if long else "")
    placed = meta[f"{key}/state_placed_by_pspecs"]
    assert placed and all(placed.values()), placed
    states = {tuple(s) for s in meta[f"{key}/state_local_shapes"]}
    seen = [tuple(c) for c in meta[f"{key}/decode_collectives"]]
    for blk in placed:
        seen += [tuple(c) for c in meta[f"{key}/mixer_collectives/{blk}"]]
    for op, shp in seen:
        assert not (op.startswith("all_gather") and tuple(shp) in states), (op, shp)
    comms = meta[f"{key}/decode_comms"]
    assert sum(comms.values()) > 0
    if long:
        assert any("all_reduce" in k for k in comms), comms


class _Blocks:
    """``ChannelShards``' view of block ``index`` of ``count`` without a
    process group: ``gather`` hands back the whole activation given."""

    def __init__(self, index: int, count: int, whole: torch.Tensor):
        self.index, self.count, self._whole = index, count, whole

    def gather(self, t):
        return self._whole

    @staticmethod
    def reduce(t):
        return t


@pytest.mark.parametrize("count", [2, 8])
def test_mlstm_blocks_sum_to_the_whole_block(count):
    """The mLSTM's full-sequence block on ``count`` channel blocks, one
    after another in one process: the blocks' partial outputs sum to the
    whole block's output (1e-5).  With 2 blocks each holds two whole heads;
    with 8 each holds a quarter of one head's v columns (c = 16 of d_h =
    32), the layout of xlstm-1.3b on a 16-wide 'model' axis."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.parallel.shards import Whole

    cfg = get_config("xlstm-1.3b").reduced()
    gen = torch.Generator().manual_seed(4)
    p = xlstm.init_mlstm(gen, cfg.d_model, cfg.num_heads, 2, torch.float32, "cpu")
    x = torch.from_numpy(_mixer_x(cfg.d_model)[:, :S])
    d_in = p["skip"].shape[0]
    want, _ = xlstm._mlstm(x, p, Whole, None, num_heads=cfg.num_heads, decode=False)
    xi_whole = torch.chunk(x @ p["w_up"], 2, dim=-1)[0]
    c = d_in // count
    got = torch.zeros_like(want)
    for i in range(count):
        cols = list(range(i * c, (i + 1) * c))
        local = dict(p, w_up=p["w_up"][:, cols + [d_in + j for j in cols]],
                     skip=p["skip"][i * c:(i + 1) * c], w_down=p["w_down"][i * c:(i + 1) * c])
        part, _ = xlstm._mlstm(x, local, _Blocks(i, count, xi_whole), None,
                               num_heads=cfg.num_heads, decode=False)
        got += part
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL_LOGITS, rtol=0)
