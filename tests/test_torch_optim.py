"""The port's optimizer pieces on the CPU against the JAX package, on the same
numpy inputs: the cosine schedule, AdamW (clipping, bf16 params with an f32
master), gradient compression and the masked cross entropy.

Tolerances: the schedule is float32 arithmetic in the same order on both
sides: bit-equal.  AdamW sums the global norm in another order (a float32
ulp or two of the norm, 1e-6 relative) and so moves params by a few ulps
of their size: 1e-7 absolute on params of size ~0.05 after three steps
(bf16 params: one bf16 ulp of rounding on top, so they are compared through
the f32 master and then as rounded values).  Compression runs the
bit-identical int8 codec: bit-equal.  Cross entropy reduces in another
order: 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import cross_entropy as jcross_entropy
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jschedule
from repro_torch.convert import flatten_with_paths, params_from_numpy, tree_map
from repro_torch.kernels import ops
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import (AdamWConfig, apply_updates, compress_roundtrip,
                               cosine_schedule, crosspod_allgather_mean_int8, global_norm,
                               init_opt_state)

PARAM_TOL = 1e-7
NORM_RTOL = 1e-6
CE_TOL = 1e-6


def _tree(rng, scale, dtype=np.float32):
    f = lambda shape: (rng.standard_normal(shape) * scale).astype(dtype)  # noqa: E731
    return {"a": f((64, 32)), "b": {"c": f((300,)), "d": f((8, 16, 4))}, "n": f((5,))}


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _leaves_t(tree):
    return [x.float().numpy() for _, x in flatten_with_paths(tree)]


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (3, 30), (1, 4), (0, 1)])
def test_cosine_schedule_bit_equal(warmup, total):
    steps = [0, 1, 2, 3, 5, 9, 10, 29, 30, 31, 99, 100, 101, 5000, 9999, 10_000, 12_000]
    want = np.array([np.asarray(jschedule.cosine_schedule(s, warmup=warmup, total=total))
                     for s in steps])
    got = np.array([cosine_schedule(s, warmup=warmup, total=total).item() for s in steps])
    np.testing.assert_array_equal(got.astype(np.float32), want)
    assert cosine_schedule(torch.tensor(7, dtype=torch.int32)).dtype == torch.float32


def test_init_opt_state_layout_matches_reference():
    p = _tree(np.random.default_rng(0), 0.02)
    want = jadamw.init_opt_state(jax.tree.map(jnp.asarray, p))
    got = init_opt_state(params_from_numpy(p, "cpu"))
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = flatten_with_paths(got)
    assert [("/".join(str(k.key) for k in path), x.shape, str(x.dtype)) for path, x in jl] == \
        [("/".join(path), tuple(x.shape), str(x.dtype).replace("torch.", "")) for path, x in tl]
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_apply_updates_matches_reference(grad_scale):
    """Three AdamW steps on the same numpy grads, lr_scale changing per step;
    gradients of norm ~0.2 (no clipping) and ~1000 (clipped to 1.0)."""
    rng = np.random.default_rng(1)
    p = _tree(rng, 0.05)
    cfg_j, cfg_t = jadamw.AdamWConfig(lr=1e-2), AdamWConfig(lr=1e-2)
    jp = jax.tree.map(jnp.asarray, p)
    js = jadamw.init_opt_state(jp)
    tp = params_from_numpy(p, "cpu")
    ts = init_opt_state(tp)
    for it in range(3):
        g = _tree(rng, grad_scale)
        lr_scale = np.float32(0.5 + 0.25 * it)
        jp, js, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g), js, cfg_j,
                                          jnp.float32(lr_scale))
        tp, ts, tm = apply_updates(tp, params_from_numpy(g, "cpu"), ts, cfg_t,
                                   torch.tensor(lr_scale))
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=NORM_RTOL)
        assert tm["lr"].item() == float(jm["lr"])
    assert ts["step"].item() == int(js["step"]) == 3
    for got, want in zip(_leaves_t(tp), _leaves_np(jp)):
        np.testing.assert_allclose(got, want, atol=PARAM_TOL, rtol=0)
    for key in ("master", "m", "v"):
        for got, want in zip(_leaves_t(ts[key]), _leaves_np(js[key])):
            np.testing.assert_allclose(got, want, atol=PARAM_TOL, rtol=1e-6)


def test_apply_updates_bf16_params_keep_f32_master():
    rng = np.random.default_rng(2)
    p = _tree(rng, 0.05)
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), p)
    js = jadamw.init_opt_state(jp)
    tp = tree_map(lambda x: x.to(torch.bfloat16), params_from_numpy(p, "cpu"))
    ts = init_opt_state(tp)
    for _ in range(2):
        g = _tree(rng, 1e-2)
        jg = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), g)
        jp, js, _ = jadamw.apply_updates(jp, jg, js, jadamw.AdamWConfig(), 1.0)
        tp, ts, _ = apply_updates(tp, tree_map(lambda x: x.to(torch.bfloat16),
                                               params_from_numpy(g, "cpu")), ts, AdamWConfig(), 1.0)
    assert all(x.dtype == torch.bfloat16 for _, x in flatten_with_paths(tp))
    assert all(x.dtype == torch.float32 for _, x in flatten_with_paths(ts["master"]))
    for got, want in zip(_leaves_t(ts["master"]), _leaves_np(js["master"])):
        np.testing.assert_allclose(got, want, atol=PARAM_TOL, rtol=0)
    # the bf16 params are the master rounded to bf16 on both sides
    for got, want in zip(_leaves_t(tp), _leaves_np(jp)):
        np.testing.assert_allclose(got, want, atol=np.abs(want).max() * 2 ** -8, rtol=0)


def test_adamw_on_a_mixed_tree_matches_reference():
    """The MoE models' tree: bf16 params with a float32 router (the leaves,
    shapes and types of reduced granite-moe in bf16, random values crossed
    bit for bit).  The optimizer state is float32 throughout and the step
    keeps each param's type."""
    import dataclasses

    from repro.configs import get_config as jget_config
    from repro.models.model import build_model as jbuild_model

    cfg = dataclasses.replace(jget_config("granite-moe-1b-a400m").reduced(), dtype="bfloat16")
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.05).astype(x.dtype),
                      jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    js, ts = jadamw.init_opt_state(jp), init_opt_state(tp)
    for name in ("master", "m", "v"):
        assert all(x.dtype == torch.float32 for _, x in flatten_with_paths(ts[name]))
    for got, want in zip(_leaves_t(ts["master"]), _leaves_np(js["master"])):
        np.testing.assert_array_equal(got, want)
    jupdate = jax.jit(jadamw.apply_updates, static_argnums=3)
    for _ in range(2):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(x.dtype),
                         jax.tree.map(np.asarray, jp))
        jp, js, _ = jupdate(jp, jax.tree.map(jnp.asarray, g), js, jadamw.AdamWConfig(), 1.0)
        tp, ts, _ = apply_updates(tp, params_from_numpy(g, "cpu"), ts, AdamWConfig(), 1.0)
    for (path, x), y in zip(flatten_with_paths(tp), jax.tree.leaves(jp)):
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype), path
    assert tp["groups"]["b0"]["moe"]["router"].dtype == torch.float32
    for got, want in zip(_leaves_t(ts["master"]), _leaves_np(js["master"])):
        np.testing.assert_allclose(got, want, atol=PARAM_TOL, rtol=0)
    for got, want in zip(_leaves_t(tp), _leaves_np(jp)):
        np.testing.assert_allclose(got, want, atol=max(np.abs(want).max() * 2 ** -8, PARAM_TOL),
                                   rtol=0)


def test_global_norm_matches_reference():
    g = _tree(np.random.default_rng(3), 3.0)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    np.testing.assert_allclose(global_norm(params_from_numpy(g, "cpu")).item(), want, rtol=NORM_RTOL)


def test_compress_roundtrip_bit_equal():
    """Padded (300), exact-block (64 x 32 = 2048), one-block (256) and bf16
    leaves round-trip exactly as the reference's; a leaf under one block
    and an int leaf pass through untouched; no kernel is launched."""
    rng = np.random.default_rng(4)
    tree = {"pad": (rng.standard_normal(300) * 2).astype(np.float32),
            "exact": rng.standard_normal((64, 32)).astype(np.float32),
            "one": rng.standard_normal(256).astype(np.float32),
            "small": rng.standard_normal(17).astype(np.float32),
            "ints": np.arange(1000, dtype=np.int32)}
    ops.reset_launch_counts()
    got = compress_roundtrip(params_from_numpy(tree, "cpu"))
    want = jgc.compress_roundtrip(jax.tree.map(jnp.asarray, tree))
    for (path, x), w in zip(flatten_with_paths(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(w), err_msg="/".join(path))
        assert x.numpy().dtype == np.asarray(w).dtype
    assert torch.equal(got["small"], torch.from_numpy(tree["small"]))
    bf = (rng.standard_normal(512) * 2).astype(np.float32)
    got_bf = compress_roundtrip({"x": torch.from_numpy(bf).to(torch.bfloat16)})["x"]
    want_bf = jgc.compress_roundtrip({"x": jnp.asarray(bf).astype(jnp.bfloat16)})["x"]
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_bf.float().numpy(), np.asarray(want_bf.astype(jnp.float32)))
    assert not any(ops.launch_counts().values())


def test_crosspod_allgather_one_pod_equals_compress_roundtrip(tmp_path):
    """On a (1, 1, 1) ('pod', 'data', 'model') mesh over a one-rank gloo
    world, the int8 all-gather mean is the round trip itself, bit for bit;
    a leaf under one block takes the all-reduce mean (itself)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    rng = np.random.default_rng(11)
    tree = {"w": torch.from_numpy((rng.standard_normal((7, 300)) * 3).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(100).astype(np.float32))}
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        got = crosspod_allgather_mean_int8(tree, make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu"))
    finally:
        dist.destroy_process_group()
    want = compress_roundtrip(tree)
    for k in tree:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["w"], tree["w"])  # quantized
    assert torch.equal(got["b"], tree["b"])


def test_cross_entropy_masked_matches_reference():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 6] = -5
    want, jgrad = jax.value_and_grad(jcross_entropy)(jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_(True)
    got = cross_entropy(t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=CE_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=CE_TOL, rtol=CE_TOL)
    # all labels masked: 0, not NaN
    assert cross_entropy(torch.from_numpy(logits), torch.full((3, 7), -1)).item() == 0.0
