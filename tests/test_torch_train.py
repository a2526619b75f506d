"""The port's training path on the CPU against the JAX package, at the reduced
micro-lm (2 layers, d 64, vocab 256) on batches of 4 x 32 tokens, with the
JAX init carried across (``convert.params_from_numpy``) or through GRNCKPT1
files: the attention backward, the loss and its gradients under each remat
policy, train steps, the trainer's lifecycle across packages and across a
restart, the launcher, and chip_smoke's training lifecycle.

Tolerances (measured gaps in brackets):
  * attention gradients, float32: 1e-5 of each gradient's largest element
    (1.5e-6: sums in another order); bf16 rows: 2e-2 of it, the repo's
    bf16 tolerance (1.5e-3: bf16 rounds in other places);
  * loss 1e-6 relative (one float32 ulp); loss gradients 1e-5 of each
    leaf's largest element (5.3e-7);
  * train steps: loss and grad norm 1e-6 relative (an ulp); params within
    lr of the reference, the most one AdamW step moves an element whose
    near-zero gradient differs in sign, and at most 1e-3 of the elements
    farther than 1e-6 (4.9e-6 and 3e-5 of them after three steps);
  * a restart or a migration inside the port: equal;
  * the reduced micro-lm in bfloat16 (the other assigned architectures'
    type): loss 2e-3 relative, gradients 2e-2 of each leaf's largest
    element, the repo's bf16 tolerance (1.5e-5 and 8.0e-3: bf16 rounds in
    other places)."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.kernels import ref as jref
from repro.models.model import build_model as jbuild_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import TrainStepConfig as JTrainStepConfig
from repro.train.train_step import make_eval_step as jmake_eval_step
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import (flatten_with_paths, params_from_numpy, train_state_from_numpy,
                                 train_state_to_numpy, tree_map)
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_launcher
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig, make_eval_step, make_train_step
from repro_torch.train.train_step import value_and_grad
from test_kernels import SWEEP

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

ATTN_TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
BF16_LOSS_RTOL = 2e-3
BF16_GRAD_TOL = 2e-2
LR = 3e-3
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the test workers share the machine's cores, and
    with a thread per core each the many small ops here wait on one
    another's pools (chip_smoke's [archs] rehearsal: 27 s alone, 272 s in
    the 6-worker suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("micro-lm").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("micro-lm").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg), params


def _batch(step=0):
    return SyntheticLMDataset(256, S, B).batch(step)


def _assert_tree_close(got_tree, want_leaves, *, atol_of_max):
    for (path, got), want in zip(flatten_with_paths(got_tree), want_leaves):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol_of_max * np.abs(want).max(),
                                   rtol=0, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# Attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,t,nh,nkv,hd,mask,win,cap,dtype,tol",
                         [row for row in SWEEP if row[4] <= 128])
def test_attention_grads_match_jax_vjp(s, t, nh, nkv, hd, mask, win, cap, dtype, tol):
    """The plain backward (and autograd through ops.flash_attention on the
    CPU, which is the same computation) against jax.vjp of the reference's
    flash_attention_ref, with the same cotangent."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape in
                   ((2, s, nh, hd), (2, t, nkv, hd), (2, t, nkv, hd), (2, s, nh, hd)))
    kw = dict(mask_kind=mask, window=win, attn_softcap=cap)

    @jax.jit
    def jgrads(q, k, v, do):
        return jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, **kw), q, k, v)[1](do)

    want = jgrads(*(jnp.asarray(x).astype(dtype) for x in (q, k, v, do)))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdtype) for x in (q, k, v, do))
    got = ref.flash_attention_bwd_ref(tq, tk, tv, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, atol=ATTN_TOL[dtype] * np.abs(w).max(),
                                   rtol=0, err_msg=name)
    leaves = [x.requires_grad_(True) for x in (tq, tk, tv)]
    auto = torch.autograd.grad(ops.flash_attention(*leaves, **kw), leaves, tdo)
    assert all(torch.equal(a, g) for a, g in zip(auto, got))


def test_flash_attention_lse_plain_matches_softmax():
    """The base-2 log-sum-exp the backward reads: 2^(x - lse) with x the
    scores times log2 e sums to 1 over each row's keys."""
    rng = np.random.default_rng(1)
    q, k = (torch.from_numpy(rng.standard_normal((2, 40, 4, 16)).astype(np.float32)) for _ in range(2))
    for kw in (dict(mask_kind="causal"), dict(mask_kind="window", window=8),
               dict(mask_kind="full", attn_softcap=5.0)):
        lse = ref.flash_attention_lse_ref(q, k[:, :, :2], **kw)
        x = ref._scores(q, k[:, :, :2], kw["mask_kind"], kw.get("window", 0),
                        kw.get("attn_softcap", 0.0)) * ref.LOG2E
        p = torch.exp2(x - lse.reshape(2, 2, 2, 40)[..., None])
        np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-6)


def _plain_kernels(monkeypatch):
    """Swap the CUDA wrappers under FlashAttentionFn for plain stand-ins
    that count their calls, so the Function's plumbing runs on the CPU."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, **kw):
        calls["fwd"] += 1
        return ref.flash_attention_ref(q, k, v, **kw), ref.flash_attention_lse_ref(q, k, **kw)

    def bwd(q, k, v, o, lse, do, **kw):
        calls["bwd"] += 1
        assert o.shape == q.shape and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
        return ref.flash_attention_bwd_ref(q, k, v, do, **kw)

    monkeypatch.setattr(fa, "flash_attention_lse_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    return calls


def test_flash_attention_fn_plumbing(monkeypatch):
    """FlashAttentionFn saves K1's output and lse and hands the backward
    kernel its inputs; its grads are the plain version's, in float32 and in
    bfloat16.  Under remat "full" the forward runs again in the backward
    pass.  Any other type raises."""
    calls = _plain_kernels(monkeypatch)
    rng = np.random.default_rng(2)
    x = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).requires_grad_(True)
         for sh in ((2, 24, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16))]
    do = torch.from_numpy(rng.standard_normal((2, 24, 4, 16)).astype(np.float32))
    kw = dict(mask_kind="window", window=5, attn_softcap=3.0)
    out = fa.FlashAttentionFn.apply(*x, kw["mask_kind"], kw["window"], kw["attn_softcap"])
    got = torch.autograd.grad(out, x, do)
    want = ref.flash_attention_bwd_ref(*x, do, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert calls == {"fwd": 1, "bwd": 1}
    from torch.utils.checkpoint import checkpoint
    out = checkpoint(lambda *a: fa.FlashAttentionFn.apply(*a, "causal", 0, 0.0), *x,
                     use_reentrant=False)
    torch.autograd.grad(out, x, do)
    assert calls == {"fwd": 3, "bwd": 2}
    x16 = [t.detach().to(torch.bfloat16).requires_grad_(True) for t in x]
    out = fa.FlashAttentionFn.apply(*x16, kw["mask_kind"], kw["window"], kw["attn_softcap"])
    got = torch.autograd.grad(out, x16, do.to(torch.bfloat16))
    want = ref.flash_attention_bwd_ref(*x16, do.to(torch.bfloat16), **kw)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, w) for g, w in zip(got, want))
    assert calls == {"fwd": 4, "bwd": 3}
    with pytest.raises(NotImplementedError, match="bfloat16"):
        fa.FlashAttentionFn.apply(*(t.detach().to(torch.float16) for t in x), "causal", 0, 0.0)
    assert calls == {"fwd": 4, "bwd": 3}


def test_ops_routes_card_calls_by_grad_mode(monkeypatch):
    """On the card, a call autograd records goes through FlashAttentionFn,
    any other call (prefill, serving, no_grad) runs K1 alone."""
    seen = []
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(fa.FlashAttentionFn, "apply", lambda *a: seen.append("fn") or a[0])
    monkeypatch.setattr(fa, "flash_attention_cuda", lambda q, k, v, **kw: seen.append("k1") or q)
    q = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(q, q, q)
    ops.flash_attention(q.requires_grad_(True), q, q)
    with torch.no_grad():
        ops.flash_attention(q, q, q)
    with torch.inference_mode():
        ops.flash_attention(torch.zeros(1, 8, 2, 16), q.detach(), q.detach())
    assert seen == ["k1", "fn", "k1", "k1"]


def test_attention_bwd_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 64, 2, 32)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError):
        fa.flash_attention_lse_cuda(q, q, q)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


# ---------------------------------------------------------------------------
# Loss, train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_reference(reduced, remat):
    jcfg, jmodel, jparams, cfg, model, params = reduced
    batch = _batch()
    fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b, remat_policy=remat),
                                    has_aux=True))
    (jloss, jmetrics), jgrads = fn(jparams, jax.tree.map(jnp.asarray, batch))
    (loss, metrics), grads = value_and_grad(model, params,
                                            {k: torch.from_numpy(v) for k, v in batch.items()}, remat)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jmetrics["ce"]), rtol=LOSS_RTOL)
    assert metrics["aux"].item() == float(jmetrics["aux"]) == 0.0
    _assert_tree_close(grads, jax.tree.leaves(jgrads), atol_of_max=GRAD_TOL)
    # the params are left as they were
    assert all(not x.requires_grad for _, x in flatten_with_paths(params))


def test_lm_loss_and_grads_match_reference_bf16(reduced):
    """The reduced micro-lm in bfloat16, remat "full", from the JAX init cast
    to bf16; the bf16 params cross as float32 numpy and are cast back to
    bf16 in torch (exact: they are bf16 values)."""
    jmodel = jbuild_model(dataclasses.replace(reduced[0], dtype="bfloat16"))
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16), reduced[2])
    model = build_model(dataclasses.replace(get_config("micro-lm").reduced(), dtype="bfloat16"))
    host = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jparams)
    params = tree_map(lambda x: x.to(torch.bfloat16), params_from_numpy(host, "cpu"))
    batch = _batch()
    fn = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss(p, b, remat_policy="full"),
                                    has_aux=True))
    (jloss, _), jgrads = fn(jparams, jax.tree.map(jnp.asarray, batch))
    (loss, _), grads = value_and_grad(model, params,
                                      {k: torch.from_numpy(v) for k, v in batch.items()}, "full")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=BF16_LOSS_RTOL)
    assert all(g.dtype == torch.bfloat16 for _, g in flatten_with_paths(grads))
    _assert_tree_close(grads, jax.tree.leaves(jax.tree.map(lambda x: x.astype(jnp.float32), jgrads)),
                       atol_of_max=BF16_GRAD_TOL)


def test_eval_step_matches_reference(reduced):
    jcfg, jmodel, jparams, cfg, model, params = reduced
    batch = _batch(3)
    want = jmake_eval_step(jmodel)(jparams, jax.tree.map(jnp.asarray, batch))
    got = make_eval_step(model)(params, batch)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=LOSS_RTOL)


STEP_VARIANTS = {"plain": {}, "microbatch": dict(microbatch=2), "grad_compress": dict(grad_compress=True)}


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_train_steps_match_reference(reduced, variant):
    jcfg, jmodel, jparams, cfg, model, params = reduced
    kw = STEP_VARIANTS[variant]
    jstep = jax.jit(jmake_train_step(jmodel, JTrainStepConfig(
        opt=JAdamWConfig(lr=LR), total_steps=30, warmup_steps=3, **kw)))
    step = make_train_step(model, TrainStepConfig(opt=AdamWConfig(lr=LR), total_steps=30,
                                                  warmup_steps=3, **kw))
    jp, jo, p, o = jparams, jinit_opt_state(jparams), params, init_opt_state(params)
    for i in range(3):
        batch = _batch(i)
        jp, jo, jm = jstep(jp, jo, jax.tree.map(jnp.asarray, batch))
        p, o, m = step(p, o, batch)
        assert set(m) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=LOSS_RTOL, err_msg=key)
    assert o["step"].item() == int(jo["step"]) == 3
    far = total = 0
    for (path, got), want in zip(flatten_with_paths(p), jax.tree.leaves(jp)):
        diff = np.abs(got.numpy() - np.asarray(want))
        assert diff.max() <= LR, "/".join(path)
        far, total = far + int((diff > 1e-6).sum()), total + diff.size
    assert far <= 1e-3 * total


# ---------------------------------------------------------------------------
# Lifecycles
# ---------------------------------------------------------------------------


def _trainer(cfg, root, steps, *, mode="full", save_every=6, device="cpu"):
    return Trainer(build_model(cfg), SyntheticLMDataset(cfg.vocab_size, S, B),
                   CheckpointManager(root, job="job0", mode=mode),
                   TrainerConfig(total_steps=steps, save_every=save_every, log_every=2,
                                 ckpt_mode=mode,
                                 step_cfg=TrainStepConfig(opt=AdamWConfig(lr=LR),
                                                          total_steps=steps, warmup_steps=3)),
                   device=device)


def test_cross_package_lifecycle(reduced, tmp_path):
    """A JAX Trainer trains to step 6 and its state is saved in full and in
    int8 mode.  The port's Trainer restores each GRNCKPT1 file on the CPU and
    trains to step 12: it ends where the JAX Trainer ends from the same
    file (the full file's run is the JAX Trainer's uninterrupted run)."""
    jcfg, jmodel, jparams, cfg, model, params = reduced
    jt = JTrainer(jmodel, JDataset(jcfg.vocab_size, S, B), JManager(str(tmp_path / "jax"), job="job0"),
                  JTrainerConfig(total_steps=12, save_every=6, log_every=2,
                                 step_cfg=JTrainStepConfig(opt=JAdamWConfig(lr=LR), total_steps=12,
                                                           warmup_steps=3)))
    jt.preempt_signal = lambda step: step >= 6
    assert jt.run()["status"] == "preempted"
    files = {"full": jt.ckpt.export_bytes()}
    int8 = JManager(str(tmp_path / "jax8"), job="job0")
    int8.save(6, jt.state_tree(), mode="int8")
    files["int8"] = int8.export_bytes()
    # the state carries across through numpy too
    host = train_state_from_numpy(jax.tree.map(np.asarray, jt.state_tree()), "cpu")
    assert host["step"] == 6 and host["opt"]["step"].item() == 6
    back = train_state_to_numpy(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jt.state_tree()))):
        np.testing.assert_array_equal(a, b)

    jt.preempt_signal = lambda step: False
    jt.run()
    want = {"full": jax.tree.leaves(jt.params)}
    jt.ckpt = JManager.import_bytes(str(tmp_path / "jax8b"), "job0", 6, files["int8"])
    assert jt.restore() == 6
    jt.run()
    want["int8"] = jax.tree.leaves(jt.params)
    for mode in ("full", "int8"):
        t = _trainer(cfg, str(tmp_path / f"port_{mode}"), 12)
        t.ckpt = CheckpointManager.import_bytes(str(tmp_path / f"port_{mode}"), "job0", 6, files[mode])
        assert t.restore() == 6
        assert t.run()["status"] == "done"
        far = total = 0
        for (path, got), w in zip(flatten_with_paths(t.params), want[mode]):
            diff = np.abs(got.numpy() - np.asarray(w))
            assert diff.max() <= LR, f"{mode} {'/'.join(path)}"
            far, total = far + int((diff > 1e-6).sum()), total + diff.size
        assert far <= 1e-3 * total, mode


def test_restart_equals_uninterrupted(reduced, tmp_path):
    cfg = reduced[3]
    ref_t = _trainer(cfg, str(tmp_path / "ref"), 12)
    ref_t.run()
    a = _trainer(cfg, str(tmp_path / "a"), 12)
    a.preempt_signal = lambda step: step >= 5
    assert a.run()["status"] == "preempted"
    b = _trainer(cfg, str(tmp_path / "a"), 12)  # a crash restart: same directory
    assert b.restore() == 5
    assert b.run()["step"] == 12
    for (path, x), (_, y) in zip(flatten_with_paths(ref_t.params), flatten_with_paths(b.params)):
        assert torch.equal(x, y), "/".join(path)
    assert [r["loss"] for r in ref_t.history[-3:]] == [r["loss"] for r in b.history[-3:]]


def test_chip_smoke_lifecycle_on_cpu(reduced, tmp_path):
    """chip_smoke's training lifecycle, the sequence the card runs at full
    width, on the CPU at the reduced size: no kernel launches here, the
    counts it derives for the card, the migrated run equal to the
    unmigrated one, the loss falling."""
    cfg = reduced[3]
    res = chip_smoke.run_train_lifecycle(cfg, str(tmp_path), mode="full", grad_compress=False,
                                         device="cpu", batch=B, seq=S)
    layers = cfg.num_layers
    assert set(res.launches) == {"unmigrated", "site A", "site B restore", "site B"}
    for got, _ in res.launches.values():
        assert not any(got.values())
    assert res.launches["site A"][1] == {
        "flash_attention": 2 * layers * 12, "flash_attention_bf16": 0,
        "flash_attention_bwd": layers * 12, "flash_attention_bwd_bf16": 0, "quantize_int8": 0,
        "dequantize_int8": 0, "decide_dest": 0}
    res.launches = {k: (want, want) for k, (_, want) in res.launches.items()}
    chip_smoke.check_train_lifecycle(res)
    # int8 state saves and restores: one K2 / K3 per float leaf of params,
    # master, m, v (4 x 11); grad compression one of each per float leaf of
    # at least 256 elements per step (8 of the reduced model's 11: its norm
    # scales are smaller)
    t8 = chip_smoke.make_trainer(cfg, str(tmp_path / "int8"), steps=4, save_every=4, mode="int8",
                                 grad_compress=True, batch=B, seq=S, device="cpu")
    t8.init_state()
    assert chip_smoke.train_launches(cfg, t8, steps=4, saves=2, restores=1) == {
        "flash_attention": 2 * layers * 4, "flash_attention_bf16": 0,
        "flash_attention_bwd": layers * 4, "flash_attention_bwd_bf16": 0,
        "quantize_int8": 8 * 4 + 44 * 2,
        "dequantize_int8": 8 * 4 + 44, "decide_dest": 0}
    assert chip_smoke.saves_in(0, 12, 4) == 4 and chip_smoke.saves_in(12, 24, 4) == 4


def test_chip_smoke_remat_microbatch_and_delta_on_cpu(reduced, tmp_path, monkeypatch):
    """chip_smoke's remat "none" / "dots", micro-batch and delta-int8
    checks, the ones the card runs at full width, on the CPU at the reduced
    size, where nothing launches a kernel (the counts they derive for the
    card are held by the test above): remat "none" and "dots" give "full"'s
    loss and gradients, two micro-batches the one-batch step's, and the
    delta-int8 restore the same leaves on both sides."""
    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        return out, ops.launch_counts(), 0.0

    none = lambda *args, **kw: dict.fromkeys(ops.launch_counts(), 0)  # noqa: E731
    monkeypatch.setattr(chip_smoke, "counted", counted)
    monkeypatch.setattr(chip_smoke, "step_launches", none)
    monkeypatch.setattr(chip_smoke, "train_launches", none)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", B)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", S)
    cfg, params = reduced[3], reduced[5]
    assert not any(chip_smoke.check_remat_and_microbatch(cfg, params, "cpu").values())
    assert not any(chip_smoke.run_delta_lifecycle(cfg, str(tmp_path), "cpu").values())


def test_launch_train_on_cpu(tmp_path, capsys, monkeypatch):
    rc = train_launcher.main(["--smoke", "--steps", "4", "--batch", "2", "--seq", "16",
                              "--device", "cpu", "--ckpt-dir", str(tmp_path),
                              "--scenario", "solar-heavy", "--grad-compress", "--ckpt-mode", "int8"])
    out = capsys.readouterr().out
    assert rc == 0 and "[train] status:" in out and '"step": 4' in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--smoke", "--steps", "1"])
