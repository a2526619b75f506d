"""The port's GRNCKPT1 checkpoints, manager and migration on the CPU against
the JAX package: byte-identical files in every mode, checkpoints that
restore across the packages, and equal migration reports."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import serializer as jser
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_config as jget_config
from repro.core.migration import migrate_job as jmigrate_job
from repro.models.model import build_model as jbuild_model
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import (bf16_words_to_f32, flatten_with_paths, host_words,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core.migration import migrate_job
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

MODES = ("full", "int8", "delta-int8")


@pytest.fixture(scope="module")
def trees():
    """Reduced micro-lm params from the JAX init, plus a perturbed copy
    (a later step) that delta-int8 encodes against the first."""
    jparams = jbuild_model(jget_config("micro-lm").reduced()).init(jax.random.PRNGKey(0))
    base = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    later = jax.tree.map(lambda a: a + (rng.standard_normal(a.shape) * 1e-3).astype(a.dtype), base)
    later["step"] = np.asarray(7, np.int32)  # a non-float leaf stays raw in every mode
    base["step"] = np.asarray(6, np.int32)
    return base, later


def _leaves(tree):
    return [(p, np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x))
            for p, x in flatten_with_paths(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg="/".join(p))


@pytest.mark.parametrize("mode", MODES)
def test_to_bytes_identical_between_packages(trees, mode):
    base, later = trees
    b = base if mode == "delta-int8" else None
    want = jser.to_bytes(jser.serialize_tree(later, mode=mode, base=b))
    got = ser.to_bytes(ser.serialize_tree(later, mode=mode, base=b, device="cpu"))
    assert got == want
    torch_tree = params_from_numpy(later, "cpu")
    assert ser.to_bytes(ser.serialize_tree(torch_tree, mode=mode, base=b, device="cpu")) == want
    assert ser.tree_bytes(torch_tree) == jser.tree_bytes(later)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_restores_in_the_other_package(tmp_path, trees, mode, writer):
    base, later = trees
    W, R = (JManager, CheckpointManager) if writer == "jax" else (CheckpointManager, JManager)
    wm = W(str(tmp_path / "w"), job="j", mode=mode)
    wm.save(1, base)
    wm.save(2, later)  # delta-int8 encodes step 2 against step 1
    raw = wm.export_bytes()
    rm = R.import_bytes(str(tmp_path / "r"), "j", 2, raw)
    # explicit base: after the second save a manager's own delta base is step 2
    restore_kw = {"base": base} if mode == "delta-int8" else {}
    if R is CheckpointManager:
        got, _ = rm.restore(params_from_numpy(later, "cpu"), device="cpu", **restore_kw)
    else:
        got, _ = rm.restore(later, **restore_kw)
    if W is CheckpointManager:
        want, _ = wm.restore(params_from_numpy(later, "cpu"), device="cpu", **restore_kw)
    else:
        want, _ = wm.restore(later, **restore_kw)
    _assert_trees_equal(got, want)
    if mode == "full":
        _assert_trees_equal(got, later)


def test_async_save_matches_sync(tmp_path, trees):
    _, later = trees
    params = params_from_numpy(later, "cpu")
    sync = CheckpointManager(str(tmp_path / "s"), mode="int8")
    asyn = CheckpointManager(str(tmp_path / "a"), mode="int8", async_save=True)
    sync.save(3, params)
    info = asyn.save(3, params)
    assert asyn.latest_bytes == sync.latest_bytes == info.nbytes > 0
    assert asyn.export_bytes() == sync.export_bytes()
    back, _ = asyn.restore(params, device="cpu")
    want, _ = sync.restore(params, device="cpu")
    _assert_trees_equal(back, want)


def test_retention_and_latest_bytes_match_reference(tmp_path, trees):
    base, later = trees
    jm = JManager(str(tmp_path / "j"), mode="delta-int8", keep=2)
    tm = CheckpointManager(str(tmp_path / "t"), mode="delta-int8", keep=2)
    for step, tree in enumerate((base, later, base)):
        jm.save(step, tree)
        tm.save(step, params_from_numpy(tree, "cpu"))
        assert tm.latest_bytes == jm.latest_bytes
    assert [i.step for i in tm._history] == [i.step for i in jm._history] == [1, 2]
    assert sorted(p.name for p in (tmp_path / "t" / "job0").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j" / "job0").iterdir())


def test_migration_report_matches_reference(tmp_path, trees):
    """Mirror of tests/test_checkpoint.py::test_migration_end_to_end: the
    same checkpoint moved by both packages gives the same report."""
    _, later = trees
    jm = JManager(str(tmp_path / "jA"), job="trainjob")
    jm.save(42, later)
    tm = CheckpointManager(str(tmp_path / "tA"), job="trainjob")
    tm.save(42, params_from_numpy(later, "cpu"))
    for bw, window in ((1e9, 2.5 * 3600), (1e6, 2.5 * 3600), (1e3, 60.0)):
        jdst, jrep = jmigrate_job(jm, str(tmp_path / f"jB{bw}"), bandwidth_bps=bw, window_s=window)
        dst, rep = migrate_job(tm, str(tmp_path / f"tB{bw}"), bandwidth_bps=bw, window_s=window)
        a, b = dataclasses.asdict(rep), dataclasses.asdict(jrep)
        a.pop("t_serialize_s"), b.pop("t_serialize_s")  # measured wall time
        assert a == b
        assert rep.t_cost_s == jrep.t_cost_s
    assert rep.workload_class == 2 and rep.feasible_in_window is False
    back, _ = dst.restore(params_from_numpy(later, "cpu"), device="cpu")
    _assert_trees_equal(back, later)
    assert params_to_numpy(back)["step"] == 7


# ---------------------------------------------------------------------------
# bfloat16 leaves: the assigned architectures' trees (bf16 params, a float32
# MoE router, float32 optimizer state)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_trees():
    """Two (base, later) pairs from the JAX init: reduced micro-lm cast to
    bf16, and reduced granite-moe in bf16 with its float32 router (a mixed
    tree), each with an int32 step leaf."""
    rng = np.random.default_rng(1)
    out = {}
    for name, arch in (("bf16", "micro-lm"), ("mixed", "granite-moe-1b-a400m")):
        cfg = dataclasses.replace(jget_config(arch).reduced(), dtype="bfloat16")
        base = jax.tree.map(np.asarray, jbuild_model(cfg).init(jax.random.PRNGKey(0)))
        later = jax.tree.map(
            lambda a: (a.astype(np.float32) + rng.standard_normal(a.shape).astype(np.float32)
                       * 1e-3).astype(a.dtype), base)
        base["step"], later["step"] = np.asarray(6, np.int32), np.asarray(7, np.int32)
        out[name] = (base, later)
    return out


def _words(x) -> np.ndarray:
    """A leaf's raw bits (bf16 as int16 words), tensor or numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return x.view(np.int16) if x.dtype.name == "bfloat16" else np.asarray(x)


def _assert_bits_equal(a, b):
    la, lb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype).removeprefix("torch."), p
        np.testing.assert_array_equal(_words(x), _words(y), err_msg="/".join(p))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_bf16_to_bytes_identical_between_packages(bf16_trees, kind, mode):
    base, later = bf16_trees[kind]
    b = base if mode == "delta-int8" else None
    want = jser.to_bytes(jser.serialize_tree(later, mode=mode, base=b))
    assert ser.to_bytes(ser.serialize_tree(later, mode=mode, base=b, device="cpu")) == want
    torch_tree = params_from_numpy(later, "cpu")
    torch_base = params_from_numpy(base, "cpu") if b is not None else None
    assert ser.to_bytes(ser.serialize_tree(torch_tree, mode=mode, base=torch_base,
                                           device="cpu")) == want
    assert ser.tree_bytes(torch_tree) == jser.tree_bytes(later)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["bf16", "mixed"])
def test_bf16_restore_bit_equal_to_reference(bf16_trees, kind, mode):
    """The same payload restored by both packages: int8 leaves rounded to
    bf16 as astype does (to nearest even), raw leaves as stored."""
    base, later = bf16_trees[kind]
    b = base if mode == "delta-int8" else None
    payload = jser.serialize_tree(later, mode=mode, base=b)
    want = jser.deserialize_tree(payload, later, base=b)
    got = ser.deserialize_tree(ser.from_bytes(jser.to_bytes(payload)), params_from_numpy(later, "cpu"),
                               base=params_from_numpy(b, "cpu") if b is not None else None,
                               device="cpu")
    _assert_bits_equal(got, want)
    if mode == "full":
        _assert_bits_equal(got, later)


def test_convert_roundtrips_bf16_bit_exactly():
    """Every one of the 65,536 bf16 bit patterns (NaNs, infinities, -0 and
    subnormals included) crosses both ways unchanged."""
    every = np.arange(1 << 16, dtype=np.uint16).view(jnp.bfloat16).reshape(256, 256)
    tree = {"a": every, "b": {"f32": np.float32([1.5, -2.25]), "step": np.int32(3)}}
    t = params_from_numpy(tree, "cpu")
    assert t["a"].dtype == torch.bfloat16 and t["b"]["f32"].dtype == torch.float32
    np.testing.assert_array_equal(t["a"].view(torch.int16).numpy(), every.view(np.int16))
    back = params_to_numpy(t)
    _assert_bits_equal(back, tree)
    _assert_bits_equal(params_from_numpy(back, "cpu"), t)
    words, name = host_words(t["a"])
    assert name == "bfloat16" and words.dtype == np.uint16
    np.testing.assert_array_equal(words, every.view(np.uint16))
    np.testing.assert_array_equal(bf16_words_to_f32(words[:8]), every[:8].astype(np.float32))


@pytest.fixture
def one_thread():
    """One intra-op thread: with several, a CPU matrix product may split its
    sums across however many threads the math library takes under the
    machine's load, so two runs of the same step can round apart (one run
    in ~40 on a loaded machine left this test's final embedding 1 bf16 ulp
    off in 22% of its elements); the comparison below is of the migration,
    not of that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_trainer_saves_migrates_and_restores(tmp_path, one_thread):
    """A bf16 Trainer (reduced granite-moe: bf16 params, float32 router,
    float32 master / m / v) trains to step 2, saves, migrates and restores
    at site B bit for bit, and finishes equal to an unmigrated run."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), dtype="bfloat16")

    def trainer(root, steps):
        t = Trainer(build_model(cfg), SyntheticLMDataset(cfg.vocab_size, 16, 2),
                    CheckpointManager(str(root), job=cfg.name),
                    TrainerConfig(total_steps=4, save_every=2, log_every=1,
                                  step_cfg=TrainStepConfig(opt=AdamWConfig(lr=3e-3), total_steps=4,
                                                           warmup_steps=1)), device="cpu")
        t.preempt_signal = lambda step: step >= steps
        return t

    ref = trainer(tmp_path / "ref", 4)
    ref.run()
    a = trainer(tmp_path / "A", 2)
    assert a.run()["status"] == "preempted"
    dst, report = migrate_job(a.ckpt, str(tmp_path / "B"), bandwidth_bps=1e9, window_s=3600.0)
    # S_j: bf16 leaves count 2 bytes each, the router and optimizer state 4
    assert report.nbytes == len(dst.export_bytes()) > ser.tree_bytes(a.state_tree())
    b = trainer(tmp_path / "B", 4)
    b.ckpt = dst
    assert b.restore() == 2
    _assert_bits_equal(b.state_tree(), a.state_tree())
    assert b.params["groups"]["b0"]["moe"]["router"].dtype == torch.float32
    assert b.params["embed"]["table"].dtype == torch.bfloat16
    b.run()
    _assert_bits_equal(b.params, ref.params)
