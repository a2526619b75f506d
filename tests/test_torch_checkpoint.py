"""The port's GRNCKPT1 checkpoints, manager and migration on the CPU against
the JAX package: byte-identical files in every mode, checkpoints that
restore across the packages, and equal migration reports."""
import dataclasses

import jax
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
from repro_torch.convert import flatten_with_paths, params_from_numpy, params_to_numpy
from repro_torch.core.migration import migrate_job

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
