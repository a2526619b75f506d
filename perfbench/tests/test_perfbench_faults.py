"""Each fault a cell can have, planted under a run, turns ``correct``
false; a sound run stays correct.  Besides the faults of a step, a MoE
cell's routing: a top-k shifted by one, and a rerun that routes
otherwise.  The runs skip the look for a card and drive the rest of a run
on the CPU at a small size: the window, the migration and the comparison
with the reference."""
import pytest

from perfbench import bench, controls
from perfbench.tests.helpers import few_threads, small_cell
from repro_torch.checkpoint import serializer
from repro_torch.train import train_step

CELLS = ("micro-lm-100m.train-1k", "micro-lm-100m.migrate-int8", "granite-moe-1b-a400m.train-4k")
SEED = 2**31 + 77


def run(name, **kw):
    few_threads()
    return bench.run_cell(small_cell(name, **kw), SEED, 1.0, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(name, monkeypatch):
    real = train_step.apply_updates

    def unchanged(params, grads, state, cfg, lr_scale=1.0):
        _, new_state, metrics = real(params, grads, state, cfg, lr_scale)
        return params, {**state, "step": new_state["step"]}, metrics

    monkeypatch.setattr(train_step, "apply_updates", unchanged)
    out = run(name)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    real = train_step.value_and_grad

    def half(model, params, batch, remat_policy):
        b = batch["tokens"].shape[0] // 2
        return real(model, params, {k: v[:b] for k, v in batch.items()}, remat_policy)

    monkeypatch.setattr(train_step, "value_and_grad", half)
    out = run(name)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"]["limit"]


def test_a_restored_value_altered(monkeypatch):
    real = serializer.deserialize_tree

    def altered(payload, like, base=None, *, device=None):
        tree = real(payload, like, base, device=device)
        t = tree["opt"]["m"]["embed"]["table"]
        t.view(-1)[0] += 1e-3
        return tree

    monkeypatch.setattr(serializer, "deserialize_tree", altered)
    out = run("micro-lm-100m.migrate-int8")
    assert not out["correct"] and out["checks"]["restore_diff"]["value"] >= 1


def test_a_saved_code_altered(monkeypatch):
    real = serializer.encode_tree

    def altered(tree, mode="full", base=None, *, device=None):
        leaves = real(tree, mode, base, device=device)
        q = bytearray(leaves[0].q)
        q[0] = (q[0] + 1) % 256
        leaves[0].q = bytes(q)
        return leaves

    monkeypatch.setattr(serializer, "encode_tree", altered)
    out = run("micro-lm-100m.migrate-int8")
    assert not out["correct"] and out["checks"]["codes_diff"]["value"] >= 1


def test_a_failed_migration_is_counted(monkeypatch):
    from repro_torch.core import migration

    def broken(*a, **k):
        raise OSError("link down")

    monkeypatch.setattr(migration, "migrate_job", broken)
    out = run("micro-lm-100m.migrate-int8")
    assert not out["correct"] and out["failed"] == 1


def test_a_topk_shifted_by_one():
    """Routing that takes the (k+1)-th expert for the k-th: the reference
    follows the routes taken, so only their gap to its own routers shows it."""
    with controls.shifted_topk():
        out = run("granite-moe-1b-a400m.train-4k")
    assert not out["correct"]
    assert out["checks"]["route_gap"]["value"] > out["checks"]["route_gap"]["limit"]


def test_a_rerun_routed_otherwise(monkeypatch):
    """The backward pass's rerun of a block takes other experts than its
    forward did."""
    from repro_torch.models import moe as moe_lib

    real, calls = moe_lib.topk_stable, [0]
    layers = small_cell("granite-moe-1b-a400m.train-4k").config["num_hidden_layers"]

    def rerun_shifted(x, k):
        calls[0] += 1
        if (calls[0] - 1) // layers % 2:  # a step's second L calls are the rerun's
            vals, idx = real(x, k + 1)
            return vals[..., 1:], idx[..., 1:]
        return real(x, k)

    monkeypatch.setattr(moe_lib, "topk_stable", rerun_shifted)
    out = run("granite-moe-1b-a400m.train-4k")
    assert not out["correct"] and out["checks"]["rerun_route_diff"]["value"] >= 1
