"""The plain reference against the port's CPU path at a small size: the
forward pass and loss, every gradient, one AdamW step, and the int8
checkpoint codec, for both of the benchmark's configurations."""

import numpy as np
import pytest
import torch

from perfbench import bench, codec
from perfbench.flows import migrate
from perfbench import data as data_lib
from perfbench.tests.helpers import few_threads, small_cell
from repro_torch.checkpoint import serializer
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_opt_state
from repro_torch.train.train_step import value_and_grad

CELLS = ("granite-moe-1b-a400m.train-4k", "micro-lm-100m.train-1k")


def setup(name, seed=7):
    few_threads()
    cell = small_cell(name)
    ref = cell.reference
    z = ref.sizes(cell.config)
    params = data_lib.draw_weights(ref.param_specs(z), seed, "cpu")
    batch = data_lib.Batches(seed, cell.mix, cell.config["vocab_size"], "cpu").batch(0)
    return cell, ref, z, params, batch


def ref_weights(params, z):
    w = {}
    for p, t in bench.leaves(params).items():
        t = t.float()
        w[p] = ([t[l].clone().requires_grad_(True) for l in range(z.layers)] if p[0] == "groups"
                else t.clone().requires_grad_(True))
    return w


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_every_gradient(name):
    cell, ref, z, params, batch = setup(name)
    model = build_model(bench.port_config(cell.config, ref))
    (loss, metrics), grads = value_and_grad(model, params, batch, "full")
    r_loss, r_ce, r_aux, r_grads, _ = ref.loss_and_grads(
        ref_weights(params, z), batch["tokens"], batch["labels"], z, rows=1)
    assert abs(float(loss) - r_loss) <= 1e-5 * abs(r_loss)
    assert abs(float(metrics["aux"]) - r_aux) <= 1e-5 * max(abs(r_aux), 1e-6)
    got = bench.leaves(grads)
    for p, g in r_grads.items():
        want = torch.stack(g) if isinstance(g, list) else g
        scale = float(want.abs().max())
        assert float((got[p].float() - want).abs().max()) <= 1e-4 * scale, p


@pytest.mark.parametrize("name", CELLS)
def test_adamw_step(name):
    cell, ref, z, params, batch = setup(name)
    model = build_model(bench.port_config(cell.config, ref))
    _, grads = value_and_grad(model, params, batch, "full")
    mix = cell.mix
    opt = init_opt_state(params)
    new, st, _ = apply_updates(params, grads, opt, AdamWConfig(
        lr=mix["lr"], b1=mix["b1"], b2=mix["b2"], eps=mix["eps"], weight_decay=mix["weight_decay"],
        clip_norm=mix["clip_norm"]), 0.5)
    state = {"master": {p: t.float().clone() for p, t in bench.leaves(params).items()},
             "m": {p: torch.zeros_like(t, dtype=torch.float32) for p, t in bench.leaves(params).items()},
             "v": {p: torch.zeros_like(t, dtype=torch.float32) for p, t in bench.leaves(params).items()},
             "step": 0}
    adam = bench.adam_of(dict(mix, warmup_steps=1, schedule_steps=1 << 30, min_lr_frac=1.0), ref)
    adam = type(adam)(**{**adam.__dict__, "lr": mix["lr"] * 0.5})
    ref.adam_step(state, {p: g.float() for p, g in bench.leaves(grads).items()}, adam)
    got = bench.leaves(st["master"])
    for p, want in state["master"].items():
        assert float((got[p] - want).abs().max()) <= 1e-6 * float(want.abs().max()), p


@pytest.mark.parametrize("name", CELLS)
def test_int8_checkpoint_codec(name, tmp_path):
    cell, ref, z, params, _ = setup(name)
    tree = {"params": params, "opt": init_opt_state(params), "step": np.int32(3)}
    tree["opt"]["m"] = {k: v for k, v in data_lib.draw_weights(
        {p: (t.shape, torch.float32, 0.01) for p, t in bench.leaves(params).items()}, 9, "cpu").items()}
    payload = serializer.serialize_tree(tree, "int8", device="cpu")
    path = tmp_path / "ckpt.bin"
    with open(path, "wb") as f:
        serializer.write_to(f, payload)
    entries = codec.leaves(*codec.read(str(path)))
    src = {"/".join(p): t for p, t in bench.leaves(tree).items()}
    assert migrate.codes_diff(entries, src, codec.quantize) == 0
    assert migrate.codes_diff(entries, src, codec.quantize_int4) > 0  # the control differs
    back = serializer.deserialize_tree(payload, tree, device="cpu")
    rest = {"/".join(p): t for p, t in bench.leaves(back).items()}
    assert migrate.restore_diff(entries, rest, "cpu") == 0
