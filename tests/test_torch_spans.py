"""The port's spans and counters (``repro_torch.spans``) on the CPU, at the
reduced granite-moe (MoE, two layers of four experts, top-2) and the
reduced micro-lm (dense), both under remat "full": every span of the
training path under ``torch.profiler``, nested as the layers nest; each
backward span opened and closed on one thread, also where an input needs
no gradient; the remat rerun's forward spans inside ``model.group``; loss
and gradients bit-identical with the profiler on and off; no autograd mark
without a profiler; the MoE's row counters on both dispatches; the kernels'
launch counters under their old keys; the checkpoint's phase spans and
byte counters on sync and async saves and their restores."""
import os
import threading
from typing import Dict, List, NamedTuple

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.checkpoint import serializer as ser
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import flatten_with_paths, tree_map
from repro_torch.core.migration import migrate_job
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

B, S = 2, 16
ARCHS = {"moe": "granite-moe-1b-a400m", "dense": "micro-lm"}
FORWARD = ("block.attn", "block.ffn", "model.head", "model.loss")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Span(NamedTuple):
    name: str
    thread: int
    start: float
    end: float

    def within(self, other: "Span") -> bool:
        return other.start <= self.start and self.end <= other.end


def profiled(fn, all_threads: bool = False):
    """(``fn()``, the program's spans recorded while it ran)."""
    kw = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)} if all_threads else {}
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn()
    got = [Span(e.name, e.thread, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.split(".")[0] in ("trainer", "train", "optim", "model", "block", "moe",
                                       "ckpt", "migrate")]
    return out, got


def named(got: List[Span], *names: str) -> List[Span]:
    return [s for s in got if s.name in names]


def inside(span: Span, parents: List[Span]) -> bool:
    return any(span.within(p) for p in parents)


def config(kind: str):
    return get_config(ARCHS[kind]).reduced()


def trainer(kind: str, root: str, **cfg) -> Trainer:
    c = config(kind)
    return Trainer(build_model(c), SyntheticLMDataset(c.vocab_size, S, B),
                   CheckpointManager(root, job="job0"),
                   TrainerConfig(total_steps=4, save_every=100, log_every=1,
                                 step_cfg=TrainStepConfig(opt=AdamWConfig(), remat_policy="full",
                                                          total_steps=4, warmup_steps=1), **cfg),
                   device="cpu")


def loss_and_grads(kind: str, params):
    c = config(kind)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLMDataset(c.vocab_size, S, B).batch(0).items()}
    live = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, _ = build_model(c).loss(live, batch, remat_policy="full")
    paths, leaves = zip(*flatten_with_paths(live))
    return loss, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.fixture(params=sorted(ARCHS))
def kind(request):
    return request.param


def test_training_spans_nest_as_the_layers(kind, tmp_path):
    t = trainer(kind, str(tmp_path))
    t.init_state()
    _, got = profiled(lambda: t.run(max_steps=1))
    step = named(got, "trainer.step")
    assert len(step) == 1
    for name in ("trainer.batch", "trainer.log", "train.fwd_bwd", "optim.adamw"):
        assert len(named(got, name)) == 1 and inside(named(got, name)[0], step), name
    fwd_bwd = named(got, "train.fwd_bwd")
    groups = named(got, "model.group")
    layers = config(kind).num_layers
    # each group's forward, then its rerun in the backward pass
    assert len(groups) == 2 * config(kind).num_groups and all(inside(g, fwd_bwd) for g in groups)
    for name in ("block.attn", "block.ffn"):
        assert len(named(got, name)) == 2 * layers and all(inside(s, groups) for s in named(got, name))
        assert len(named(got, name + ".bwd")) == layers
    for name in ("model.head", "model.loss", "model.head.bwd", "model.loss.bwd"):
        assert len(named(got, name)) == 1 and inside(named(got, name)[0], fwd_bwd), name
    moe = [s for s in got if s.name.startswith("moe.")]
    if kind == "dense":
        assert not moe
    else:
        for name in MOE:
            assert len(named(got, name)) == 2 * layers and len(named(got, name + ".bwd")) == layers
            assert all(inside(s, named(got, "block.ffn")) for s in named(got, name))
            assert all(inside(s, named(got, "block.ffn.bwd")) for s in named(got, name + ".bwd"))
    assert not [s for s in got if s.name.startswith("ckpt.")]


def test_backward_spans_close_and_the_rerun_lies_in_its_group(kind, monkeypatch):
    """Every ``.bwd`` span that opens closes on its opening thread; the
    remat rerun's forward spans, which lie inside a ``.bwd`` span, lie
    inside ``model.group`` too."""
    opened: Dict[int, int] = {}
    closed: Dict[int, int] = {}
    real_open, real_close = spans._Backward.open, spans._Backward.close

    def open_(self):
        if self.rf is None:
            opened[id(self)] = threading.get_ident()
        real_open(self)

    def close(self):
        if self.rf is not None:
            closed[id(self)] = threading.get_ident()
        real_close(self)

    monkeypatch.setattr(spans._Backward, "open", open_)
    monkeypatch.setattr(spans._Backward, "close", close)
    params = build_model(config(kind)).init(0, device="cpu")
    _, got = profiled(lambda: loss_and_grads(kind, params))
    assert opened and opened == closed
    bwd = [s for s in got if s.name.endswith(".bwd")]
    assert len(bwd) == len(opened) and all(s.end >= s.start for s in bwd)
    rerun = [s for s in got if s.name in FORWARD + MOE and inside(s, bwd)]
    assert rerun and all(inside(s, named(got, "model.group")) for s in rerun)


def test_a_backward_span_closes_where_the_input_needs_no_grad():
    w = torch.randn(4, 3, requires_grad=True)
    x = torch.randn(2, 4)  # data: no gradient
    closure = torch.randn(4, 3, requires_grad=True)

    def run():
        y = spans.call("t.some_inputs", lambda x, w: x @ w, x, w)
        z = spans.call("t.no_input", lambda x: x @ closure, x)  # a closure's weight only
        (y.sum() + z.sum()).backward()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    names = [e.name for e in prof.events()]
    assert names.count("t.some_inputs.bwd") == 1 and "t.no_input" in names
    assert "t.no_input.bwd" not in names  # nothing could close it, so it never opens
    assert w.grad is not None and closure.grad is not None


def test_loss_and_grads_bit_identical_with_the_profiler_on_and_off(kind):
    params = build_model(config(kind)).init(0, device="cpu")
    off_loss, off = loss_and_grads(kind, params)
    (on_loss, on), _ = profiled(lambda: loss_and_grads(kind, params))
    assert torch.equal(off_loss, on_loss)
    assert off.keys() == on.keys() and all(torch.equal(off[p], on[p]) for p in off)


def _graph_nodes(root) -> set:
    seen, todo, names = set(), [root], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_no_mark_in_the_graph_without_a_profiler(kind):
    c = config(kind)
    params = tree_map(lambda x: x.requires_grad_(True), build_model(c).init(0, device="cpu"))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLMDataset(c.vocab_size, S, B).batch(0).items()}
    marks = {"_OpenBackward", "_CloseBackward"}
    loss, _ = build_model(c).loss(params, batch, remat_policy="none")
    assert not _graph_nodes(loss.grad_fn) & marks
    (loss, _), _ = profiled(lambda: build_model(c).loss(params, batch, remat_policy="none"))
    assert _graph_nodes(loss.grad_fn) >= marks


@pytest.mark.parametrize("impl", ["dense", "capacity"])
def test_moe_row_counters(impl):
    """rows routed over rows computed: 1 on the dense dispatch, computed
    dropless on the b s top_k routed rows; b s top_k over b nb E C on the
    capacity one."""
    E, k, d, s = 4, 2, 8, 32
    p = moe_lib.init_moe(torch.Generator().manual_seed(0), d, 16, E, 2, torch.float32, "cpu")
    x = torch.randn(B, s, d)
    spans.reset("moe.")
    moe_lib.apply_moe(p, x, top_k=k, act="silu", impl=impl)
    got = spans.counts()
    if impl == "dense":
        assert got["moe.rows_computed"] == B * s * k and got["moe.rows_routed"] == B * s * k
        assert got["moe.rows_routed"] / got["moe.rows_computed"] == 1
    else:
        cap = int(max(1, min(s, round(s * k / E * 1.5))))  # one block of min(256, s)
        assert got["moe.rows_computed"] == B * 1 * E * cap and got["moe.rows_routed"] == B * s * k
    spans.reset("moe.")
    assert "moe.rows_computed" not in spans.counts()


def test_launch_counts_keep_their_keys():
    ops.reset_launch_counts()
    spans.count("moe.rows_routed", 3)
    assert ops.launch_counts() == {name: 0 for name in (
        "flash_attention", "flash_attention_bf16", "flash_attention_bwd",
        "flash_attention_bwd_bf16", "quantize_int8", "dequantize_int8", "decide_dest",
        "grouped_gemm", "moe_rows")}
    spans.count("launch.quantize_int8")
    spans.count("launch.flash_attention_bwd_bf16", 2)
    got = ops.launch_counts()
    assert got["quantize_int8"] == 1 and got["flash_attention_bwd_bf16"] == 2
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0} and spans.counts()["moe.rows_routed"] >= 3
    spans.reset("moe.")


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_checkpoint_phase_spans_and_bytes(async_save, tmp_path):
    """A save's phases lie inside a ``ckpt.save`` of their own thread (the
    writer's under ``async_save``), a restore's inside ``ckpt.restore``;
    the byte counters are the state's raw size and the file's."""
    params = build_model(config("dense")).init(0, device="cpu")
    state = {"params": params, "step": torch.zeros((), dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path / "a"), job="j", mode="int8", async_save=async_save)
    spans.reset("ckpt.")

    def save_and_restore():
        info = mgr.save(3, state)
        mgr.wait()
        dst, _ = migrate_job(mgr, str(tmp_path / "b"))
        return info, dst.restore(state, device="cpu")

    (info, (tree, _)), got = profiled(save_and_restore, all_threads=True)
    saves, restore = named(got, "ckpt.save"), named(got, "ckpt.restore")
    for name in ("ckpt.to_host", "ckpt.quantize", "ckpt.compress", "ckpt.write"):
        [phase] = named(got, name)
        assert inside(phase, [s for s in saves if s.thread == phase.thread]), name
    writer = {named(got, n)[0].thread for n in ("ckpt.compress", "ckpt.write")}
    caller = {named(got, n)[0].thread for n in ("ckpt.to_host", "ckpt.quantize")}
    assert (writer != caller) == async_save and len(saves) == 1 + async_save
    assert len(restore) == 1
    for name in ("ckpt.read", "ckpt.inflate", "ckpt.to_device"):
        assert named(got, name) and all(inside(s, restore) for s in named(got, name)), name
    assert len(named(got, "migrate.export")) == len(named(got, "migrate.import")) == 1
    counted = spans.counts()
    assert counted["ckpt.bytes_written"] == os.path.getsize(info.path) == info.nbytes
    assert counted["ckpt.bytes_state"] == ser.tree_bytes(state)
    assert [(p, a.shape, a.dtype) for p, a in flatten_with_paths(tree)] == \
        [(p, a.shape, a.dtype) for p, a in flatten_with_paths(state)]
    spans.reset("ckpt.")
