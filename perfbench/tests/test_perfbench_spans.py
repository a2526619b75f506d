"""The readers of the program's own spans and counters, on a hand-made trace:
a span's device time adds its forward and backward ranges and leaves out
the remat rerun that opens inside the backward one; a span that never ran
reads None; the MoE's useful share reads the program's row counters, and
None from a program without them."""
import sys
from types import SimpleNamespace

import pytest

from perfbench import bench
from perfbench.tests.helpers import ROOT
from perfbench.trace import Trace

SPEC = bench.load_spec(ROOT)
GRANITE, MICRO = "granite-moe-1b-a400m.train-4k", "micro-lm-100m.train-1k"
NEW = {"attn.device_ms": [GRANITE, MICRO], "ffn.device_ms": [GRANITE, MICRO],
       "head.device_ms": [GRANITE, MICRO], "moe.route_ms": [GRANITE],
       "moe.dispatch_ms": [GRANITE], "moe.experts_ms": [GRANITE], "moe.combine_ms": [GRANITE],
       "moe.useful_share": [GRANITE]}


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _kernel(corr, launched, start, dur):
    return [_x("cuda_runtime", "cudaLaunchKernel", launched, 1, correlation=corr),
            _x("kernel", f"k{corr}", start, dur, correlation=corr)]


def reader(name):
    return bench.load_module(bench.metric_file(bench.BENCH_DIR, name), "t_" + name.replace(".", "_"))


def ctx_of(events, kind="train", steps=2):
    return SimpleNamespace(trace=Trace(events), kind=kind, host={"steps_traced": steps})


def step_trace():
    """One group's forward (attention, then the MoE block with its expert
    stage), the backward of its MoE block, inside which the group's forward
    reruns, and the backward of its attention."""
    ev = [_x("user_annotation", "perfbench.window", 0, 1000),
          _x("user_annotation", "model.group", 10, 90),
          _x("user_annotation", "block.attn", 10, 30),
          _x("user_annotation", "block.ffn", 50, 40),
          _x("user_annotation", "moe.experts", 60, 20),
          _x("user_annotation", "block.ffn.bwd", 200, 300),
          _x("user_annotation", "moe.experts.bwd", 210, 280),
          _x("user_annotation", "model.group", 220, 100),  # the rerun
          _x("user_annotation", "block.attn", 225, 30),
          _x("user_annotation", "block.ffn", 260, 50),
          _x("user_annotation", "moe.experts", 270, 30),
          _x("user_annotation", "block.attn.bwd", 600, 100)]
    ev += _kernel(1, 15, 100, 4)  # forward attention
    ev += _kernel(2, 65, 110, 8)  # forward experts
    ev += _kernel(3, 55, 120, 2)  # forward MoE, outside the expert stage
    ev += _kernel(4, 230, 300, 16)  # rerun's attention
    ev += _kernel(5, 280, 320, 32)  # rerun's experts
    ev += _kernel(6, 400, 400, 64)  # experts' backward
    ev += _kernel(7, 205, 470, 128)  # MoE block's backward, outside the expert stage
    ev += _kernel(8, 650, 700, 256)  # attention's backward
    ev += _kernel(9, 800, 960, 1)  # after every span
    return ev


@pytest.mark.parametrize("name,us", [
    ("attn.device_ms", 4 + 16 + 256),  # forward + rerun + backward
    ("ffn.device_ms", 8 + 2 + 32 + 64 + 128),
    ("moe.experts_ms", 8 + 32 + 64)])
def test_a_span_adds_forward_and_backward_and_leaves_the_rerun_to_its_forward(name, us):
    got = reader(name).read(ctx_of(step_trace(), steps=2))
    assert got == pytest.approx(us / 1e3 / 2)


@pytest.mark.parametrize("name", ["moe.route_ms", "moe.dispatch_ms", "moe.combine_ms",
                                  "head.device_ms"])
def test_a_span_that_never_ran_reads_none(name):
    """So a dense cell reads no moe.*, and a program without spans none."""
    assert reader(name).read(ctx_of(step_trace())) is None
    assert reader(name).read(SimpleNamespace(trace=None, kind="train", host={})) is None


def test_the_head_adds_its_two_spans():
    ev = [_x("user_annotation", "perfbench.window", 0, 100),
          _x("user_annotation", "model.head", 10, 10),
          _x("user_annotation", "model.loss", 30, 10),
          _x("user_annotation", "model.loss.bwd", 50, 5),
          _x("user_annotation", "model.head.bwd", 60, 10)]
    ev += _kernel(1, 12, 20, 3) + _kernel(2, 32, 40, 5) + _kernel(3, 51, 56, 7) + _kernel(4, 62, 70, 11)
    assert reader("head.device_ms").read(ctx_of(ev, steps=1)) == pytest.approx(26 / 1e3)
    assert reader("head.device_ms").read(ctx_of(ev, kind="migrate")) is None


def test_useful_share_reads_the_program_counters(monkeypatch):
    from repro_torch import spans

    monkeypatch.setattr(spans, "_COUNTS", {"moe.rows_routed": 2 * 4096 * 8,
                                           "moe.rows_computed": 32 * 2 * 4096})
    ctx = SimpleNamespace(trace=None, kind="train", host={})
    assert reader("moe.useful_share").read(ctx) == 25.0
    monkeypatch.setattr(spans, "_COUNTS", {"launch.flash_attention": 4})  # a dense model
    assert reader("moe.useful_share").read(ctx) is None
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans")  # a program without counters
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert reader("moe.useful_share").read(ctx) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_the_new_entries_read_the_model_layer(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    assert entry["layer"] == "model" and entry["moves"] == "train_tokens_per_s"
    assert entry["workloads"] == NEW[name]
    assert entry["source"] == ("program_counter" if name == "moe.useful_share" else "device_trace")
    assert callable(reader(name).read)
