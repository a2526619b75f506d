"""The benchmark's files against its contract: every cell and metric of
BENCHMARK.json resolves to its files, names and units keep to their
characters, the FLOP arithmetic matches the hand counts, a traffic mix is
found by name without an edit, so are a second reference and a new kind
of mix with its flow, and the trace reader's arithmetic."""
import hashlib
import json
import re
import shutil

import pytest

from perfbench import bench, flops
from perfbench.tests.helpers import ROOT
from perfbench.trace import Trace

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def config_of(name):
    return json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["perfbench"] and 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keep_their_keys_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_resolves_to_its_files():
    used = set()
    for w in SPEC["workloads"]:
        cell = bench.resolve_cell(ROOT, w["name"])
        used.add(w["config"])
        assert w["chips"] == 1
        assert cell.limits, f"no limits file for {w['name']}"
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert used == {c["name"] for c in SPEC["configs"]}


def test_every_metric_has_a_reader_and_a_bound():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        mod = bench.load_module(bench.metric_file(bench.BENCH_DIR, m["name"]), "t_" + m["name"])
        assert callable(mod.read)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        movers = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(movers.get("workloads", [w["name"] for w in SPEC["workloads"]]))


def test_config_files_hold_the_port_config():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        port = bench.port_config(cfg, bench.resolve_cell(ROOT, next(
            w["name"] for w in SPEC["workloads"] if w["config"] == c["name"])).reference)
        from repro_torch.configs import get_config

        assert port == get_config(cfg["port_arch"]), c["name"]


def test_flop_arithmetic_matches_the_hand_counts():
    g, m = config_of("granite-moe-1b-a400m"), config_of("micro-lm-100m")
    assert flops.matmul_params_per_token(g) == 428_608_512
    assert flops.matmul_params_per_token(m) == 100_270_080
    tg = flops.model_flops_per_step(g, 8, 4096)
    tm = flops.model_flops_per_step(m, 64, 1024)
    assert abs(tg / 104.06e12 - 1) < 1e-3 and abs(tm / 43.55e12 - 1) < 1e-3
    # causal attention is half the square: 3 passes x 2 products x 2 b nh hd s^2 / 2
    assert flops.attention_flops_per_step(m, 1, 2) == 3 * 2 * 2 * 8 * 64 * 4 / 2 * 20


def test_a_new_mix_is_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    spec = dict(SPEC)
    mix = json.loads((ROOT / "perfbench/mixes/train-1k.json").read_text())
    (tmp_path / "perfbench/mixes/train-2k.json").write_text(json.dumps(dict(mix, batch=32, seq=2048)))
    spec["workloads"] = SPEC["workloads"] + [dict(SPEC["workloads"][-1], name="micro-lm-100m.train-2k",
                                                  traffic="train-2k")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = bench.resolve_cell(tmp_path, "micro-lm-100m.train-2k", bench_dir=tmp_path / "perfbench")
    assert cell.mix["seq"] == 2048 and cell.mix["batch"] == 32
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before


def test_a_new_reference_and_kind_are_found_without_an_edit(tmp_path):
    """A configuration of another architecture with its own reference, under
    a mix of a new kind with its own flow: only new files and entries."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = tmp_path / "perfbench"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in bench_dir.rglob("*") if p.is_file()}
    src = (bench_dir / "references/transformer.py").read_text()
    (bench_dir / "references/biased.py").write_text(
        src + "\nPORT_FIXED = dict(PORT_FIXED, qkv_bias=True)\n")
    cfg = dict(config_of("micro-lm-100m"), name="qwen-like", port_arch="qwen1.5-32b", reference="biased")
    (bench_dir / "configs/qwen-like.json").write_text(json.dumps(cfg))
    (bench_dir / "flows/idle.py").write_text("TRACE_WINDOW = False\n\n\ndef window(run, t0, deadline):\n"
                                             "    run.live = run.trainer\n")
    mix = json.loads((bench_dir / "mixes/train-1k.json").read_text())
    (bench_dir / "mixes/idle-1k.json").write_text(json.dumps(dict(mix, kind="idle")))
    spec = dict(SPEC, configs=SPEC["configs"] + [dict(SPEC["configs"][-1], name="qwen-like",
                                                      file="perfbench/configs/qwen-like.json")])
    spec["workloads"] = SPEC["workloads"] + [dict(SPEC["workloads"][-1], name="qwen-like.idle-1k",
                                                  config="qwen-like", traffic="idle-1k")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = bench.resolve_cell(tmp_path, "qwen-like.idle-1k", bench_dir=bench_dir)
    assert cell.flow.TRACE_WINDOW is False and callable(cell.flow.window)
    assert cell.reference.PORT_FIXED["qkv_bias"] is True
    port = bench.port_config(cell.config, cell.reference)
    assert port.qkv_bias and port.num_layers == cfg["num_hidden_layers"]
    with pytest.raises(ValueError, match="qkv_bias"):  # the plain reference is refused for it
        bench.port_config(cell.config, bench.resolve_cell(ROOT, "micro-lm-100m.train-1k").reference)
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in before}
    assert after == before


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_trace_reader():
    ev = [_x("user_annotation", "perfbench.window", 0, 100),
          _x("user_annotation", "perfbench.fwd_bwd", 10, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2),
          _x("kernel", "void flash_fwd_kernel<float>(int)", 20, 10, correlation=1),
          _x("kernel", "gemm", 25, 10, correlation=2),  # overlaps: busy is a union
          _x("gpu_memcpy", "Memcpy HtoD", 80, 5, correlation=3),
          _x("cpu_op", "aten::copy_", 50, 30)]
    tr = Trace(ev)
    assert tr.window_s == 100e-6 and abs(tr.busy_s - 20e-6) < 1e-12
    assert tr.kernels("flash_fwd_kernel") == (10e-6, 1) and tr.kernels("flash_fwd") == (0.0, 0)
    assert tr.in_range("perfbench.fwd_bwd") == 10e-6 and tr.in_range("perfbench.moe") is None
    gaps = tr.idle_gaps(2)
    assert gaps[0][1] == pytest.approx(45e-6) and gaps[0][0] == "perfbench.window/aten::copy_"
    assert tr.top_ops(1)[0][0] == "void flash_fwd_kernel<float>"


def test_trace_ranges_nest_and_exclude():
    ev = [_x("user_annotation", "perfbench.window", 0, 100),
          _x("user_annotation", "perfbench.moe", 10, 50),  # a backward range ...
          _x("user_annotation", "perfbench.moe", 20, 10),  # ... holding a rerun's forward
          _x("user_annotation", "perfbench.attn", 32, 5),  # and the rerun's attention
          _x("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 33, 1, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=3),
          _x("kernel", "void (anonymous namespace)::quantize_int8_kernel<256>(float*)", 40, 2,
             correlation=1),
          _x("kernel", "void dequantize_int8_kernel(float*)", 50, 3, correlation=2),
          _x("kernel", "gemm", 60, 4, correlation=3)]
    tr = Trace(ev)
    assert tr.in_range("perfbench.moe") == pytest.approx(9e-6)
    assert tr.in_range("perfbench.moe", exclude=("perfbench.attn",)) == pytest.approx(6e-6)
    assert tr.kernels("quantize_int8_kernel") == (2e-6, 1)
    assert "void quantize_int8_kernel<256>" in [n for n, _ in tr.top_ops(3)]


def test_the_migrating_mix_kept_for_later_still_resolves():
    with pytest.raises(KeyError):
        bench.resolve_cell(ROOT, "micro-lm-100m.migrate-int8")
    cell = bench.resolve_cell(ROOT, "micro-lm-100m.migrate-int8", listed=False)
    assert cell.mix["kind"] == "migrate" and cell.limits["codes_diff"] == 0
