"""What runs on the card imports neither JAX nor the JAX package, and the
plain reference imports nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""
import json
import os
import subprocess
import sys

from perfbench.tests.helpers import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_HARNESS = """
import importlib.util, json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(2)
spec = importlib.util.spec_from_file_location("perfbench_run", {run!r})
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
from perfbench import bench, codec, data, flops, trace
from perfbench.tests.helpers import small_cell
names = [w["name"] for w in bench.load_spec(bench.Path({root!r}))["workloads"]]
for n in names:
    cell = bench.resolve_cell(bench.Path({root!r}), n)
    for m in cell.end_to_end + cell.per_layer:
        bench.load_module(bench.metric_file(bench.BENCH_DIR, m["name"]), "m_" + m["name"])
for path in sorted(bench.BENCH_DIR.glob("metrics/*.py")) + sorted(bench.BENCH_DIR.glob("flows/*.py")):
    bench.load_module(path, "f_" + path.stem.replace(".", "_"))
out = bench.run_cell(small_cell("micro-lm-100m.migrate-int8"), 5, 1.0, False, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import importlib.util, json, sys
sys.path[:0] = [{root!r}]
for name in ("references/transformer.py", "codec.py", "data.py", "flops.py", "trace.py"):
    path = {bench!r} + "/" + name
    spec = importlib.util.spec_from_file_location("r_" + name.replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec); sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_metrics_and_a_run_load_no_jax():
    names = _top_names(_HARNESS.format(root=str(ROOT), src=str(ROOT / "src"),
                                       run=str(ROOT / "perfbench/run.py")))
    assert "repro_torch" in names and "perfbench" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_names(_REFERENCE.format(root=str(ROOT), bench=str(ROOT / "perfbench")))
    assert "torch" in names
    assert not names & (set(FORBIDDEN) | {"repro_torch", "perfbench"}), names


def test_run_without_a_card_exits_nonzero_with_no_result(tmp_path):
    """Here there is no card: the command fails before any set-up and prints
    no result line, in the checkout and in a copy holding only
    BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    import torch

    for root in (tmp_path,) if torch.cuda.is_available() else (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                              "micro-lm-100m.train-1k", "--seed", str(2**31 + 5), "--seconds", "1",
                              "--trace", "0"], capture_output=True, text=True, env=env,
                             cwd=str(root), timeout=300)
        assert out.returncode != 0
        assert not [line for line in out.stdout.splitlines() if line.startswith("{")]
