"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix,
metrics and limits are found by name from ``BENCHMARK.json`` (see
``perfbench/bench.py``).  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` trace.  Earlier lines give the card, its power
limit, the checkpoint's size, the kernels' launch counts; the last lines of
standard error give each number compared with the reference beside its
limit.  Without a CUDA card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result.
"""
import os
import sys
import time


def _process_start_epoch() -> float:
    """When this process started, from the kernel's record of it."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


_T_PROCESS = time.perf_counter() - (time.time() - _process_start_epoch())

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    marks = {"torch": time.perf_counter() - _T_PROCESS}
    from perfbench import bench

    marks["perfbench"] = time.perf_counter() - _T_PROCESS
    cell = bench.resolve_cell(ROOT, args.workload)
    want = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[perfbench] {args.workload} needs {want} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    marks["card_found"] = time.perf_counter() - _T_PROCESS
    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                            t_process=_T_PROCESS)
    result["host"]["setup_marks"] = {**marks, **result["host"].get("setup_marks", {})}
    for line in bench.card_lines(0):  # after the run: nvidia-smi's start-up is no set-up
        print(line, flush=True)
    bad = bench.forbidden_modules()
    if bad:
        print(f"[perfbench] the process loaded {bad}: the benchmark imports neither JAX nor "
              "the JAX package", file=sys.stderr)
        return 3
    host = result.pop("host", {})
    for k, v in host.items():
        print(f"[run] {k} {v}", flush=True)
    print(f"[run] launches {json.dumps(result['launches'])}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
