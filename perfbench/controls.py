"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size (not run by the benchmark's runs):

    python3 perfbench/controls.py --workload <cell> --seeds 101,102,... --controls 3

For every seed, the program's sound readings: its first steps, and what the
mix's flow drives after them in place of the window (``after_first``),
against the float32 reference, as a run compares them.  For the first
``--controls`` seeds also the control, the reference computed in the
precision below the configuration's (TF32 for float32, fp8 for bfloat16)
in the program's place, and the fault of half the batch left out (the mean
over the rest), each against the float32 reference (``--stand-ins`` picks
them).  With MoE, for the first ``--faults`` seeds also the program with
its top-k shifted by one (the (k+1)-th expert taken for the k-th).  A step
that returns its state unchanged reads 1 by the parameters' change; a
restored value altered reads at least 1 by ``restore_diff``: neither needs
a run.  Prints one JSON line per reading.
"""
import argparse
import contextlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import bench  # noqa: E402


def program(cell, seed, dev) -> dict:
    """The program's readings against the reference (what a run compares),
    and the run, whose ``held["stretches"]`` the reference followed."""
    work = Path(tempfile.mkdtemp(prefix="perfbench-controls-"))
    try:
        run = bench.set_up(cell, seed, dev, work, {}, time.perf_counter())
        cell.flow.after_first(run)
        checks = bench.compare(run)
        return {"readings": {k: v for k, (v, _) in checks.items()}, "run": run}
    finally:
        shutil.rmtree(work, ignore_errors=True)


@contextlib.contextmanager
def shifted_topk():
    """The program's MoE routing takes the (k+1)-th expert for the k-th."""
    from repro_torch.models import moe as moe_lib

    real = moe_lib.topk_stable

    def shifted(x, k):
        vals, idx = real(x, k + 1)
        keep = [*range(k - 1), k]
        return vals[..., keep], idx[..., keep]

    moe_lib.topk_stable = shifted
    try:
        yield
    finally:
        moe_lib.topk_stable = real


def versus(cell, seed, dev, batches, *, precision="f32", half=False, state=None) -> dict:
    """The reference in ``precision`` (on half of each batch's rows with
    ``half``) in the program's place, against the float32 reference on the
    same state, routed as the stand-in routed."""
    fresh = (lambda: bench.fresh_state(cell, seed, dev)) if state is None else state
    cut = [(t[: t.shape[0] // 2], l[: l.shape[0] // 2]) for t, l in batches] if half else batches
    prog = bench.reference_stretch(cell, fresh(), cut, dev, precision=precision)
    routes = None
    if cell.reference.sizes(cell.config).moe and not half:
        routes = prog["routes"]
    ref = bench.reference_stretch(cell, fresh(), batches, dev, routes=routes)
    return bench.stretch_gaps(prog, ref)


def stand_in(cell, seed, dev, run, **kw) -> dict:
    """A stand-in's readings over every stretch the program's run compared."""
    out = {}
    for i, s in enumerate(run.held["stretches"]):
        state = None if i == 0 else s.state
        r = versus(cell, seed, dev, bench.batch_list(run.data, s.steps), state=state, **kw)
        out.update({s.prefix + k: v for k, v in r.items()})
    if "precision" in kw and hasattr(cell.flow, "control_readings"):
        out.update(cell.flow.control_readings(run))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--stand-ins", default="control,half")
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    cell = bench.resolve_cell(ROOT, args.workload, listed=False)
    dev = torch.device("cuda")
    lower = bench.CONTROL[cell.config["torch_dtype"]]
    stand_ins = {"control": ("control_" + lower, {"precision": lower}),
                 "half": ("half_batch", {"half": True})}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = program(cell, seed, dev)
        print(json.dumps({"seed": seed, "what": "program", "readings": got["readings"],
                          "s": time.perf_counter() - t0}), flush=True)
        if i < args.faults and cell.reference.sizes(cell.config).moe:
            t0 = time.perf_counter()
            with shifted_topk():
                bad = program(cell, seed, dev)
            print(json.dumps({"seed": seed, "what": "fault_shifted_topk", "readings": bad["readings"],
                              "s": time.perf_counter() - t0}), flush=True)
        if i < args.controls:
            for what, kw in (stand_ins[k] for k in args.stand_ins.split(",")):
                t0 = time.perf_counter()
                r = stand_in(cell, seed, dev, got["run"], **kw)
                print(json.dumps({"seed": seed, "what": what, "readings": r,
                                  "s": time.perf_counter() - t0}), flush=True)
        del got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
