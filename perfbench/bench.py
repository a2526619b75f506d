"""One run of one benchmark cell: set-up, the measured window, the traced
readings, and the comparison with the plain reference that decides
``correct``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``perfbench/configs/<config>.json``, with the plain reference its
``reference`` key names under ``perfbench/references/``) under a traffic
mix (``perfbench/mixes/<traffic>.json``), whose ``kind`` names the flow
that drives the window (``perfbench/flows/<kind>.py``).  Every metric is
read by its own file, ``perfbench/metrics/<name>.py``, whose ``read(ctx)``
returns a number or None; the limits of the comparison are
``perfbench/limits/<cell>.json``.  So a cell, a mix, a flow, a reference or
a metric is added by adding files and entries.

The program under test is the PyTorch port (``repro_torch``).  Set-up
builds its ``Trainer`` as ``repro_torch.launch.train`` does, hands it the
benchmark's weights and batches and drives its first steps (the steps the
reference follows); the flow then drives the same trainer through the
window.

A flow module has ``TRACE_WINDOW`` (whether a ``--trace 1`` run profiles
the window itself, or ``trace_steps`` more steps after it) and
``window(run, t0, deadline)``, which sets ``run.live`` and ``run.hist``; it
may have ``prepare(run)`` (more set-up), ``after_first(run)`` (what
``controls.py`` drives in place of the window), ``readings(run, readings)``
(numbers of its own, and more stretches for the reference to follow) and
``control_readings(run)`` (its numbers for the control).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch

BENCH_DIR = Path(__file__).resolve().parent
# the precision below each stated one: the control of the comparison
CONTROL = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# Finding a cell's files by name
# ---------------------------------------------------------------------------


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def metric_file(bench_dir: Path, name: str) -> Path:
    return bench_dir / "metrics" / f"{name}.py"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict  # the configuration file's contents
    mix: dict
    limits: Optional[dict]
    end_to_end: List[dict]  # the spec's metrics this cell reports
    per_layer: List[dict]
    reference: object  # the reference module
    flow: object  # the flow module of the mix's kind


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(root: Path, name: str, bench_dir: Path = BENCH_DIR, listed: bool = True) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json.  With ``listed``
    false, a cell the file does not list is made from its name,
    ``<config>.<traffic>``, and the files of that configuration and mix (how
    ``controls.py`` and the tests run a mix kept for a later PR)."""
    spec = load_spec(root)
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is not None:
        cfile = root / next(c for c in spec["configs"] if c["name"] == wl["config"])["file"]
    elif listed:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    else:
        config_name, traffic = name.rsplit(".", 1)
        wl = {"name": name, "config": config_name, "traffic": traffic, "chips": 1}
        cfile = bench_dir / "configs" / f"{config_name}.json"
    config = json.loads(cfile.read_text())
    mix = json.loads((bench_dir / "mixes" / f"{wl['traffic']}.json").read_text())
    lim_path = bench_dir / "limits" / f"{name}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else None
    ref = load_module(bench_dir / "references" / f"{config['reference']}.py",
                      f"perfbench_reference_{config['reference']}")
    flow = load_module(bench_dir / "flows" / f"{mix['kind']}.py", f"perfbench_flow_{mix['kind']}")
    return Cell(name, wl, config, mix, limits,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], ref, flow)


# ---------------------------------------------------------------------------
# The program's configuration and trainer, built from the files
# ---------------------------------------------------------------------------

def port_config(config: dict, ref):
    """The port's ModelConfig of a configuration file: the port's
    architecture ``port_arch`` with the file's sizes (``ref.port_fields``),
    refused where it differs from what the reference implements
    (``ref.PORT_FIXED``)."""
    from repro_torch.configs import get_config

    base = get_config(config["port_arch"])
    for k, v in ref.PORT_FIXED.items():
        if getattr(base, k) != v:
            raise ValueError(f"{base.name}: {k}={getattr(base, k)!r}; the reference needs {v!r}")
    over = ref.port_fields(config)
    if over.get("head_dim") == base.resolved_head_dim:
        over["head_dim"] = base.head_dim  # the port's 0 means d_model / heads
    return dataclasses.replace(base, **over)


class Control:
    """When the job is told to stop: the preemption time (None: never)."""

    def __init__(self):
        self.preempt_at = None

    def __call__(self, step: int) -> bool:
        return self.preempt_at is not None and time.perf_counter() >= self.preempt_at


def make_trainer(cell: Cell, model, data, root: str, device, control, ckpt=None):
    """A Trainer as ``launch/train.py::main`` builds one, with the mix's
    optimizer and schedule; no periodic save, no end of the step budget.
    ``ckpt`` (default: a new manager at ``root``) is its checkpoint manager."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mix = cell.mix
    mode = mix.get("ckpt_mode", "full")
    ckpt = ckpt or CheckpointManager(root, job=cell.config["name"], mode=mode)
    return Trainer(
        model, data, ckpt,
        TrainerConfig(
            total_steps=1 << 40, save_every=1 << 40, ckpt_mode=mode, log_every=1 << 40,
            step_cfg=TrainStepConfig(
                opt=AdamWConfig(lr=mix["lr"], b1=mix["b1"], b2=mix["b2"], eps=mix["eps"],
                                weight_decay=mix["weight_decay"], clip_norm=mix["clip_norm"]),
                remat_policy=mix["remat"], total_steps=mix["schedule_steps"],
                warmup_steps=mix["warmup_steps"])),
        preempt_signal=control, device=device, generator=torch.Generator(device=device))


def adam_of(mix: dict, ref):
    return ref.Adam(lr=mix["lr"], b1=mix["b1"], b2=mix["b2"], eps=mix["eps"],
                    weight_decay=mix["weight_decay"], clip_norm=mix["clip_norm"],
                    warmup=mix["warmup_steps"], total=mix["schedule_steps"],
                    min_frac=mix["min_lr_frac"])


# ---------------------------------------------------------------------------
# Readings of the program's state (per-leaf norms, float64 sums)
# ---------------------------------------------------------------------------


def leaves(tree) -> Dict[Tuple[str, ...], torch.Tensor]:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out[path] = node

    walk(tree, ())
    return out


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.detach().double()))


def diff_norms(a: dict, b: dict) -> Dict[tuple, float]:
    la, lb = leaves(a), leaves(b)
    return {p: float(torch.linalg.vector_norm(la[p].double() - lb[p].double())) for p in la}


def grad_norms_from_m(m_after: dict, m_before: Optional[dict], b1: float) -> Dict[tuple, float]:
    """Each leaf's norm of the clipped gradient the optimizer took, from
    its first moment: m' = b1 m + (1 - b1) g."""
    la = leaves(m_after)
    lb = leaves(m_before) if m_before is not None else {}
    out = {}
    for p, x in la.items():
        g = x.double() if p not in lb else x.double() - b1 * lb[p].double()
        out[p] = float(torch.linalg.vector_norm(g)) / (1 - b1)
    return out


@contextlib.contextmanager
def record_routes(store: list):
    """Inside, every MoE top-k selection of the program also appends its
    experts (uint8) to ``store``."""
    from repro_torch.models import moe as moe_lib

    real = moe_lib.topk_stable

    def choose(x, k):
        vals, idx = real(x, k)
        store.append(idx.to(torch.uint8))
        return vals, idx

    moe_lib.topk_stable = choose
    try:
        yield
    finally:
        moe_lib.topk_stable = real


# ---------------------------------------------------------------------------
# Ranges for the traced run, opened from the benchmark's own files
# ---------------------------------------------------------------------------


class _Mark(torch.autograd.Function):
    """Identity whose backward opens (``open_``) or closes the range held
    by ``holder``: the MoE block's backward runs between its output's mark
    and its input's."""

    @staticmethod
    def forward(ctx, x, holder, open_):
        ctx.holder, ctx.open_ = holder, open_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.open_:
            ctx.holder["rf"] = torch.profiler.record_function("perfbench.moe").__enter__()
        elif ctx.holder.get("rf") is not None:
            ctx.holder.pop("rf").__exit__(None, None, None)
        return g, None, None


@contextlib.contextmanager
def traced_ranges():
    """Ranges around the program's loss-and-gradient, optimizer update,
    attention calls, MoE blocks (forward and backward) and checkpoint save.
    Under remat the backward pass of a MoE block reruns the whole layer
    group's forward inside the block's backward range: its attention lies
    in a "perfbench.attn" range there, which the MoE reading leaves out."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer

    real = (ts.value_and_grad, ts.apply_updates, moe_lib.apply_moe, Trainer.save,
            attn_lib.apply_attention)

    def ranged(name, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return wrapped

    def moe_ranged(p, x, **k):
        holder = {}
        if torch.is_grad_enabled() and x.requires_grad:
            x = _Mark.apply(x, holder, False)
        with torch.profiler.record_function("perfbench.moe"):
            y, aux = real[2](p, x, **k)
        if torch.is_grad_enabled() and y.requires_grad:
            y = _Mark.apply(y, holder, True)
        return y, aux

    ts.value_and_grad = ranged("perfbench.fwd_bwd", real[0])
    ts.apply_updates = ranged("perfbench.optimizer", real[1])
    moe_lib.apply_moe = moe_ranged
    Trainer.save = ranged("perfbench.save", real[3])
    attn_lib.apply_attention = ranged("perfbench.attn", real[4])
    try:
        yield
    finally:
        (ts.value_and_grad, ts.apply_updates, moe_lib.apply_moe, Trainer.save,
         attn_lib.apply_attention) = real


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


def rel_gap(got: List[float], want: List[float]) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def leaf_gap(got: Dict[tuple, float], want: Dict[tuple, float], skip=()) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(want.values())
    return max(abs(got[p] - w) / max(w, med) for p, w in want.items() if p not in skip)


def quiet_leaves(grads: Dict[tuple, float]) -> set:
    """Leaves whose reference gradient is nought to rounding: under a
    thousandth of the median leaf's."""
    med = statistics.median(grads.values())
    return {p for p, g in grads.items() if g < 1e-3 * med}


def stretch_gaps(prog: dict, ref: dict, prefix: str = "") -> Dict[str, float]:
    """The numbers of a stretch of three steps: losses, the first step's
    clipped gradient, the parameters' change after the three; with MoE the
    ``route_gap`` of the routes taken, against the reference's routers."""
    skip = quiet_leaves(ref["grad"])
    out = {prefix + "loss_gap": rel_gap(prog["losses"], ref["losses"]),
           prefix + "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
           prefix + "change_gap": leaf_gap(prog["change"], ref["change"], skip)}
    if ref.get("route_gap") is not None:
        out[prefix + "route_gap"] = ref["route_gap"]
    return out


def reference_stretch(cell: Cell, state: dict, batches, device, *, precision="f32", routes=None):
    """The reference's three steps from ``state`` ({"master", "m", "v":
    {path: f32 tensor}, "step"}): losses, each leaf's norm of the first
    clipped gradient and of the change of the master after the steps."""
    ref = cell.reference
    z = ref.sizes(cell.config)
    dtypes = {p: dt for p, (_, dt, _) in ref.param_specs(z).items()}
    start = {p: t.clone() for p, t in state["master"].items()}
    out = ref.train_steps(state, batches, z, adam_of(cell.mix, ref), dtypes, precision=precision,
                          routes=routes, rows=cell.mix["reference_rows"])
    return {"losses": out["losses"], "grad": {p: norm(g) for p, g in out["grads"].items()},
            "change": {p: float(torch.linalg.vector_norm((state["master"][p] - start[p]).double()))
                       for p in start},
            "routes": out["routes"], "route_gap": out["route_gap"]}


def fresh_state(cell: Cell, seed: int, device) -> dict:
    """The reference's state at step 0: the benchmark's weights as float32
    masters, zero moments."""
    from perfbench import data as data_lib

    ref = cell.reference
    specs = ref.param_specs(ref.sizes(cell.config))
    w = leaves(data_lib.draw_weights(specs, seed, device))
    master = {p: t.float() for p, t in w.items()}
    return {"master": master, "m": {p: torch.zeros_like(t) for p, t in master.items()},
            "v": {p: torch.zeros_like(t) for p, t in master.items()}, "step": 0}


def batch_list(data, steps) -> list:
    return [(data.batch(s)["tokens"], data.batch(s)["labels"]) for s in steps]


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _log(msg: str):
    print(msg, flush=True)


def program_first_steps(trainer, cell: Cell, n: int, moe: bool):
    """Drive the trainer's first ``n`` steps through ``Trainer.run``, one a
    call, and read what the comparison needs: each step's loss, the first
    step's gradient norms (from its first moment), the masters' change
    after the ``n``; with MoE, the experts each step routed to and the
    tokens its backward pass's rerun routed otherwise."""
    w0 = trainer.params
    store: list = []
    routes, losses, grad = [], [], None
    ctx = record_routes(store) if moe else contextlib.nullcontext()
    with ctx:
        for i in range(n):
            store.clear()
            trainer.run(max_steps=1)
            losses.append(trainer.history[-1]["loss"])
            if i == 0:
                grad = grad_norms_from_m(trainer.opt_state["m"], None, cell.mix["b1"])
            if moe:
                L = cell.config["num_hidden_layers"]
                fwd = torch.stack(store[:L])
                if len(store) == 2 * L:  # the forward rerun in the backward pass
                    mismatch = int((torch.stack(store[L:][::-1]) != fwd).any(-1).sum())
                else:  # no rerun (0), or one that is not a top-k a layer (every token)
                    mismatch = 0 if len(store) == L else fwd[0, ..., 0].numel() * L
                routes.append((fwd, mismatch))
    return {"losses": losses, "grad": grad, "change": diff_norms(trainer.opt_state["master"], w0),
            "routes": routes}


@dataclasses.dataclass
class Run:
    """What a flow drives and hands on: the program's trainer and the
    benchmark's inputs, then the window's outcome."""
    cell: Cell
    seed: int
    dev: torch.device
    model: object
    data: object
    trainer: object
    control: Control
    work: Path
    host: dict
    first: dict  # program_first_steps' readings
    traced: bool = False  # the window runs under the profiler
    live: object = None  # the trainer at the window's end
    hist: list = dataclasses.field(default_factory=list)  # the window's steps
    attempted: int = 0  # beyond the window's steps
    failed: int = 0
    held: dict = dataclasses.field(default_factory=dict)  # the flow's, for its comparison
    notes: dict = dataclasses.field(default_factory=dict)  # the flow's, for the metric readers


def set_up(cell: Cell, seed: int, dev, work: Path, host: dict, t_process: float) -> Run:
    """The program's trainer on the benchmark's weights and batches, driven
    through its first steps.  ``host["setup_marks"]``: seconds from
    ``t_process`` to the end of each part."""
    marks = host["setup_marks"] = {"called": time.perf_counter() - t_process}
    from perfbench import data as data_lib
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import init_opt_state

    marks["repro_torch"] = time.perf_counter() - t_process
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        torch.empty(0, device=dev)
        marks["cuda_context"] = time.perf_counter() - t_process
        _build.load()  # the kernel library: built here only on a checkout's first run
        marks["kernels"] = time.perf_counter() - t_process
    ref = cell.reference
    z = ref.sizes(cell.config)
    model = build_model(port_config(cell.config, ref))
    weights = data_lib.draw_weights(ref.param_specs(z), seed, dev)
    _sync(dev)
    marks["weights"] = time.perf_counter() - t_process
    data = data_lib.Batches(seed, cell.mix, cell.config["vocab_size"], dev)
    marks["batches"] = time.perf_counter() - t_process
    control = Control()
    trainer = make_trainer(cell, model, data, str(work / "site_a"), dev, control)
    trainer.params, trainer.opt_state, trainer.step = weights, init_opt_state(weights), 0
    del weights
    first = program_first_steps(trainer, cell, cell.mix["checked_steps"], z.moe)
    marks["first_steps"] = time.perf_counter() - t_process
    return Run(cell, seed, dev, model, data, trainer, control, work, host, first)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_process: Optional[float] = None, workdir: Optional[str] = None) -> dict:
    """One run; returns the result line's object."""
    from perfbench import flops
    from repro_torch.device import resolve
    from repro_torch.kernels import ops

    t_process = time.perf_counter() if t_process is None else t_process
    dev = resolve(device)
    mix, cfg, flow = cell.mix, cell.config, cell.flow
    work = Path(workdir or tempfile.mkdtemp(prefix="perfbench-"))
    work.mkdir(parents=True, exist_ok=True)
    host: dict = {"tokens_per_step": mix["batch"] * mix["seq"],
                  "model_flops_per_step": flops.model_flops_per_step(cfg, mix["batch"], mix["seq"]),
                  "dtype": cfg["torch_dtype"]}
    try:
        run = set_up(cell, seed, dev, work, host, t_process)
        if hasattr(flow, "prepare"):
            flow.prepare(run)
        _sync(dev)
        if dev.type == "cuda":
            peak_setup = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()

        # -- the window -------------------------------------------------------
        run.traced = trace and flow.TRACE_WINDOW
        prof = _profiler(dev) if run.traced else contextlib.nullcontext()
        with prof, (traced_ranges() if run.traced else contextlib.nullcontext()), \
                _range("perfbench.window", run.traced):
            t0 = time.perf_counter()
            host["setup_s"] = t0 - t_process
            flow.window(run, t0, t0 + seconds)
            t1 = time.perf_counter()
        host["window_s"] = t1 - t0
        host["steps"] = len(run.hist)
        attempted = run.attempted + len(run.hist)
        failed = run.failed + sum(1 for h in run.hist if not math.isfinite(h["loss"]))
        launches = ops.launch_counts()
        if dev.type == "cuda":
            host["peak_window_bytes"] = torch.cuda.max_memory_allocated(dev)
            host["peak_bytes"] = max(peak_setup, host["peak_window_bytes"])

        # -- the traced readings ----------------------------------------------
        tr_obj = None
        if trace and dev.type == "cuda":
            if not run.traced:
                with _profiler(dev) as prof, traced_ranges(), _range("perfbench.window", True):
                    for _ in range(mix["trace_steps"]):
                        with torch.profiler.record_function("perfbench.step"):
                            run.live.run(max_steps=1)
                    _sync(dev)
                host["steps_traced"] = mix["trace_steps"]
            else:
                host["steps_traced"] = host["steps"]
            path = work / "trace.json"
            prof.export_chrome_trace(str(path))
            from perfbench.trace import Trace

            tr_obj = Trace.from_file(str(path))
            path.unlink()

        # -- the comparison with the reference ----------------------------------
        checks = compare(run)
        ctx = SimpleNamespace(cell=cell, config=cfg, mix=mix, kind=mix["kind"], host=host,
                              notes=run.notes, trace=tr_obj, flops=flops)
        metrics = read_metrics(cell, ctx, trace)
        out = {"correct": failed == 0 and all(v <= lim for v, lim in checks.values()),
               "attempted": attempted, "failed": failed, "metrics": metrics,
               "device": device_info(dev, host, tr_obj)}
        if tr_obj is not None:
            out["breakdown"] = {"device_ops": tr_obj.top_ops(10), "idle_gaps": tr_obj.idle_gaps(10)}
        out["host"] = host
        out["launches"] = launches
        out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


@contextlib.contextmanager
def _range(name: str, on: bool):
    if on:
        with torch.profiler.record_function(name):
            yield
    else:
        yield


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclasses.dataclass
class Stretch:
    """Steps of the program that the reference follows: the program's
    readings of them (``program_first_steps``' keys), the reference's state
    to start from, the steps' batches, the routes to take (None: its own)."""
    prefix: str
    program: dict
    state: Callable[[], dict]
    steps: range
    routes: Optional[List[torch.Tensor]] = None


def compare(run: Run) -> Dict[str, Tuple[float, float]]:
    """{name: (reading, limit)}.  Frees the program's state before the
    reference runs; leaves the stretches the reference followed in
    ``run.held["stretches"]``."""
    cell, dev, mix, first = run.cell, run.dev, run.cell.mix, run.first
    readings: Dict[str, float] = {}
    if first["routes"]:  # tokens the backward pass's rerun routed otherwise than the forward
        readings["rerun_route_diff"] = float(sum(r[1] for r in first["routes"]))
    routes = [r[0].long() for r in first["routes"]] or None
    shape = (mix["batch"], mix["seq"])
    if routes is not None and any(tuple(r.shape[1:3]) != shape for r in routes):
        _log(f"[check] the program routed {[tuple(r.shape) for r in routes]} for batches of {shape}")
        routes = None  # the reference routes by itself
    stretches = [Stretch("", first, lambda: fresh_state(cell, run.seed, dev),
                         range(mix["checked_steps"]), routes)]
    if hasattr(cell.flow, "readings"):
        stretches += cell.flow.readings(run, readings)
    # the program's state goes before the reference runs
    for t in (run.trainer, run.live):
        if t is not None:
            t.params = t.opt_state = None
    run.held.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    for s in stretches:
        ref = reference_stretch(cell, s.state(), batch_list(run.data, s.steps), dev, routes=s.routes)
        readings.update(stretch_gaps(s.program, ref, s.prefix))
    run.host["reference_s"] = time.perf_counter() - t_ref
    run.held["stretches"] = stretches
    limits = cell.limits or {}
    return {k: (v, limits.get(k, float("nan"))) for k, v in readings.items()}


def read_metrics(cell: Cell, ctx, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = load_module(metric_file(BENCH_DIR, m["name"]), "perfbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_info(dev, host: dict, tr) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
           "memory_peak_bytes": host["peak_bytes"]}
    if tr is not None:
        out["busy_s"] = tr.busy_s
        out["window_s"] = tr.window_s
    return out


def card_lines(dev) -> List[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return [f"[card] {line}" for line in out.stdout.strip().splitlines()]
    except (OSError, subprocess.SubprocessError) as err:
        return [f"[card] nvidia-smi unavailable: {err!r}"]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
