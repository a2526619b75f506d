"""Mesh-lowering dry-run and orchestration plan preview (port of
``repro/launch/dryrun.py``).

For every (architecture x assigned shape x mesh) cell, ``lower_cell`` runs
one step of the cell at full width and full depth on the production mesh
of a fake world (``launch/mesh.make_production_mesh``: 16 x 16 or 2 x 16 x
16 ranks in this process, whose collectives move nothing) with fake tensors
(no memory is allocated, no kernel launched): the params, the optimizer
state, the batch and the decode cache are fake DTensors placed by
``param_pspecs`` and ``Model.input_specs``; a train shape runs the train
step, a prefill shape the forward, a decode shape ``decode_step``.  One
eager pass sees every layer, so the JAX package's two-depth extrapolation
is not needed.  A ``TraceRecorder`` reads every op run on a rank's local
shards and records, per device:

* FLOPs: ``torch.utils.flop_counter``'s formulas over the local ops
  (K1's custom ops included: 4 or 10 b nh hd times the visible pairs);
* bytes: each local op's operands and results, summed (views excluded).
  This is unfused, unlike XLA's ``bytes accessed``: every elementwise op
  counts its own reads and writes;
* collective bytes by the reference's kinds, from the functional
  collectives' output shards (bytes received per device);
* argument bytes, exact (the local shards of every input);
* peak bytes: the arguments plus the most bytes of tensors made during
  the step alive at once (an own count of fake storages; the step's inputs
  stay alive to its end, where XLA would donate them).

The roofline terms divide these by NVIDIA's spec for one H100 SXM (labelled
as spec, not measured): 989e12 FLOP/s bf16 dense, 3.35e12 B/s HBM3 and
450e9 B/s NVLink 4 per direction.  A 16-wide 'model' axis spans two 8-GPU
NVLink domains, so the collective term is a lower bound.

On ``--device cuda`` (the default) the fake tensors are CUDA tensors, so
attention traces through K1's custom ops; with ``--device cpu`` the plain
versions are traced.  The fake world is process-global: ``main`` lowers a
single cell in its own process and a sweep of several cells one
subprocess per cell (a cell that extrapolates, one per traced length, at
once); artifacts go to ``--out`` (default ``build/dryrun/``).

``--plan`` materializes a registered scenario at a chosen sim-time, builds
the same ClusterState snapshot the simulator hands to policies (one shared
constructor, ``repro_torch.core.state.ClusterState.build``) and prints the
typed actions a policy would emit: a what-would-happen preview without
running the sim.  A policy that scores with the K4 decide kernel
(feasibility-aware, oracle, plan-ahead) runs it on ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --plan --scenario flaky-wan \\
      --policy feasibility-aware --at-hour 36

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.models.xlstm import CHUNK as MLSTM_CHUNK

ARTIFACT_DIR = BUILD_DIR / "dryrun"

# One NVIDIA H100 SXM, from NVIDIA's data sheet (spec, not measured).
PEAK_FLOPS = 989e12  # bf16 dense, FLOP/s
HBM_BW = 3.35e12  # HBM3, bytes/s
NVLINK_BW = 450e9  # NVLink 4, bytes/s per direction

# functional collective -> the reference's HLO kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceRecorder(TorchDispatchMode):
    """Counts, per device, what the local ops of a traced step do: FLOPs,
    operand and result bytes, collective bytes by kind and the bytes of
    tensors made under it that are alive at once (their peak).  An op on a
    DTensor is left to DTensor (``NotImplemented``), which runs its local
    ops, and those come back here.  Only ops that touch a fake tensor are
    counted, and only those of the cell's own fake mode: DTensor's
    bookkeeping is not (its sharding propagation runs on small real tensors
    and on fake global-shape tensors of a fake mode of its own)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        from repro_torch.parallel.compat import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = COLLECTIVE_KINDS.get(func.__name__.split(".")[0]) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            src = args[0] if kind == "collective-permute" else out
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(map(_nbytes, _tensors(src)))
            return out
        ins, outs = list(_tensors((args, kwargs))), list(_tensors(out))
        if not outs or not any(isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode
                               for t in ins + outs):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        view = bool(func._schema.returns) and all(
            r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)
        if not view:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            if isinstance(t, FakeTensor):
                self._track(t)
        return out


def _fake_dtensor(spec_leaf, pspec, mesh, fake, device):
    """A fake DTensor of ``spec_leaf``'s global shape and dtype, placed on
    ``mesh`` by the PartitionSpec ``pspec`` (each sharded dim divisible)."""
    from repro_torch.parallel.compat import DTensor
    from repro_torch.parallel.sharding import placements

    shape = tuple(spec_leaf.shape)
    pl = placements(pspec, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if hasattr(p, "dim"):
            n = mesh.size(i)
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {shape} does not split over {n} ({pspec})")
            local[p.dim] //= n
    with fake:
        t = torch.empty(local, dtype=spec_leaf.dtype, device=device)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _tree2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _local_bytes(tree) -> int:
    from repro_torch.parallel.compat import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    return 0


def spec_bytes(specs, pspecs, sizes: Dict[str, int]) -> int:
    """Bytes per device of a spec tree (TensorSpec or tensor leaves) placed
    by a PartitionSpec tree over mesh axes of ``sizes``: each leaf's bytes
    over the product of the sizes of the axes that split it."""
    if isinstance(specs, dict):
        return sum(spec_bytes(specs[k], pspecs[k], sizes) for k in specs)
    n = 1
    for a in pspecs:
        for x in (a if isinstance(a, tuple) else (a,)):
            n *= sizes.get(x, 1) if isinstance(x, str) else 1
    return math.prod(specs.shape) * specs.dtype.itemsize // n


def _skip_record(arch, shape_name, multi_pod):
    return {"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
            "status": "SKIP",
            "reason": "long_500k requires sub-quadratic attention"}


# An attention-free stack (xlstm-1.3b) traces its train and prefill shapes
# at two and three whole mLSTM chunks and extrapolates linearly to the
# shape's length: its sLSTM runs token by token and its mLSTM chunk by
# chunk, so a direct trace at 4,096 or 32,768 tokens takes hours.  From the
# second chunk on, every count (the peak included) grows by the same amount
# a chunk: the mLSTM's work is quadratic inside a chunk, and its first chunk
# starts from a carry with no gradient, so lengths inside the first chunk
# would not do (the JAX package extrapolates over depth the same way, from
# two traced depths).
EXTRAPOLATE_LENGTHS = (2 * MLSTM_CHUNK, 3 * MLSTM_CHUNK)


def _extrapolated(cfg, shape) -> bool:
    return shape.kind != "decode" and not any(k.startswith("attn") for k in cfg.block_pattern)


def _trace(cfg, shape, mesh, rules, *, remat_policy, grad_compress, device) -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` on fake DTensors of ``mesh``: the
    recorder's per-device counts, and the arguments' bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.layers import TensorSpec
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel.sharding import (
        force_mesh_axes, logical_spec, mesh_names_sizes, param_pspecs, use_rules,
    )
    from repro_torch.train.train_step import TrainStepConfig, make_train_step

    names, sizes = mesh_names_sizes(mesh)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    model = build_model(cfg)
    place = lambda s, ps: _fake_dtensor(s, ps, mesh, fake, device)  # noqa: E731
    with use_rules(rules), force_mesh_axes(names):
        with fake:
            gparams = model.init(0, device=device)
        pspecs = param_pspecs(gparams, rules, mesh)
        params = _tree2(lambda x, ps: place(TensorSpec(tuple(x.shape), x.dtype), ps), gparams, pspecs)
        del gparams
        batch_specs, batch_logical = model.input_specs(shape)
        batch_ps = _tree2(lambda s, names_: logical_spec(*names_), batch_specs, batch_logical)
        spec_total = spec_bytes(_shapes(params), pspecs, sizes)
        rec = TraceRecorder(fake)
        if shape.kind == "train":
            opt = init_opt_state(params)
            batch = _tree2(place, batch_specs, batch_ps)
            args = (params, opt, batch)
            spec_total += spec_bytes(_shapes(opt), param_pspecs(opt, rules, mesh), sizes)
            spec_total += spec_bytes(batch_specs, batch_ps, sizes)
            step = make_train_step(model, TrainStepConfig(remat_policy=remat_policy,
                                                          grad_compress=grad_compress))
            with rec:
                step(*args)
        elif shape.kind == "prefill":
            batch = _tree2(place, batch_specs, batch_ps)
            args = (params, batch)
            spec_total += spec_bytes(batch_specs, batch_ps, sizes)
            with rec:
                model.forward(params, batch)
        else:
            index = shape.seq_len - 1  # the last slot: every cache slot is attended
            specs = {k: v for k, v in batch_specs.items() if k != "index"}
            ps = {k: v for k, v in batch_ps.items() if k != "index"}
            inputs = _tree2(place, specs, ps)
            args = (params, dict(inputs))
            spec_total += spec_bytes(specs, ps, sizes)
            cache = inputs.pop("cache")
            with rec:
                model.decode_step(params, cache, {**inputs, "index": index},
                                  long_context=shape.name == "long_500k")
        arg_bytes = _local_bytes(args)
    return {"flops": rec.flops, "bytes": rec.bytes, "collectives": dict(rec.collectives),
            "argument_bytes": arg_bytes, "argument_spec_bytes": spec_total,
            "temp_peak_bytes": rec.peak}


def _affine(c1: Dict[str, Any], c2: Dict[str, Any], l1: int, l2: int, length: int):
    """Counts at ``length`` from counts at two lengths, each affine in it."""
    def at(v1, v2):
        return v1 + (v2 - v1) * (length - l1) // (l2 - l1)

    out = {k: at(c1[k], c2[k]) for k in c1 if k != "collectives"}
    kinds = set(c1["collectives"]) | set(c2["collectives"])
    out["collectives"] = {k: at(c1["collectives"].get(k, 0), c2["collectives"].get(k, 0))
                          for k in kinds}
    return out


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    rules=None,
    remat_policy: str = "full",
    grad_compress: bool = False,
    save_artifact: bool = True,
    artifact_dir: Optional[str] = None,
    tag: str = "baseline",
    device: DeviceLike = None,
    seq_len: Optional[int] = None,
) -> Dict[str, Any]:
    """Trace one (arch x shape x mesh) cell on fake DTensors; return its
    record (the reference's keys, and the port's per-device counts).  An
    attention-free stack's train and prefill cells trace at the two
    ``EXTRAPOLATE_LENGTHS`` one after the other (``main``'s sweep traces
    them in two processes at once); ``seq_len`` traces the cell at that
    length alone, with no extrapolation."""
    from dataclasses import replace

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import DEFAULT_RULES

    cfg = get_config(arch)
    if shape_name not in cfg.shapes():
        return _skip_record(arch, shape_name, multi_pod)
    dev = resolve(device)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    kw = dict(remat_policy=remat_policy, grad_compress=grad_compress, device=dev)
    rules = rules or DEFAULT_RULES
    t0 = time.time()
    if seq_len is not None:
        counts = [_trace(cfg, replace(shape, seq_len=seq_len), mesh, rules, **kw)]
    elif _extrapolated(cfg, shape):
        counts = [_trace(cfg, replace(shape, seq_len=n), mesh, rules, **kw)
                  for n in EXTRAPOLATE_LENGTHS]
    else:
        counts = [_trace(cfg, shape, mesh, rules, **kw)]
    record = _record(arch, shape_name, multi_pod, tag, dev.type, mesh.size(), counts,
                     time.time() - t0, seq_len)
    if save_artifact:
        _save(record, artifact_dir, tag)
    return record


def _record(arch, shape_name, multi_pod, tag, device_type, n_chips, traced, seconds,
            seq_len=None) -> Dict[str, Any]:
    """A cell's record from its traces' counts: one trace at the cell's
    length (or at ``seq_len``), or two at ``EXTRAPOLATE_LENGTHS``."""
    from repro_torch.configs import SHAPES, get_config

    cfg, shape = get_config(arch), SHAPES[shape_name]
    lengths, traced_peaks = None, None
    if len(traced) == 2:
        lengths = EXTRAPOLATE_LENGTHS
        counts = _affine(*traced, *lengths, shape.seq_len)
        traced_peaks = [c["temp_peak_bytes"] for c in traced]
    else:
        counts = traced[0]
    coll = counts["collectives"]
    coll_total = float(sum(coll.values()))
    record: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "tag": tag,
        "status": "OK",
        "device": device_type,
        "n_chips": n_chips,
        "kind": shape.kind,
        "seq_len": seq_len or shape.seq_len,
        "global_batch": shape.global_batch,
        "lower_compile_s": round(seconds, 1),
        "num_groups": cfg.num_groups,
        "seq_extrapolated_from": lengths,
        # the peak at the two traced lengths: unequal where the per-chunk
        # term, not a constant, sets it
        "traced_temp_peak_bytes": traced_peaks,
        "counts": counts,
        "hlo_flops_per_device": float(counts["flops"]),
        "hlo_bytes_per_device": float(counts["bytes"]),
        "collective_bytes_per_device": coll_total,
        "collectives": {k: float(v) for k, v in coll.items()},
        "memory": {
            "argument_bytes": counts["argument_bytes"],
            "argument_spec_bytes": counts["argument_spec_bytes"],
            "peak_bytes": counts["argument_bytes"] + counts["temp_peak_bytes"],
            "temp_peak_bytes": counts["temp_peak_bytes"],
        },
        "t_compute_s": counts["flops"] / PEAK_FLOPS,
        "t_memory_s": counts["bytes"] / HBM_BW,
        "t_collective_s": coll_total / NVLINK_BW,
    }
    terms = {"compute": record["t_compute_s"], "memory": record["t_memory_s"],
             "collective": record["t_collective_s"]}
    record["bottleneck"] = max(terms, key=terms.get)
    return record


def _save(record: Dict[str, Any], artifact_dir: Optional[str], tag: str) -> None:
    path = artifact_path(artifact_dir, tag, record["mesh"], record["arch"], record["shape"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def _shapes(tree):
    """A tree of the global TensorSpecs of a tree of tensors / DTensors."""
    from repro_torch.models.layers import TensorSpec

    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return TensorSpec(tuple(tree.shape), tree.dtype)


def plan_orchestration(
    scenario: str = "paper-table6",
    policy: str = "feasibility-aware",
    at_hour: float = 36.0,
    fill: float = 0.5,
    transfers: Tuple[Tuple[int, int], ...] = (),
    *,
    device: DeviceLike = None,
):
    """Orchestration dry-run: scenario state at sim-time ``at_hour`` ->
    ClusterState (via the shared constructor) -> the policy's typed actions.

    Placement is synthetic but scenario-faithful: the earliest-arrived jobs
    run at their home sites, up to ``fill`` of each site's slots;
    ``transfers`` injects synthetic in-flight ``(src, dst)`` migrations so
    the preview can be taken under WAN load.  Every ``Migrate`` the policy
    proposes is re-checked at the **post-admission** ``(flows+1)`` rate —
    the advertised matrix is the current grant, systematically optimistic
    for a transfer the plan itself would add — and moves that are
    infeasible at the diluted rate are dropped from the plan.  ``device``
    (``None`` = the card) is where a K4-scoring policy decides.  Returns
    (state, actions)."""
    from repro_torch.core import feasibility as fz
    from repro_torch.core.actions import Migrate
    from repro_torch.core.orchestrator import make_policy
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.simulator import generate_jobs
    from repro_torch.core.state import ClusterState, JobView, site_views_from_traces

    scn = get_scenario(scenario)
    cfg = scn.sim_config()
    traces = scn.build_traces()
    t = at_hour * 3600.0
    cap = max(1, int(round(cfg.slots_per_site * fill)))
    per_site = [0] * cfg.n_sites
    views = []
    for j in generate_jobs(cfg):
        if j.arrival_s > t or per_site[j.home_site] >= cap:
            continue
        views.append(JobView(j.jid, j.home_site, j.ckpt_bytes, j.compute_s))
        per_site[j.home_site] += 1
    sites = site_views_from_traces(traces, t, slots=cfg.slots_per_site,
                                   busy=per_site)
    # the same WanTopology the simulator materializes for this scenario
    # (per-link caps, asymmetric NICs, brownout calendar at sim-time t),
    # plus the forecast horizon (σ=0: the planner reads the calendar as-is)
    state = ClusterState.build(t, views, sites, wan=scn.build_wan(),
                               transfers=transfers, traces=traces,
                               signals=scn.build_signals(),
                               battery=cfg.battery)
    jobs_by_id = {j.jid: j for j in state.jobs}
    flows = list(transfers)
    actions = []
    for a in make_policy(policy, device=device).decide(state):
        if isinstance(a, Migrate):
            j = jobs_by_id[a.jid]
            rate = state.post_admission_bps(j.site, a.dest, flows)
            v = fz.evaluate(j.ckpt_bytes, rate,
                            state.site(a.dest).window_remaining_s,
                            t_load_s=j.t_load_s)
            if not bool(v.feasible):
                continue  # optimistic under load: drop from the plan
            flows.append((j.site, a.dest))
        actions.append(a)
    return state, actions


def _print_plan(args, device) -> int:
    transfers = tuple(
        (int(s), int(d)) for s, d in
        (pair.split(":") for pair in args.transfers.split(",") if pair))
    state, actions = plan_orchestration(args.scenario, args.policy,
                                        args.at_hour, transfers=transfers,
                                        device=device)
    print(f"[plan] scenario={args.scenario} policy={args.policy} "
          f"t={args.at_hour:.1f}h jobs={len(state.jobs)}")
    if state.battery is not None:
        b = state.battery
        sell = (f" sellback={b.sellback_kw:.1f}kW"
                f"@floor=${b.sellback_price_floor:.2f}/kWh"
                if b.sellback_kw > 0.0 else "")
        print(f"[plan] battery: {b.capacity_kwh:.0f} kWh/site, "
              f"charge<={b.max_charge_kw:.1f}kW "
              f"discharge<={b.max_discharge_kw:.1f}kW "
              f"rte={b.round_trip_efficiency:.2f} "
              f"dark-discharge>={b.discharge_threshold_g:.0f}g/kWh"
              f"{sell}")
    for s in state.sites:
        print(f"[plan]   site{s.sid}: busy={s.busy} "
              f"{'GREEN' if s.renewable_active else 'grid '} "
              f"window={s.window_remaining_s / 3600:.2f}h")
    if not actions:
        print("[plan] no actions")
    for a in actions:
        print(f"[plan]   {a}")
    return 0


def artifact_path(out_dir, tag: str, mesh: str, arch: str, shape_name: str) -> str:
    """Where ``lower_cell`` writes a cell's record."""
    return os.path.join(out_dir or str(ARTIFACT_DIR),
                        f"{tag}_{mesh}_{arch.replace('/', '_')}_{shape_name}.json")


def _cell_in_subprocess(arch, shape_name, mp, args) -> Dict[str, Any]:
    """Lower one cell in a fresh process (the fake world is process-global)
    and read the record it writes; a crash there is the cell's FAIL.  A
    cell that extrapolates traces its two lengths in two processes at
    once."""
    from repro_torch.configs import SHAPES, get_config

    mesh = "multi" if mp else "single"
    if not _extrapolated(get_config(arch), SHAPES[shape_name]):
        return _run_cell(arch, shape_name, mesh, args, args.out, None)
    t0 = time.time()
    with ThreadPoolExecutor(len(EXTRAPOLATE_LENGTHS)) as pool:
        recs = list(pool.map(lambda n: _run_cell(arch, shape_name, mesh, args, os.path.join(
            args.out or str(ARTIFACT_DIR), f"seq{n}"), n), EXTRAPOLATE_LENGTHS))
    for rec in recs:
        if rec["status"] != "OK":
            return rec
    record = _record(arch, shape_name, mp, args.tag, recs[0]["device"], recs[0]["n_chips"],
                     [r["counts"] for r in recs], time.time() - t0)
    _save(record, args.out, args.tag)
    return record


def _run_cell(arch, shape_name, mesh, args, out_dir, seq_len) -> Dict[str, Any]:
    path = artifact_path(out_dir, args.tag, mesh, arch, shape_name)
    if os.path.exists(path):
        os.remove(path)
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
            shape_name, "--mesh", mesh, "--remat", args.remat, "--rules", args.rules,
            "--tag", args.tag, "--device", args.device]
    if args.grad_compress:
        argv.append("--grad-compress")
    if out_dir:
        argv += ["--out", out_dir]
    if seq_len:
        argv += ["--seq-len", str(seq_len)]
    out = subprocess.run(argv, capture_output=True, text=True)
    if out.returncode == 0 and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    said = [line.split(f" {mesh} ", 1)[-1].strip() for line in out.stdout.splitlines()
            if line.startswith("[dryrun]") and " FAIL" in line]
    tail = said[0] if said else "FAIL: exit {}: {}".format(
        out.returncode, (out.stderr.strip().splitlines() or ["no output"])[-1])
    return {"arch": arch, "shape": shape_name, "mesh": mesh, "status": tail}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all assigned)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--rules", default="baseline",
                    help="sharding strategy (parallel/strategies.py)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells lowered at once, each in its own process (a sweep)")
    ap.add_argument("--plan", action="store_true",
                    help="orchestration plan preview instead of the mesh lowering")
    ap.add_argument("--scenario", default="paper-table6")
    ap.add_argument("--policy", default="feasibility-aware")
    ap.add_argument("--at-hour", type=float, default=36.0)
    ap.add_argument("--transfers", default="",
                    help="synthetic in-flight migrations for --plan as "
                         "src:dst pairs, e.g. '0:2,0:3' — proposed moves "
                         "are admission-checked at the diluted "
                         "post-admission rate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="trace the cell at this many tokens, with no extrapolation")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    if args.plan:
        return _print_plan(args, device)

    from repro_torch.configs import ASSIGNED, SHAPES, get_config
    from repro_torch.parallel.strategies import get_strategy

    archs = [args.arch] if args.arch else list(ASSIGNED)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    alone = len([c for c in cells if c[1] in get_config(c[0]).shapes()]) <= 1
    pending = {}
    if not alone:
        pool = ThreadPoolExecutor(max(1, args.jobs))
        pending = {c: pool.submit(_cell_in_subprocess, *c, args) for c in cells
                   if c[1] in get_config(c[0]).shapes()}
    rows = []
    for arch, shape_name, mp in cells:
        if shape_name not in get_config(arch).shapes():
            rec = _skip_record(arch, shape_name, mp)
        elif not alone:
            rec = pending[(arch, shape_name, mp)].result()
        else:
            try:
                rec = lower_cell(
                    arch, shape_name, multi_pod=mp, remat_policy=args.remat,
                    grad_compress=args.grad_compress, tag=args.tag,
                    artifact_dir=args.out, rules=get_strategy(args.rules), device=device,
                    seq_len=args.seq_len,
                )
            except Exception as e:  # a failure here is a sharding fault of the port
                rec = {"arch": arch, "shape": shape_name, "mesh": "multi" if mp else "single",
                       "status": f"FAIL: {type(e).__name__}: {e}"}
        rows.append(rec)
        status = rec["status"]
        extra = ""
        if status == "OK":
            extra = (
                f" t_comp={rec['t_compute_s']:.3f}s t_mem={rec['t_memory_s']:.3f}s"
                f" t_coll={rec['t_collective_s']:.3f}s bound={rec['bottleneck']}"
                f" peak={_fmt_bytes(rec['memory']['peak_bytes'])}"
                f" ({rec['lower_compile_s']}s)"
            )
        print(f"[dryrun] {arch:24s} {shape_name:12s} {rec['mesh']:6s} {status}{extra}", flush=True)
    n_ok = sum(1 for r in rows if r["status"] == "OK")
    n_skip = sum(1 for r in rows if r["status"] == "SKIP")
    n_fail = len(rows) - n_ok - n_skip
    print(f"[dryrun] done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL")
    return 1 if n_fail else 0


def _fmt_bytes(b) -> str:
    if b is None:
        return "?"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


if __name__ == "__main__":
    raise SystemExit(main())
