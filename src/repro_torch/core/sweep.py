"""Monte-Carlo sweep engine: scenarios × policies × seeds, fanned out
over a process pool (the evaluation scale-up the ROADMAP's "as many
scenarios as you can imagine" asks for; cf. Heron's multi-DC trace
sweeps and Wiesner et al.'s multi-seed curtailment studies).

A sweep is a grid of *cells*; one cell = one ``(scenario, seed)`` pair.
Within a cell every policy runs against the **same** trace, job list, WAN
topology and forecast horizon (built once, shared — the same-trace-
same-jobs guarantee ``run_policy_comparison`` has always made, now for
every seed), so per-policy differences are policy effects, not sampling
noise.  Cells are independent and deterministic, so they parallelize
perfectly: ``run_sweep(spec, workers=N)`` produces byte-identical
per-run summaries to ``workers=1`` (tests/test_sweep.py), with results
merged in spec order regardless of completion order.

``run_policy_comparison`` is a 1-seed sweep through this engine;
``python -m benchmarks.run --sweep`` prints the aggregate table
(mean ± 95% CI per metric) for a multi-scenario many-seed grid.
"""
from __future__ import annotations

import copy
import math
import os
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from itertools import repeat
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve

#: summary keys that are wall-clock measurements, not model outputs —
#: nondeterministic by nature, excluded from determinism comparisons
TIMING_KEYS = ("ticks_per_sec", "decide_s", "decide_first_s", "wall_s")


@dataclass(frozen=True)
class SweepSpec:
    """A scenarios × policies × seeds grid (+ SimConfig overrides applied
    to every cell and per-policy configs).

    ``vary`` selects which random streams the sweep's seeds drive — the
    variance-decomposition split the coupled legacy seeding could not
    express:

      * ``"both"`` (default) — the legacy behaviour: one seed varies the
        environment (traces, WAN brownouts, failures, forecast noise,
        signals) *and* the job arrival process together;
      * ``"traces"`` — seeds vary only the environment; every cell runs
        the identical job workload drawn from ``pin_seed``;
      * ``"jobs"`` — seeds vary only the arrival process over the fixed
        ``pin_seed`` environment.

    Comparing the per-metric variance of a ``"traces"`` sweep against a
    ``"jobs"`` sweep decomposes how much of the ``"both"`` spread each
    stream contributes.
    """

    scenarios: Tuple[str, ...]
    policies: Tuple[str, ...]
    seeds: Tuple[int, ...] = (0,)
    overrides: Optional[Mapping[str, object]] = None
    policy_configs: Optional[Mapping[str, object]] = None  # name -> PolicyConfig|dict
    vary: str = "both"  # "both" | "traces" | "jobs"
    pin_seed: int = 0  # the pinned stream's seed under a split mode

    def cells(self, keep_results: bool = True) -> List[tuple]:
        """Materialize the work list: one ``(cfg, label, seed, policies,
        policy_configs, keep_results, job_seed)`` tuple per
        (scenario, seed), in spec order (the deterministic merge order).
        ``cfg.seed`` carries the environment stream; ``job_seed`` the
        arrival stream (equal under ``vary="both"``)."""
        from repro_torch.core.scenarios import get_scenario

        if self.vary not in ("both", "traces", "jobs"):
            raise ValueError(
                f"vary must be 'both', 'traces' or 'jobs', not {self.vary!r}")
        cells = []
        pconf = dict(self.policy_configs or {})
        for scn in self.scenarios:
            s = get_scenario(scn)
            for seed in self.seeds:
                env_seed = self.pin_seed if self.vary == "jobs" else seed
                job_seed = self.pin_seed if self.vary == "traces" else seed
                cfg = s.sim_config(**{**dict(self.overrides or {}),
                                      "seed": env_seed})
                # scenario-scoped policy defaults; spec-level configs win
                cell_pconf = {**{k: dict(v)
                                 for k, v in s.policy_configs.items()},
                              **pconf}
                cells.append((cfg, s.name, seed, tuple(self.policies),
                              cell_pconf, keep_results, job_seed))
        return cells


@dataclass(frozen=True)
class RunRecord:
    """One simulation run inside a sweep."""

    scenario: str
    policy: str
    seed: int
    summary: dict  # SimResult.summary()
    result: Optional[object] = None  # the full SimResult when kept


@dataclass
class SweepResult:
    """All runs of a sweep plus aggregation helpers."""

    runs: List[RunRecord]
    wall_s: float = 0.0
    workers: int = 1

    def deterministic_summaries(self) -> List[dict]:
        """Per-run summaries with wall-clock keys stripped — the object
        the workers=N == workers=1 determinism guarantee covers."""
        return [
            {**{k: v for k, v in r.summary.items() if k not in TIMING_KEYS},
             "scenario": r.scenario, "seed": r.seed}
            for r in self.runs
        ]

    def aggregate(self) -> Dict[Tuple[str, str], Dict[str, dict]]:
        """(scenario, policy) -> metric -> {mean, std, ci95, n} over
        seeds (sample std, normal-approximation 95% CI)."""
        groups: Dict[Tuple[str, str], List[dict]] = {}
        for r in self.runs:
            groups.setdefault((r.scenario, r.policy), []).append(r.summary)
        out: Dict[Tuple[str, str], Dict[str, dict]] = {}
        for key, summaries in groups.items():
            metrics: Dict[str, dict] = {}
            for name, v0 in summaries[0].items():
                if not isinstance(v0, (int, float)) or isinstance(v0, bool):
                    continue
                vals = [float(s[name]) for s in summaries]
                n = len(vals)
                mean = sum(vals) / n
                var = (sum((v - mean) ** 2 for v in vals) / (n - 1)
                       if n > 1 else 0.0)
                std = math.sqrt(var)
                metrics[name] = {
                    "mean": mean, "std": std,
                    "ci95": 1.96 * std / math.sqrt(n), "n": n,
                }
            out[key] = metrics
        return out

    def table(self, metrics: Sequence[str] = (
            "grid_kwh", "grid_gco2", "grid_cost", "renewable_frac",
            "migrations", "completed", "mean_jct_h")) -> str:
        """Aggregate table: one row per (scenario, policy), mean ± ci95."""
        agg = self.aggregate()
        headers = ["scenario", "policy"] + [f"{m} (±ci95)" for m in metrics]
        rows = []
        for (scn, pol), ms in agg.items():
            row = [scn, pol]
            for m in metrics:
                got = ms.get(m)
                row.append("-" if got is None else
                           f"{got['mean']:.2f} ±{got['ci95']:.2f}")
            rows.append(row)
        widths = [max(len(str(r[i])) for r in [headers] + rows)
                  for i in range(len(headers))]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        return "\n".join([fmt.format(*headers)]
                         + [fmt.format(*r) for r in rows])


def _cell_sims(cell: tuple, device: torch.device
               ) -> Tuple[str, int, bool, List[Tuple[str, object]]]:
    """Build one (scenario, seed) cell's simulators on shared inputs:
    ``(label, seed, keep_results, [(policy_name, simulator), ...])``.

    Traces, the WAN topology, the grid signals and (per forecast sigma)
    the ForecastHorizon are constructed once and shared across the cell's
    simulators; the job list is deep-copied per run (simulators mutate
    it).  The trailing ``job_seed`` drives the arrival stream separately
    from ``cfg.seed``'s environment stream (split-seed sweeps).  Every
    simulator and policy of the cell runs on ``device``.
    """
    from repro_torch.core.forecast import ForecastHorizon
    from repro_torch.core.orchestrator import make_policy
    from repro_torch.core.signals import generate_signals
    from repro_torch.core.simulator import ClusterSimulator, generate_jobs
    from repro_torch.core.traces import generate_trace

    cfg, label, seed, policies, policy_configs, keep_results, *rest = cell
    job_seed = rest[0] if rest else cfg.seed  # legacy 6-tuples: coupled
    traces = generate_trace(cfg.n_sites, cfg.days, seed=cfg.seed,
                            profile=cfg.trace)
    base_jobs = generate_jobs(cfg, seed=job_seed)
    wan = cfg.wan_profile().build_topology(cfg.n_sites, cfg.days, cfg.seed)
    signals = generate_signals(cfg.n_sites, cfg.days, seed=cfg.seed,
                               profile=cfg.signals)
    horizons: Dict[float, ForecastHorizon] = {}
    sims: List[Tuple[str, object]] = []
    for name in policies:
        pconf = policy_configs.get(name)
        if isinstance(pconf, dict):
            pol = make_policy(name, device=device, **pconf)
        else:
            pol = make_policy(name, config=pconf, device=device)
        sigma = 0.0 if pol.wants_oracle_forecast else cfg.forecast_sigma_s
        horizon = horizons.get(sigma)
        if horizon is None:
            horizon = horizons[sigma] = ForecastHorizon.build(
                traces, wan=wan, signals=signals,
                horizon_s=cfg.forecast_horizon_s,
                sigma_s=sigma, seed=cfg.seed + 7)
        sims.append((name, ClusterSimulator(
            cfg, pol, traces=traces, jobs=copy.deepcopy(base_jobs),
            oracle_forecast=pol.wants_oracle_forecast,
            wan_topology=wan, forecast_horizon=horizon,
            grid_signals=signals, device=device)))
    return label, seed, keep_results, sims


def _run_cell(cell: tuple, device: torch.device
              ) -> Tuple[str, int, List[Tuple[str, object, dict]]]:
    """Run every policy of one (scenario, seed) cell on shared inputs;
    yields ``(policy, SimResult-or-None, summary)`` triples.  When the
    caller does not keep full results, the per-job ``SimResult`` is
    dropped *worker-side* — only the summary dict crosses the process
    boundary.  Top-level so the process pool can pickle it.
    """
    label, seed, keep_results, sims = _cell_sims(cell, device)
    out: List[Tuple[str, object, dict]] = []
    for name, sim in sims:
        r = sim.run()
        out.append((name, r if keep_results else None, r.summary()))
    return label, seed, out


class _BatchRun:
    """One suspended cell×policy simulation inside the batched runner."""

    __slots__ = ("idx", "name", "sim", "gen", "state", "key", "label", "seed")

    def __init__(self, idx, name, sim):
        import dataclasses as _dc

        self.idx, self.name, self.sim = idx, name, sim
        self.gen = sim._event_gen()
        self.state = None
        pol = sim.policy
        # config-identical policies share one decide_batch call; policies
        # that aren't dataclasses have no stable value repr and stay solo
        # (their default decide_batch loops decide anyway)
        self.key = ((type(pol).__name__, repr(pol))
                    if _dc.is_dataclass(pol) else (type(pol).__name__, id(pol)))

    def advance(self, actions):
        """Run events until the next orchestrator tick; True while live."""
        try:
            self.state = self.gen.send(actions)
            return True
        except StopIteration:
            self.state = None
            return False


def run_cells_batched(cells: Sequence[tuple], *,
                      keep_results: bool = True,
                      device: DeviceLike = None) -> SweepResult:
    """Execute prepared cells in ONE process with cross-cell batched
    decide: every cell×policy simulation is advanced as a coroutine
    (``ClusterSimulator._event_gen``) to its next orchestrator tick, and
    all snapshots awaiting a config-identical policy are answered by a
    single ``Policy.decide_batch`` call — one fused
    ``(cells × jobs × sites)`` kernel pass per group per round instead of
    a python loop over cells (see :mod:`repro_torch.core.policy_kernels`),
    one K4 launch on ``device`` (``None`` = the card).

    Per-run summaries are identical to :func:`run_cells` minus
    ``TIMING_KEYS`` (the determinism guarantee tests/test_sweep.py
    extends to this runner); the batched decide wall is attributed to the
    member runs in equal shares.  Cells requesting the fixed-dt engine
    run inline, unbatched.
    """
    device = resolve(device)
    t0 = time.perf_counter()
    slots: List[Optional[Tuple[str, int, str, object, dict]]] = []
    keeps: List[bool] = []
    live: List[_BatchRun] = []
    for cell in cells:
        label, seed, keep, sims = _cell_sims(cell, device)
        for name, sim in sims:
            idx = len(slots)
            slots.append(None)
            keeps.append(keep)
            if sim.cfg.engine != "event":
                r = sim.run()
                slots[idx] = (label, seed, name, r, r.summary())
                continue
            run = _BatchRun(idx, name, sim)
            run.label, run.seed = label, seed
            if run.advance(None):
                live.append(run)
            else:
                r = sim._result(t0)
                slots[idx] = (label, seed, name, r, r.summary())

    def finalize(run: _BatchRun) -> None:
        r = run.sim._result(t0)
        slots[run.idx] = (run.label, run.seed, run.name, r, r.summary())

    while live:
        groups: Dict[tuple, List[_BatchRun]] = {}
        for run in live:
            groups.setdefault(run.key, []).append(run)
        live = []
        for members in groups.values():
            pol = members[0].sim.policy
            d0 = time.perf_counter()
            acts = pol.decide_batch([run.state for run in members])
            share = (time.perf_counter() - d0) / len(members)
            for run, actions in zip(members, acts):
                run.sim._record_decide(share)
                if run.advance(actions):
                    live.append(run)
                else:
                    finalize(run)
    runs = [
        RunRecord(scenario=label, policy=name, seed=seed, summary=summary,
                  result=r if keeps[i] else None)
        for i, (label, seed, name, r, summary) in enumerate(slots)
    ]
    return SweepResult(runs=runs, wall_s=time.perf_counter() - t0, workers=1)


def run_cells(cells: Sequence[tuple], *, workers: Optional[int] = None,
              keep_results: bool = True,
              device: DeviceLike = None) -> SweepResult:
    """Execute prepared cells (see :meth:`SweepSpec.cells`) on ``device``
    (``None`` = the card) and merge in submission order.  ``workers=1``
    (or a single cell) runs inline — no pool, no pickling;
    ``workers=None`` sizes the pool to ``min(len(cells), cpu_count)``.
    The pool spawns its workers: a forked child cannot use CUDA once the
    parent has initialised it, and a fork of a process whose threads
    (torch's, or JAX's beside it in the tests) may hold a lock can
    deadlock the child."""
    device = resolve(device)
    t0 = time.perf_counter()
    if workers is None:
        workers = min(len(cells), os.cpu_count() or 1)
    workers = max(1, min(workers, len(cells)))
    if workers == 1:
        results = [_run_cell(c, device) for c in cells]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
            # map() yields in submission order — completion order never
            # leaks into the merge
            results = list(ex.map(_run_cell, cells, repeat(device)))
    runs = [
        RunRecord(scenario=label, policy=name, seed=seed, summary=summary,
                  result=r if keep_results else None)
        for label, seed, cell_out in results
        for name, r, summary in cell_out
    ]
    return SweepResult(runs=runs, wall_s=time.perf_counter() - t0,
                       workers=workers)


def run_sweep(spec: SweepSpec, *, workers: Optional[int] = None,
              keep_results: bool = True,
              device: DeviceLike = None) -> SweepResult:
    """Fan a :class:`SweepSpec` out over the process pool on ``device``."""
    return run_cells(spec.cells(keep_results=keep_results), workers=workers,
                     keep_results=keep_results, device=device)


__all__ = [
    "RunRecord", "SweepResult", "SweepSpec", "TIMING_KEYS", "run_cells",
    "run_cells_batched", "run_sweep",
]
