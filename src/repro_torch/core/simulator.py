"""Trace-driven simulator of renewable-powered micro-datacenters
(paper §VII: 5 sites, 10 Gbps WAN, 7-day CAISO-calibrated trace, job mix
A:70% 1–6 GB / B:20% 10–40 GB / C:10% 100–300 GB).

Control flow is event-driven and typed: every ``orch_dt_s`` the simulator
builds an immutable :class:`~repro_torch.core.state.ClusterState` snapshot (one
shared constructor with the dry-run planner and the serve router) and hands
it to ``Policy.decide``, which returns :mod:`repro_torch.core.actions` —
``Migrate``, ``Defer(until)``, ``Pause``/``Resume`` and
``Throttle(power_frac)``.  Invalid or stale actions are counted in
``SimResult.rejected_actions``, never applied.

Models:
  * per-site GPU slots with FIFO queues (``Defer`` holds a queued job out
    of scheduling; ``Pause`` frees a slot until ``Resume``),
  * renewable windows from core/traces.py; grid vs. renewable kWh accounting
    (P_node = 0.75 kW compute — scaled by the job's ``Throttle`` fraction —
    P_sys = 1.8 kW during transfer),
  * WAN transfers over a :class:`~repro_torch.core.wan.WanTopology` — per-site
    (possibly asymmetric) NIC rates, a per-link capacity matrix and fabric-
    or per-link-scoped brownout calendars; concurrent transfers get the
    fair share of every resource they traverse (this is what stalls the
    energy-only policy),
  * migration = pause → transfer → load (10.3 s) → downtime (0.4 s) →
    resume (possibly queued on arrival),
  * optional node failures with checkpoint/restart (beyond-paper).

Two time-stepping engines share all state, indexing and action code
(``SimConfig.engine``):

  * ``"event"`` (default) — next-event stepping: time jumps straight to
    the next arrival, transfer/load/job completion, window edge, brownout
    edge, defer expiry, failure or orchestrator tick.  Job accounting is
    integrated *analytically* over each inter-event span (renewable vs.
    grid kWh by exact window overlap, transfer bits at the current share
    rate), and in-flight transfer rates are re-split only when the flow
    set or the link state actually changes.
  * ``"fixed-dt"`` — the legacy fixed ``dt_s`` loop, kept as the parity
    reference (see tests/test_event_engine.py).

Jobs are indexed incrementally by (site, state) bucket — the hot loop only
touches jobs whose state can change at the current event, never the full
job list.  ``benchmarks/run.py --quick`` prints wall time and ticks/sec
(one tick = one processed event) and gates them in CI against
``benchmarks/BENCH_quick.json``.

Scenarios: construct via ``ClusterSimulator.from_scenario("flaky-wan",
"feasibility-aware")`` or ``run_policy_comparison(scenario="paper-table6")``
— see :mod:`repro_torch.core.scenarios` for the registry (including the
WAN-topology scenarios ``hub-spoke-wan``, ``asymmetric-uplink``,
``partitioned-wan``).

Deterministic for a given seed (each engine separately; the two engines
agree within tolerance, not bit-for-bit — completions are exact events
rather than rounded up to the next tick).

Device: a simulator runs on one device (``device=``, ``None`` = the
card).  Everything but the migration decide is numpy on the host; the
policies that score with the K4 decide kernel (feasibility-aware,
oracle, plan-ahead) launch it on that device every tick.  The chunked
serving fast path of the JAX package (``serving_kernels.py``) is not
ported yet: a serving run must pick ``serving_engine="event"``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import feasibility as fz
from repro_torch.core.actions import Action, Defer, Migrate, Pause, Resume, Throttle
from repro_torch.core.faults import FaultPlan, FaultRegime, RetryPolicy
from repro_torch.core.ledger import BatteryConfig, PowerLedger, ThrottleCurve
from repro_torch.core.orchestrator import Policy, PolicyConfig, make_policy
from repro_torch.core.serving import ServingPlane, ServingProfile, make_router
from repro_torch.core.signals import (
    GridSignals, SignalProfile, generate_signals, grid_signal_integral,
)
from repro_torch.core.state import ClusterState, JobSoA, JobView, SiteView
from repro_torch.core.traces import Forecaster, SiteTrace, TraceProfile, generate_trace
from repro_torch.core.wan import WanProfile, WanTopology
from repro_torch.device import DeviceLike, resolve

HOUR = 3600.0
GB = 1e9

# Job lifecycle. "paused" is policy-initiated (Pause action); "migrating"
# and "loading" are the two legs of a migration.
JOB_STATES = ("pending", "queued", "running", "migrating", "loading",
              "paused", "done")
# codes for the incremental state column; the live-state codes are taken
# from state.py so the SoA column can never drift from what the policy
# kernels compare against (STATE_QUEUED/RUNNING/PAUSED)
from repro_torch.core.state import _STATE_CODES as _LIVE_STATE_CODES

_STATE_CODE = {**_LIVE_STATE_CODES, "pending": 3, "migrating": 4,
               "loading": 5, "done": 6}
# packed column indices (see ClusterSimulator.__init__)
_CF_CKPT, _CF_COMPUTE, _CF_PROGRESS, _CF_POWER, _CF_DEFER, _CF_LASTMIG = range(6)
_CI_SITE, _CI_STATE = range(2)


@dataclass
class SimJob:
    jid: int
    arrival_s: float
    compute_s: float
    ckpt_bytes: float
    size_class: str
    home_site: int

    site: int = -1
    state: str = "pending"
    progress_s: float = 0.0
    done_s: float = -1.0
    started_s: float = -1.0
    migrations: int = 0
    failed_migrations: int = 0
    pause_s: float = 0.0  # time spent not computing due to migration
    pause_transfer_s: float = 0.0
    pause_wait_s: float = 0.0  # post-migration queue wait
    queue_s: float = 0.0
    renewable_kwh: float = 0.0
    grid_kwh: float = 0.0
    # in-flight transfer
    transfer_remaining_bits: float = 0.0
    transfer_dest: int = -1
    load_remaining_s: float = 0.0
    last_ckpt_progress_s: float = 0.0
    post_migration_wait: bool = False  # queue time after arrival counts as
    # migration-induced pause (the paper's 'stall/congestion' mode)
    last_migration_end_s: float = -1e18
    # typed-action state
    power_frac: float = 1.0  # Throttle power cap while running
    # throughput fraction delivered at power_frac: equal to power_frac
    # without a SimConfig.throttle_curve (legacy linear scalar), else
    # curve.throughput(power_frac).  Progress integrates tput_frac;
    # energy always integrates power_frac.
    tput_frac: float = 1.0
    defer_until_s: float = -1e18  # Defer: not schedulable before this time
    paused_policy_s: float = 0.0  # time spent in policy-initiated Pause
    # next-event engine bookkeeping
    anchor_s: float = 0.0  # sim-time the job's accounting was last flushed
    rate_bps: float = 0.0  # current transfer share (migrating only)
    ver: int = 0  # bumped on any change that invalidates a queued event
    # recovery ladder (transfer-stall watchdog, core/faults.py)
    stall_since_s: float = -1.0  # when the in-flight rate hit 0 (-1: flowing)
    retry_attempts: int = 0  # watchdog-aborted transfers since last success
    last_failed_dest: int = -1  # destination of the last aborted transfer
    fail_counted: bool = False  # this attempt already in failed_migrations

    @property
    def jct_s(self) -> float:
        return self.done_s - self.arrival_s if self.done_s >= 0 else float("nan")


@dataclass
class SimConfig:
    n_sites: int = 5
    slots_per_site: int = 4
    wan_gbps: float = 10.0
    days: int = 7
    dt_s: float = 30.0  # fixed-dt engine step
    engine: str = "event"  # "event" (next-event) or "fixed-dt" (legacy)
    orch_dt_s: float = 300.0
    seed: int = 0
    n_jobs: int = 240
    arrival_skew: Sequence[float] = (0.45, 0.1925, 0.1485, 0.121, 0.088)
    p_node_kw: float = fz.P_NODE_KW
    p_sys_kw: float = fz.P_SYS_KW
    t_load_s: float = fz.T_LOAD_S
    t_downtime_s: float = fz.T_DOWNTIME_S
    forecast_sigma_s: float = 900.0
    forecast_horizon_s: float = 24 * HOUR  # ClusterState.forecast lookahead
    migration_cooldown_s: float = 900.0  # orchestrator debounce per job
    # renewable-window process (scenario-composable)
    trace: TraceProfile = field(default_factory=TraceProfile)
    # grid-signal process (carbon gCO2/kWh + price $/kWh traces, derived
    # demand-response curtail requests) — always on: the signal accounting
    # is a parallel integral, the kWh numbers it annotates never change
    signals: SignalProfile = field(default_factory=SignalProfile)
    # WAN: a full WanProfile wins over the legacy uniform scalars below
    wan: Optional[WanProfile] = None
    # flaky-WAN regime: hourly brownouts to wan_degraded_gbps
    wan_degrade_prob: float = 0.0
    wan_degraded_gbps: float = 1.0
    # job mix (paper §VII)
    frac_a: float = 0.70
    frac_b: float = 0.20
    size_a_gb: tuple = (1.0, 6.0)
    size_b_gb: tuple = (10.0, 40.0)
    size_c_gb: tuple = (100.0, 300.0)
    mean_compute_h: float = 3.5
    # beyond-paper fault injection.  ``failure_rate_per_slot_hour`` is
    # the legacy alias for FaultRegime.job_failure_rate_per_slot_hour
    # (the two rates add); the full fault spec lives in ``faults``
    failure_rate_per_slot_hour: float = 0.0
    checkpoint_interval_s: float = 1800.0
    # deterministic fault injection + recovery (core/faults.py): site
    # blackouts, hard link failures, checkpoint corruption, replica
    # crashes, stragglers.  None (or an all-off regime) draws zero RNG
    # numbers and adds zero float ops.  Event engine only.
    faults: Optional[FaultRegime] = None
    # transfer-stall watchdog: a migration whose shared rate sits at 0
    # for this long is aborted and requeued at the source (bounded
    # retries via RetryPolicy).  Active regardless of ``faults`` — it is
    # the fix for the historic silent-infinite-stall bug.
    stall_timeout_s: float = 1800.0
    # inference serving plane (None or a disabled profile = training only;
    # event engine only).  The plane's RNG lives entirely in the
    # [seed, 151, ...] streams, so enabling it never moves a training draw.
    serving: Optional[ServingProfile] = None
    serving_router: str = "green-first"
    # serving engine selection: "chunked" (the default) is the JAX
    # package's span-advance fast path (serving_kernels.py), not ported
    # yet: a serving run raises under it; "event" runs the per-event
    # scalar plane.
    serving_engine: str = "chunked"
    # prosumer microgrid layer (core/ledger.py): per-site battery /
    # sell-back spec (None = storage off; with storage off the ledger
    # reproduces the pre-ledger accounting bit-for-bit), and the
    # physical power→throughput curve Throttle actions map through
    # (None = the legacy linear scalar).  Event engine only.
    battery: Optional[BatteryConfig] = None
    throttle_curve: Optional[ThrottleCurve] = None

    def wan_profile(self) -> WanProfile:
        """The authoritative WAN spec: ``wan`` if set, else the legacy
        uniform scalars."""
        if self.wan is not None:
            return self.wan
        return WanProfile(gbps=self.wan_gbps,
                          hourly_degrade_prob=self.wan_degrade_prob,
                          degraded_gbps=self.wan_degraded_gbps)


@dataclass
class SimResult:
    policy: str
    jobs: List[SimJob]
    grid_kwh: float
    renewable_kwh: float
    migration_kwh: float
    migrations: int
    failed_migrations: int
    failures: int
    rejected_actions: int = 0
    ticks: int = 0
    wall_time_s: float = 0.0
    # cumulative wall time inside Policy.decide, WARM ticks only: the
    # first decide of a run (kernel build and load, lazy caches) lands in
    # decide_first_s so no gate reads that one-time cost
    decide_s: float = 0.0
    decide_first_s: float = 0.0
    engine: str = "event"
    # grid-signal accounting: gCO2 / $ of every grid-billed kWh, weighted
    # by the per-site time-of-use signal at the moment the energy was
    # drawn, plus the per-site breakdowns (each gram is billed to exactly
    # one site; sums equal the totals to float precision)
    grid_gco2: float = 0.0
    grid_cost: float = 0.0
    site_grid_gco2: Tuple[float, ...] = ()
    site_grid_cost: Tuple[float, ...] = ()
    # serving-plane accounting (all zero when the run carries no serving
    # plane; separate accumulators from the training spine — the kWh /
    # gCO2 columns above never include request energy)
    requests_arrived: int = 0
    requests_served: int = 0
    requests_dropped: int = 0  # queue-overflow drops
    requests_shed: int = 0  # router-initiated proactive sheds
    slo_violations: int = 0
    request_gco2: float = 0.0
    site_request_gco2: Tuple[float, ...] = ()
    serve_grid_kwh: float = 0.0
    serve_renewable_kwh: float = 0.0
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    latency_p99_s: float = 0.0
    queue_depth_p95: float = 0.0
    # prosumer accounting (all zero with storage/sell-back disabled)
    battery_charge_kwh: float = 0.0
    battery_discharge_kwh: float = 0.0
    battery_loss_kwh: float = 0.0
    battery_cycles: float = 0.0
    sellback_kwh: float = 0.0
    sellback_usd: float = 0.0
    # demand-response compliance (watt-seconds requested shed vs shed)
    dr_requested_ws: float = 0.0
    dr_shed_ws: float = 0.0
    # fault/recovery telemetry (all zero without an active FaultRegime —
    # except watchdog_aborts/retries/reroutes, which the always-on
    # transfer-stall watchdog can also produce)
    site_outages: int = 0  # blackout spans experienced during the run
    mttr_s: float = 0.0  # mean time-to-repair of those blackouts
    retries: int = 0  # re-admitted migrations after a watchdog abort
    reroutes: int = 0  # retries that picked a different destination
    replica_crashes: int = 0  # serving replica crash events applied
    watchdog_aborts: int = 0  # transfers aborted by the stall watchdog

    @property
    def dr_compliance(self) -> float:
        """Fraction of curtail-request span-watts actually shed (1.0
        when no request overlapped any compute span)."""
        if self.dr_requested_ws <= 0.0:
            return 1.0
        return min(1.0, max(0.0, self.dr_shed_ws / self.dr_requested_ws))

    @property
    def slo_attainment(self) -> float:
        """Fraction of served requests that met their latency SLO (1.0
        with no serving plane / nothing served)."""
        if self.requests_served <= 0:
            return 1.0
        return 1.0 - self.slo_violations / self.requests_served

    @property
    def mean_jct_s(self) -> float:
        vals = [j.jct_s for j in self.jobs if j.done_s >= 0]
        return float(np.mean(vals)) if vals else float("nan")

    @property
    def completed(self) -> int:
        return sum(1 for j in self.jobs if j.done_s >= 0)

    @property
    def total_compute_s(self) -> float:
        return sum(j.progress_s for j in self.jobs)

    @property
    def migration_overhead(self) -> float:
        """Direct migration cost (transfer + load + downtime) over compute —
        the paper's 'Migr. overhead' column."""
        c = self.total_compute_s
        return (sum(j.pause_transfer_s for j in self.jobs) / c) if c else 0.0

    @property
    def stall_overhead(self) -> float:
        """Migration-induced queueing stalls over compute (the energy-only
        failure mode: §VII.E 'stalled transfers, congestion, retries')."""
        c = self.total_compute_s
        return (sum(j.pause_wait_s for j in self.jobs) / c) if c else 0.0

    @property
    def renewable_fraction(self) -> float:
        tot = self.grid_kwh + self.renewable_kwh
        return self.renewable_kwh / tot if tot else 0.0

    @property
    def ticks_per_sec(self) -> float:
        """Events (fixed-dt: ticks) processed per wall-clock second."""
        return self.ticks / self.wall_time_s if self.wall_time_s else 0.0

    def summary(self) -> dict:
        return {
            "policy": self.policy,
            "grid_kwh": round(self.grid_kwh, 1),
            "renewable_kwh": round(self.renewable_kwh, 1),
            "renewable_frac": round(self.renewable_fraction, 3),
            "mean_jct_h": round(self.mean_jct_s / HOUR, 2),
            "migration_overhead": round(self.migration_overhead, 4),
            "stall_overhead": round(self.stall_overhead, 4),
            "migrations": self.migrations,
            "failed_migrations": self.failed_migrations,
            "completed": self.completed,
            "failures": self.failures,
            "rejected_actions": self.rejected_actions,
            "grid_gco2": round(self.grid_gco2, 1),
            "grid_cost": round(self.grid_cost, 2),
            "site_grid_gco2": [round(x, 1) for x in self.site_grid_gco2],
            "site_grid_cost": [round(x, 2) for x in self.site_grid_cost],
            "requests_arrived": self.requests_arrived,
            "requests_served": self.requests_served,
            "requests_dropped": self.requests_dropped,
            "requests_shed": self.requests_shed,
            "slo_violations": self.slo_violations,
            "slo_attainment": round(self.slo_attainment, 4),
            "request_gco2": round(self.request_gco2, 1),
            "serve_grid_kwh": round(self.serve_grid_kwh, 3),
            "serve_renewable_kwh": round(self.serve_renewable_kwh, 3),
            "latency_p50_s": round(self.latency_p50_s, 3),
            "latency_p95_s": round(self.latency_p95_s, 3),
            "latency_p99_s": round(self.latency_p99_s, 3),
            "queue_depth_p95": round(self.queue_depth_p95, 1),
            "battery_charge_kwh": round(self.battery_charge_kwh, 3),
            "battery_discharge_kwh": round(self.battery_discharge_kwh, 3),
            "battery_cycles": round(self.battery_cycles, 3),
            "sellback_kwh": round(self.sellback_kwh, 3),
            "sellback_usd": round(self.sellback_usd, 4),
            "dr_compliance": round(self.dr_compliance, 4),
            "site_outages": self.site_outages,
            "mttr_s": round(self.mttr_s, 1),
            "retries": self.retries,
            "reroutes": self.reroutes,
            "replica_crashes": self.replica_crashes,
            "watchdog_aborts": self.watchdog_aborts,
            "ticks_per_sec": round(self.ticks_per_sec, 1),
            "decide_s": round(self.decide_s, 4),
            "decide_first_s": round(self.decide_first_s, 4),
            "wall_s": round(self.wall_time_s, 4),
        }


def generate_jobs(cfg: SimConfig, *, seed: Optional[int] = None) -> List[SimJob]:
    """The arrival process.  ``seed`` overrides the job-stream seed
    (default ``cfg.seed``): the sweep engine's split-seed modes hold one
    of {traces, jobs} fixed while the other varies (variance
    decomposition); the default reproduces the coupled legacy stream."""
    rng = np.random.default_rng((cfg.seed if seed is None else seed) + 1)
    horizon = cfg.days * 24 * HOUR
    arrivals = np.sort(rng.uniform(0, horizon * 0.75, cfg.n_jobs))
    skew = np.asarray(cfg.arrival_skew[: cfg.n_sites], float)
    skew = skew / skew.sum()
    jobs = []
    sigma = 0.6
    mu = np.log(cfg.mean_compute_h) - sigma ** 2 / 2
    for i, t in enumerate(arrivals):
        u = rng.random()
        if u < cfg.frac_a:
            cls, (lo, hi) = "A", cfg.size_a_gb
        elif u < cfg.frac_a + cfg.frac_b:
            cls, (lo, hi) = "B", cfg.size_b_gb
        else:
            cls, (lo, hi) = "C", cfg.size_c_gb
        size = rng.uniform(lo, hi) * GB
        compute_h = float(np.clip(rng.lognormal(mu, sigma), 0.5, 24.0))
        home = int(rng.choice(cfg.n_sites, p=skew))
        jobs.append(SimJob(i, float(t), compute_h * HOUR, size, cls, home, site=home))
    return jobs


class ClusterSimulator:
    def __init__(
        self,
        cfg: SimConfig,
        policy: Policy,
        traces: Optional[List[SiteTrace]] = None,
        jobs: Optional[List[SimJob]] = None,
        oracle_forecast: bool = False,
        wan_topology: Optional[WanTopology] = None,
        forecast_horizon=None,
        grid_signals: Optional[GridSignals] = None,
        device: DeviceLike = None,
    ):
        """``wan_topology`` / ``forecast_horizon`` / ``grid_signals``
        accept prebuilt shared objects (the sweep engine builds them once
        per (scenario, seed) cell); the constructions are deterministic,
        so passing them is result-identical to letting the simulator
        build its own.  ``device`` (``None`` = the card) must be the one a
        K4-scoring policy was made for."""
        self.cfg = cfg
        self.device = resolve(device)
        if (getattr(policy, "scores_on_device", False)
                and policy.device != self.device):
            raise ValueError(
                f"policy {policy.name!r} scores on {policy.device}, but the "
                f"simulator runs on {self.device}")
        self.policy = policy
        self.traces = traces or generate_trace(
            cfg.n_sites, cfg.days, seed=cfg.seed, profile=cfg.trace
        )
        self.jobs = jobs if jobs is not None else generate_jobs(cfg)
        sigma = 0.0 if oracle_forecast else cfg.forecast_sigma_s
        self.forecaster = Forecaster(self.traces, sigma_s=sigma, seed=cfg.seed + 7)
        # legacy per-job failure stream, on the repo-wide list-seed
        # convention (no gated digits depend on this stream)
        self._fail_rng = np.random.default_rng([cfg.seed, 23])
        # deterministic fault plan (core/faults.py): every span sampled
        # up front from its own [seed, 173, ...] streams.  None when the
        # regime is unset/inactive — the faults-off path never consults
        # it and never draws from a fault stream.
        self.fault_plan: Optional[FaultPlan] = None
        if cfg.faults is not None and cfg.faults.any_active():
            self.fault_plan = FaultPlan.build(
                cfg.faults, cfg.n_sites, cfg.days * 24 * HOUR, cfg.seed)
        # live fault-state caches (updated at plan span edges)
        self._site_up = np.ones(cfg.n_sites, dtype=bool)
        self._link_up = np.ones((cfg.n_sites, cfg.n_sites), dtype=bool)
        self._fault_tput: Optional[np.ndarray] = None  # straggler factors
        self._replica_down = np.zeros(cfg.n_sites, dtype=bool)
        # grid-signal traces (per-site carbon/price + curtail requests):
        # own RNG stream, so enabling signals changes no existing draw
        self.signals = grid_signals or generate_signals(
            cfg.n_sites, cfg.days, seed=cfg.seed, profile=cfg.signals)
        # the one accounting spine: every kWh / gCO2 / $ accumulator of
        # the run lives in the per-site PowerLedger (core/ledger.py).
        # Postings reproduce the historical per-span expressions op for
        # op, so every digit is bit-identical with storage disabled;
        # with a battery the ledger also runs the charge/sell-back
        # timeline (deterministic, zero RNG draws).
        self.ledger = PowerLedger(cfg.n_sites, signals=self.signals,
                                  traces=self.traces, battery=cfg.battery)
        self.migrations = 0
        self.failed_migrations = 0
        self.failures = 0
        self.rejected_actions = 0
        self.ticks = 0
        # recovery telemetry (SimResult.{retries,reroutes,...})
        self.retries = 0
        self.reroutes = 0
        self.watchdog_aborts = 0
        self.replica_crashes = 0
        self._final_t = 0.0  # sim time the event loop actually reached
        # the one WAN object every consumer shares (transfer loop, snapshot
        # advertisement, and — via scenarios — dryrun --plan / serve)
        self.wan_topology = wan_topology or cfg.wan_profile().build_topology(
            cfg.n_sites, cfg.days, cfg.seed)
        # the lookahead product (window + outage forecasts) attached to
        # every snapshot.  Built once: window noise is hash-deterministic
        # per (seed, site), so the horizon is identical at every tick —
        # which is what lets plan-ahead policies hold a plan across ticks.
        from repro_torch.core.forecast import ForecastHorizon

        self.forecast_horizon = forecast_horizon or ForecastHorizon.build(
            self.traces, wan=self.wan_topology, signals=self.signals,
            horizon_s=cfg.forecast_horizon_s, sigma_s=sigma,
            seed=cfg.seed + 7, faults=self.fault_plan)
        # Prebuilt horizons (sweep cells share one across policies) were
        # constructed without a fault plan; graft this run's plan on so
        # fault-aware policies see the same repair/next-fault answers
        # they would get from a from-scratch build.  The plan is a pure
        # function of (regime, n_sites, days, seed), so every sim in the
        # cell grafts the identical calendar.
        if (self.fault_plan is not None
                and self.forecast_horizon.faults is None):
            self.forecast_horizon = dataclasses.replace(
                self.forecast_horizon, faults=self.fault_plan)
        # inference serving plane (event engine only).  All serving RNG
        # lives in the [seed, 151, ...] streams and routing reads a
        # noise-free trace snapshot (never the forecaster), so a run with
        # serving disabled is bit-identical to one without the plane.
        self.serving: Optional[ServingPlane] = None
        if cfg.serving is not None and cfg.serving.enabled:
            from repro_torch.core.traces import stack_traces

            if cfg.serving_engine == "chunked":
                raise NotImplementedError(
                    "the chunked serving fast path (serving_kernels.py) is "
                    "not ported yet (ROADMAP Queue 1, item 11); pass "
                    "serving_engine='event'")
            self.serving = ServingPlane(
                cfg.serving, make_router(cfg.serving_router),
                n_sites=cfg.n_sites, days=cfg.days, seed=cfg.seed,
                topo=self.wan_topology, traces=self.traces,
                signals=self.signals, state_fn=self._serving_state,
                ledger=self.ledger)
            self._serve_stack = stack_traces(self.traces)
            self._empty_soa = JobSoA.from_views([])
        # incremental (site, state) job index: jid-keyed dicts give
        # deterministic (insertion-ordered) iteration and O(1) moves
        self._by_state: Dict[str, Dict[int, SimJob]] = {s: {} for s in JOB_STATES}
        self._site_jobs: Dict[Tuple[int, str], Dict[int, SimJob]] = {}
        self._jobs_by_id: Dict[int, SimJob] = {}
        for j in self.jobs:
            self._jobs_by_id[j.jid] = j
            self._index_add(j)
        self._arrivals = sorted(self._by_state["pending"].values(),
                                key=lambda j: (j.arrival_s, j.jid))
        self._arrival_ptr = 0
        self.decide_s = 0.0  # cumulative WARM decide wall (see _record_decide)
        self.decide_first_s = 0.0
        self._decide_calls = 0
        # jid-indexed structure-of-arrays columns behind the snapshot's
        # JobSoA: static facts filled once; volatile facts mirrored at
        # their single mutation points (_move, _apply_action, migration
        # end) except progress, which is refreshed for the running bucket
        # at snapshot time (it advances continuously)
        size = max((j.jid for j in self.jobs), default=-1) + 1
        self._site_slots_arr = np.full(cfg.n_sites, cfg.slots_per_site,
                                       dtype=np.int64)
        self._tload_buf = np.full(max(size, 1), cfg.t_load_s)
        # packed jid-row column matrices: one fancy-index gather per
        # snapshot instead of one per column (float: _CF_* columns,
        # int: _CI_* columns)
        self._colf = np.zeros((size, 6))
        self._coli = np.zeros((size, 2), dtype=np.int64)
        self._colf[:, _CF_POWER] = 1.0
        self._colf[:, _CF_DEFER] = -1e18
        self._colf[:, _CF_LASTMIG] = -1e18
        self._coli[:, _CI_STATE] = _STATE_CODE["pending"]
        for j in self.jobs:
            jid = j.jid
            self._coli[jid, _CI_SITE] = j.site
            self._coli[jid, _CI_STATE] = _STATE_CODE[j.state]
            self._colf[jid, _CF_CKPT] = j.ckpt_bytes
            self._colf[jid, _CF_COMPUTE] = j.compute_s
            self._colf[jid, _CF_PROGRESS] = j.progress_s
            self._colf[jid, _CF_POWER] = j.power_frac
            self._colf[jid, _CF_DEFER] = j.defer_until_s
            self._colf[jid, _CF_LASTMIG] = j.last_migration_end_s

    # -- (site, state) bucket maintenance -----------------------------------
    _SITE_STATES = ("queued", "running")

    def _index_add(self, j: SimJob) -> None:
        self._by_state[j.state][j.jid] = j
        if j.state in self._SITE_STATES:
            self._site_jobs.setdefault((j.site, j.state), {})[j.jid] = j

    def _index_remove(self, j: SimJob) -> None:
        self._by_state[j.state].pop(j.jid, None)
        if j.state in self._SITE_STATES:
            bucket = self._site_jobs.get((j.site, j.state))
            if bucket is not None:
                bucket.pop(j.jid, None)

    def _move(self, j: SimJob, state: Optional[str] = None,
              site: Optional[int] = None) -> None:
        self._index_remove(j)
        if state is not None:
            if j.state == "running":
                # progress only advances while running; sync the column as
                # the job leaves (snapshot refreshes the running bucket)
                self._colf[j.jid, _CF_PROGRESS] = j.progress_s
            j.state = state
            self._coli[j.jid, _CI_STATE] = _STATE_CODE[state]
        if site is not None:
            j.site = site
            self._coli[j.jid, _CI_SITE] = site
        self._index_add(j)

    def _running_count(self, sid: int) -> int:
        return len(self._site_jobs.get((sid, "running"), ()))

    def _queued_count(self, sid: int) -> int:
        return len(self._site_jobs.get((sid, "queued"), ()))

    # -- WAN model -----------------------------------------------------------
    def _nic_bps(self, t: float) -> float:
        """Legacy scalar view (uniform fabrics): the NIC rate at time t."""
        return self.wan_topology.nic_bps_at(t)

    def _effective_bw(self, transfers: List[SimJob], t: float) -> Dict[int, float]:
        """Per-transfer effective bps — the topology's fair share over the
        current flow set (the same model the snapshot advertises)."""
        rates = self.wan_topology.shared_rates(
            [(j.site, j.transfer_dest) for j in transfers], t)
        return {j.jid: float(r) for j, r in zip(transfers, rates)}

    # -- snapshot ------------------------------------------------------------
    def snapshot(self, t: float) -> ClusterState:
        """Build the policy-facing ClusterState from the incremental SoA
        columns (no per-job objects — ``state.jobs`` materializes lazily
        if a scalar consumer asks).  The advertised bandwidth matrix comes
        from the same WanTopology (and flow set) the transfer loop grants
        from; the per-site forecasts are drawn batched, consuming the
        forecaster's noise streams exactly as the per-site scalar calls
        would."""
        cfg = self.cfg
        incoming = [0] * cfg.n_sites
        transfers: List[Tuple[int, int]] = []
        for j in self._by_state["migrating"].values():
            incoming[j.transfer_dest] += 1
            transfers.append((j.site, j.transfer_dest))
        for j in self._by_state["loading"].values():
            incoming[j.site] += 1
        if self.serving is not None:
            # routed request batches occupy the same WAN resources as
            # checkpoint transfers — the advertised matrix must dilute
            # against them too
            transfers.extend(self.serving.flow_pairs())
        active, remaining, next_start = self.forecaster.snapshot_all(t)
        busy = np.array([self._running_count(s) for s in range(cfg.n_sites)],
                        dtype=np.int64)
        queued = np.array([self._queued_count(s) for s in range(cfg.n_sites)],
                          dtype=np.int64)
        inc = np.array(incoming, dtype=np.int64)
        slots = max(cfg.slots_per_site, 1)
        site_arrays = {
            "site_window_s": remaining,
            "site_renewable": active,
            "site_next_window_s": next_start,
            "site_busy": busy,
            "site_slots": self._site_slots_arr,
            "site_load": (busy + queued + inc) / slots,
            "site_free_slots": np.maximum(0, cfg.slots_per_site - busy - inc),
            "site_bq_load": (busy + queued) / slots,
        }
        if cfg.battery is not None:
            # battery timelines are advanced lazily at posting time; the
            # snapshot advertises the ledger's current per-site state of
            # charge (policies treat it as a lower bound — charge landed
            # since a site's last posting shows up at the next one)
            site_arrays["site_battery_soc"] = self.ledger.soc.copy()
        if self.fault_plan is not None:
            # fault-aware policies mask these down; with no active
            # regime the keys stay unseeded and ClusterState's all-up
            # cached-property defaults cost nothing
            site_arrays["site_up"] = self._site_up.copy()
            site_arrays["link_up"] = self._link_up.copy()
        def sites_factory():  # scalar consumers only (lazy)
            return [
                SiteView(
                    sid=s,
                    slots=cfg.slots_per_site,
                    busy=int(busy[s]),
                    queued=int(queued[s]),
                    renewable_active=bool(active[s]),
                    window_remaining_s=float(remaining[s]),
                    incoming=incoming[s],
                    next_window_start_s=float(next_start[s]),
                )
                for s in range(cfg.n_sites)
            ]
        by = self._by_state
        for j in by["running"].values():  # progress advances while running
            self._colf[j.jid, _CF_PROGRESS] = j.progress_s
        jid_list = list(by["queued"])
        jid_list += by["running"]
        jid_list += by["paused"]
        jids = np.array(jid_list, dtype=np.int64)
        jids.sort()
        gf = self._colf[jids]  # one gather for all float columns
        gi = self._coli[jids]
        soa = JobSoA(
            jids=jids,
            site=gi[:, _CI_SITE],
            ckpt_bytes=gf[:, _CF_CKPT],
            remaining_s=gf[:, _CF_COMPUTE] - gf[:, _CF_PROGRESS],
            t_load_s=self._tload_buf[:len(jids)],
            state=gi[:, _CI_STATE],
            eligible=t - gf[:, _CF_LASTMIG] >= cfg.migration_cooldown_s,
            power_frac=gf[:, _CF_POWER],
            defer_until_s=gf[:, _CF_DEFER],
            n_queued=len(by["queued"]),
            n_running=len(by["running"]),
            n_paused=len(by["paused"]),
        )
        return ClusterState.build_soa(t, soa, sites_factory,
                                      n_sites=cfg.n_sites,
                                      wan=self.wan_topology,
                                      transfers=transfers,
                                      forecast=self.forecast_horizon,
                                      site_arrays=site_arrays,
                                      battery=cfg.battery,
                                      serving=(self.serving.view()
                                               if self.serving is not None
                                               else None))

    def _serving_state(self, t: float) -> ClusterState:
        """Light routing snapshot for the serving plane's per-batch
        dispatch.  Unlike :meth:`snapshot` it reads the *noise-free*
        trace stack (``TraceStack.point``), NOT the forecaster — batch
        dispatches happen at request-driven times, and drawing forecast
        noise there would shift the forecaster's RNG stream and break
        the serving-off ⇒ bit-identical guarantee.  Jobs are omitted
        (routers read sites, forecast, WAN and the serving view only)."""
        cfg = self.cfg
        topo = self.wan_topology
        active, remaining, next_start = self._serve_stack.point(t)
        busy = np.array([self._running_count(s) for s in range(cfg.n_sites)],
                        dtype=np.int64)
        site_arrays = {
            "site_window_s": remaining,
            "site_renewable": active,
            "site_next_window_s": next_start,
            "site_busy": busy,
            "site_slots": self._site_slots_arr,
        }
        transfers = [(j.site, j.transfer_dest)
                     for j in self._by_state["migrating"].values()]
        transfers += self.serving.flow_pairs()

        def sites_factory():  # scalar consumers only (rare)
            return [
                SiteView(sid=s, slots=cfg.slots_per_site, busy=int(busy[s]),
                         queued=self._queued_count(s),
                         renewable_active=bool(active[s]),
                         window_remaining_s=float(remaining[s]),
                         next_window_start_s=float(next_start[s]))
                for s in range(cfg.n_sites)
            ]

        # bandwidth: the uncontended capacity matrix (cached per link
        # state) — routers do admission via post_admission_bps, which
        # re-splits against `transfers` through the topology anyway
        return ClusterState.build_soa(
            t, self._empty_soa, sites_factory, n_sites=cfg.n_sites,
            wan=topo, transfers=tuple(transfers),
            bandwidth_bps=topo.capacity_matrix(t),
            forecast=self.forecast_horizon, site_arrays=site_arrays,
            serving=self.serving.view())

    def _has_live_jobs(self) -> bool:
        by = self._by_state
        return bool(by["queued"] or by["running"] or by["paused"])

    # -- action application --------------------------------------------------
    def _apply_action(self, action: Action, t: float, state: ClusterState,
                      horizon: float) -> None:
        if not isinstance(action, Action):
            # e.g. a legacy (jid, dest) tuple from a pre-redesign policy
            self.rejected_actions += 1
            return
        j = self._jobs_by_id.get(action.jid)
        if j is None:
            self.rejected_actions += 1
            return
        if isinstance(action, Migrate):
            dest = action.dest
            if (j.state != "running" or dest == j.site
                    or not 0 <= dest < self.cfg.n_sites
                    or t - j.last_migration_end_s < self.cfg.migration_cooldown_s
                    # a 0-capacity (partitioned) path can never complete the
                    # transfer — admitting it would strand the job forever
                    or not self.wan_topology.reachable(j.site, dest)):
                self.rejected_actions += 1
                return
            j.transfer_dest = dest
            j.transfer_remaining_bits = 8.0 * j.ckpt_bytes
            j.migrations += 1
            self.migrations += 1
            if j.retry_attempts > 0:
                # re-admission after a watchdog abort: one rung up the
                # retry ladder; a different destination is a re-route
                self.retries += 1
                if dest != j.last_failed_dest:
                    self.reroutes += 1
            self._move(j, state="migrating")
            # a migration whose destination window closes before the
            # transfer ends is counted as failed (it still completes,
            # but arrives onto grid power — the paper's stall mode).
            # The arrival estimate uses the POST-admission share: this
            # flow itself dilutes every resource it traverses (flows+1),
            # so ask the topology for the rate with the flow included —
            # the snapshot's pre-admission matrix is systematically
            # optimistic for exactly this query.
            mig = list(self._by_state["migrating"].values())
            pairs = [(x.site, x.transfer_dest) for x in mig]
            if self.serving is not None:
                pairs += self.serving.flow_pairs()  # requests dilute too
            rates = self.wan_topology.shared_rates(pairs, t)
            rate = next(float(r) for x, r in zip(mig, rates) if x.jid == j.jid)
            t_arrive = (t + j.transfer_remaining_bits / rate if rate > 0.0
                        else float("inf"))
            # Post-horizon arrivals are explicitly failed: the trace carries
            # no windows beyond the horizon, and the old clamp to
            # horizon - 1 classified such a transfer by whatever the last
            # in-horizon sample happened to be.
            j.fail_counted = (t_arrive >= horizon
                              or not self.traces[dest].active(t_arrive))
            if j.fail_counted:
                self.failed_migrations += 1
        elif isinstance(action, Defer):
            if j.state != "queued":
                self.rejected_actions += 1
                return
            j.defer_until_s = max(t, float(action.until_s))
            self._colf[j.jid, _CF_DEFER] = j.defer_until_s
        elif isinstance(action, Pause):
            if j.state != "running":
                self.rejected_actions += 1
                return
            self._move(j, state="paused")
        elif isinstance(action, Resume):
            if j.state != "paused":
                self.rejected_actions += 1
                return
            self._move(j, state="queued")
        elif isinstance(action, Throttle):
            if j.state != "running":
                self.rejected_actions += 1
                return
            j.power_frac = float(min(1.0, max(0.0, action.power_frac)))
            curve = self.cfg.throttle_curve
            j.tput_frac = (j.power_frac if curve is None
                           else curve.throughput(j.power_frac))
            self._colf[j.jid, _CF_POWER] = j.power_frac
        else:
            self.rejected_actions += 1

    # -- engine dispatch -----------------------------------------------------
    def run(self) -> SimResult:
        if self.cfg.engine == "event":
            return self._run_event()
        if self.cfg.engine == "fixed-dt":
            return self._run_fixed_dt()
        raise ValueError(
            f"unknown engine {self.cfg.engine!r}; use 'event' or 'fixed-dt'")

    def _result(self, wall_t0: float) -> SimResult:
        serving_kw = {}
        if self.serving is not None:
            srv = self.serving
            p50, p95, p99 = srv.latency_percentiles()
            serving_kw = dict(
                requests_arrived=srv.arrived,
                requests_served=srv.served,
                requests_dropped=srv.dropped,
                requests_shed=srv.shed,
                slo_violations=srv.slo_violations,
                request_gco2=srv.request_gco2,
                site_request_gco2=tuple(float(x)
                                        for x in srv.site_request_gco2),
                serve_grid_kwh=srv.serve_grid_kwh,
                serve_renewable_kwh=srv.serve_renewable_kwh,
                latency_p50_s=p50, latency_p95_s=p95, latency_p99_s=p99,
                queue_depth_p95=srv.queue_depth_p95(),
            )
        led = self.ledger
        # run every site's battery/sell-back timeline out to the end of
        # the horizon (idle sites still charge + export); no-op with
        # storage disabled
        led.finalize(self.cfg.days * 24 * HOUR * 2.0)
        # A transfer still in flight at the horizon never delivered its
        # checkpoint.  The admission pre-count misses exactly the
        # dead-link case: the optimistic (fault-free) arrival estimate
        # is finite, so fail_counted stays False while the transfer
        # silently stalls to the end of the run.  Only fault regimes can
        # zero a link outside the brownout calendar, so the sweep is
        # gated on an active plan and faults-off runs keep their
        # historical accounting.
        if self.fault_plan is not None:
            for j in self._by_state["migrating"].values():
                if not j.fail_counted:
                    j.failed_migrations += 1
                    self.failed_migrations += 1
        self.audit_no_job_lost()
        site_outages, mttr_s = 0, 0.0
        if self.fault_plan is not None:
            site_outages, mttr_s = self.fault_plan.outage_stats(
                max(self._final_t, 0.0))
        return SimResult(
            policy=self.policy.name,
            jobs=self.jobs,
            grid_kwh=led.grid_kwh,
            renewable_kwh=led.renewable_kwh,
            migration_kwh=led.migration_kwh,
            migrations=self.migrations,
            failed_migrations=self.failed_migrations,
            failures=self.failures,
            rejected_actions=self.rejected_actions,
            ticks=self.ticks,
            wall_time_s=time.perf_counter() - wall_t0,
            decide_s=self.decide_s,
            decide_first_s=self.decide_first_s,
            engine=self.cfg.engine,
            grid_gco2=led.grid_gco2,
            grid_cost=led.grid_cost,
            site_grid_gco2=tuple(float(x) for x in led.site_grid_gco2),
            site_grid_cost=tuple(float(x) for x in led.site_grid_cost),
            battery_charge_kwh=led.battery_charge_kwh,
            battery_discharge_kwh=led.battery_discharge_kwh,
            battery_loss_kwh=led.battery_loss_kwh,
            battery_cycles=led.battery_cycles,
            sellback_kwh=led.sellback_kwh,
            sellback_usd=led.sellback_usd,
            dr_requested_ws=led.dr_requested_ws,
            dr_shed_ws=led.dr_shed_ws,
            site_outages=site_outages,
            mttr_s=mttr_s,
            retries=self.retries,
            reroutes=self.reroutes,
            replica_crashes=self.replica_crashes,
            watchdog_aborts=self.watchdog_aborts,
            **serving_kw,
        )

    def audit_no_job_lost(self) -> None:
        """No-job-lost invariant: every admitted job is in exactly one
        lifecycle bucket, each bucket is internally consistent, and a
        job that is not ``done`` is live in a recoverable state (never
        silently dropped by a fault).  Holds for arbitrary fault
        sequences; raises ``AssertionError`` on violation."""
        seen: set = set()
        for name, bucket in self._by_state.items():
            for jid, j in bucket.items():
                assert jid not in seen, f"job {jid} indexed twice"
                seen.add(jid)
                assert j.state == name, (
                    f"job {jid} in bucket {name!r} but state {j.state!r}")
                if name == "done":
                    assert j.done_s >= 0.0, f"done job {jid} missing done_s"
                else:
                    assert j.done_s < 0.0, (
                        f"finished job {jid} stuck in {name!r}")
        assert len(seen) == len(self.jobs), (
            f"{len(self.jobs) - len(seen)} job(s) lost from the index")

    # -- next-event engine ---------------------------------------------------
    def _record_decide(self, dt: float) -> None:
        """Attribute one decide's wall time: the run's FIRST call (kernel
        build and load, lazy caches — cold by construction) lands in
        ``decide_first_s``; every later (warm) tick accumulates in
        ``decide_s``, the number benchmarks gate on."""
        if self._decide_calls == 0:
            self.decide_first_s = dt
        else:
            self.decide_s += dt
        self._decide_calls += 1

    def _run_event(self) -> SimResult:
        """Drive :meth:`_event_gen` to completion with this simulator's
        own policy (the batched sweep runner drives many generators in
        lockstep instead, answering whole groups of yielded snapshots
        with one ``Policy.decide_batch`` call)."""
        wall_t0 = time.perf_counter()
        gen = self._event_gen()
        actions: Optional[List[Action]] = None
        while True:
            try:
                state = gen.send(actions)
            except StopIteration:
                break
            d0 = time.perf_counter()
            actions = self.policy.decide(state)
            self._record_decide(time.perf_counter() - d0)
        return self._result(wall_t0)

    def _event_gen(self):
        """Next-event time stepping as a coroutine: yields the
        ``ClusterState`` snapshot at every orchestrator tick and resumes
        with the caller's action list (``actions = gen.send(...)``).

        Every candidate next event is the min of: next job arrival, the
        earliest transfer completion at current share rates, the earliest
        checkpoint-load completion, the earliest running-job completion,
        the next renewable-window edge, the next WAN brownout edge, the
        next defer expiry, the next node failure, and the next orchestrator
        tick.  Per-job accounting (progress, grid/renewable kWh, queue and
        pause time) is integrated analytically over each inter-event span
        from a per-job ``anchor_s``; transfer rates are re-split only when
        the flow set or the link state changes.  Completion heaps use lazy
        invalidation: entries carry the job's ``ver`` at push time and are
        discarded on pop if the job changed since.
        """
        cfg = self.cfg
        horizon = cfg.days * 24 * HOUR
        t_end = horizon * 2.0  # allow the tail of late jobs to finish
        INF = float("inf")
        EPS = 1e-6
        by_state = self._by_state
        jobs_by_id = self._jobs_by_id
        topo = self.wan_topology
        traces = self.traces
        serving = self.serving
        ledger = self.ledger
        n_jobs = len(self.jobs)
        p_node, p_sys = cfg.p_node_kw, cfg.p_sys_kw

        done_heap: List[Tuple[float, int, int]] = []  # running completions
        transfer_heap: List[Tuple[float, int, int]] = []
        load_heap: List[Tuple[float, int, int]] = []
        defer_heap: List[Tuple[float, int]] = []
        stall_heap: List[Tuple[float, int]] = []  # watchdog deadlines
        edges = sorted({e for tr in traces for w in tr.windows
                        for e in (w.start_s, w.end_s) if 0.0 < e < t_end})
        eptr = 0
        next_orch = 0.0
        next_brownout = topo.next_transition(0.0)
        next_failure = INF
        # legacy per-job Poisson rollback: the SimConfig scalar is the
        # alias path; a FaultRegime's job_failure rate adds to it
        fail_rate = cfg.failure_rate_per_slot_hour + (
            cfg.faults.job_failure_rate_per_slot_hour
            if cfg.faults is not None else 0.0)
        fail_enabled = fail_rate > 0.0
        # fault plan + recovery machinery.  With no active regime every
        # hook below is None-gated: zero extra draws, zero float ops.
        plan = self.fault_plan
        regime = cfg.faults
        ckpt_interval = cfg.checkpoint_interval_s
        if regime is not None and regime.checkpoint_interval_s is not None:
            ckpt_interval = regime.checkpoint_interval_s
        corrupt_p = regime.ckpt_corruption_prob if plan is not None else 0.0
        corrupt_rng = (plan.corruption_rng()
                       if plan is not None and corrupt_p > 0.0 else None)
        stall_timeout = (regime.stall_timeout_s if regime is not None
                         else cfg.stall_timeout_s)
        retry = regime.retry if regime is not None else RetryPolicy()
        fault_tput: Optional[np.ndarray] = None
        next_fault = INF
        if plan is not None:
            self._site_up = plan.site_up_vec(0.0)
            self._link_up = plan.link_up_mat(0.0)
            if serving is not None:
                self._replica_down = plan.replica_down_vec(0.0)
            if regime.straggler_rate_per_day > 0.0:
                fault_tput = plan.tput_factor_vec(0.0)
            next_fault = plan.next_edge_after(0.0)

        def resample_failure(t: float) -> None:
            nonlocal next_failure
            n_run = len(by_state["running"])
            if not fail_enabled or n_run == 0:
                next_failure = INF
                return
            lam = fail_rate * n_run / HOUR
            next_failure = t + float(self._fail_rng.exponential(1.0 / lam))

        def rollback(j: SimJob) -> None:
            """Roll a (flushed) job back to its last checkpoint; with
            corruption enabled, a Bernoulli draw can cost one more
            interval (its own RNG stream — one draw per rollback)."""
            ckpt = (j.progress_s // ckpt_interval) * ckpt_interval
            if corrupt_rng is not None and corrupt_rng.random() < corrupt_p:
                ckpt = max(0.0, ckpt - ckpt_interval
                           * regime.ckpt_corruption_extra_intervals)
            lost = j.progress_s - ckpt
            j.progress_s = ckpt
            j.last_ckpt_progress_s = ckpt
            j.pause_s += lost

        def flush(j: SimJob, t: float) -> None:
            span = t - j.anchor_s
            if span <= 0.0:
                j.anchor_s = t
                return
            st = j.state
            if st == "running":
                frac = j.power_frac
                tput = j.tput_frac
                if fault_tput is not None:  # straggler degradation
                    tput = tput * fault_tput[j.site]
                j.progress_s += span * tput
                g = traces[j.site].renewable_seconds(j.anchor_s, t)
                e_g, e_b = ledger.post_train(
                    j.site, p_node * frac, j.anchor_s, t, g,
                    p_nominal_kw=p_node)
                j.renewable_kwh += e_g
                j.grid_kwh += e_b
            elif st == "migrating":
                j.transfer_remaining_bits -= j.rate_bps * span
                j.pause_s += span
                j.pause_transfer_s += span
                ledger.post_migration(j.site, p_sys, j.anchor_s, t)
            elif st == "loading":
                j.load_remaining_s -= span
                j.pause_s += span
                j.pause_transfer_s += span
            elif st == "queued":
                j.queue_s += span
                if j.post_migration_wait:
                    j.pause_s += span  # stalled by its own migration
                    j.pause_wait_s += span
            elif st == "paused":
                j.paused_policy_s += span
            j.anchor_s = t

        def flush_live(t: float) -> None:
            for name in ("running", "queued", "paused", "migrating", "loading"):
                for j in by_state[name].values():
                    flush(j, t)

        def flush_running(t: float) -> None:
            # the snapshot only reads *running* progress; every other
            # state's accounting is flushed at its own transitions
            for j in by_state["running"].values():
                flush(j, t)

        def refresh_transfers(t: float) -> None:
            """Re-split in-flight transfer rates (flow set / link state
            changed) and requeue their completion events.  Checkpoint
            migrations and routed request batches form ONE flow set over
            the shared topology — each dilutes the other."""
            mig = list(by_state["migrating"].values())
            srv_pairs = serving.flow_pairs() if serving is not None else []
            if not mig and not srv_pairs:
                return
            pairs = [(j.site, j.transfer_dest) for j in mig] + srv_pairs
            rates = topo.shared_rates(pairs, t)
            if plan is not None:
                # hard fault overlay: the topology stays pure (it only
                # knows the *scheduled* brownout calendar) — a failed
                # link or a blacked-out endpoint zeroes the flow here
                lu = self._link_up
                rates = [r if lu[a, b] else 0.0
                         for (a, b), r in zip(pairs, rates)]
            for j, r in zip(mig, rates):
                flush(j, t)
                j.rate_bps = float(r)
                j.ver += 1
                if j.rate_bps > 0.0:
                    # link (re)carrying traffic: a partial transfer
                    # resumes from its surviving remaining_bits
                    j.stall_since_s = -1.0
                    heapq.heappush(
                        transfer_heap,
                        (t + j.transfer_remaining_bits / j.rate_bps,
                         j.jid, j.ver))
                # rate 0 (no link / browned out to zero / hard fault):
                # no completion until a link-state change re-rates the
                # flow — arm the stall watchdog so a path that never
                # recovers can no longer strand the job forever
                elif j.stall_since_s < 0.0:
                    j.stall_since_s = t
                    heapq.heappush(stall_heap, (t + stall_timeout, j.jid))
            if serving is not None and srv_pairs:
                serving.rerate(t, rates[len(mig):])

        def push_run_completion(j: SimJob, t: float) -> None:
            j.ver += 1
            tput = j.tput_frac
            if fault_tput is not None:  # straggler degradation
                tput = tput * fault_tput[j.site]
            if tput > 0.0:
                heapq.heappush(
                    done_heap,
                    (t + (j.compute_s - j.progress_s) / tput,
                     j.jid, j.ver))

        def schedule_site(s: int, t: float) -> None:
            if plan is not None and not self._site_up[s]:
                return  # blacked out: no slots until repair
            q = self._site_jobs.get((s, "queued"))
            if not q:
                return
            free = cfg.slots_per_site - self._running_count(s)
            if free <= 0:
                return
            ready = [j for j in q.values() if j.defer_until_s <= t]
            if not ready:
                return
            ready.sort(key=lambda x: (x.arrival_s, x.jid))
            for j in ready[:free]:
                flush(j, t)
                j.post_migration_wait = False
                if j.started_s < 0:
                    j.started_s = t
                self._move(j, state="running")
                j.anchor_s = t
                push_run_completion(j, t)

        def peek(heap: List[Tuple[float, int, int]], want_state: str) -> float:
            while heap:
                tt, jid, ver = heap[0]
                j = jobs_by_id[jid]
                if j.state == want_state and j.ver == ver:
                    return tt
                heapq.heappop(heap)
            return INF

        def peek_stall() -> float:
            """Next valid watchdog deadline.  Entries are validated
            against the job's live stall state: recovered (or finished)
            transfers drop out; a transfer that stalled again later is
            re-pushed at its fresh ``stall_since + timeout`` deadline."""
            while stall_heap:
                tt, jid = stall_heap[0]
                j = jobs_by_id[jid]
                if (j.state != "migrating" or j.rate_bps > 0.0
                        or j.stall_since_s < 0.0):
                    heapq.heappop(stall_heap)
                    continue
                due = j.stall_since_s + stall_timeout
                if tt < due - EPS:
                    heapq.heappop(stall_heap)
                    heapq.heappush(stall_heap, (due, jid))
                    continue
                return tt
            return INF

        def watchdog_abort(j: SimJob, t: float) -> None:
            """Abort a dead in-flight transfer: the checkpoint never
            left the source, so the job requeues there; the retry ladder
            (bounded attempts, exponential backoff via the migration-
            eligibility clock) decides when it may try again."""
            flush(j, t)
            dest = j.transfer_dest
            j.transfer_remaining_bits = 0.0
            j.transfer_dest = -1
            j.rate_bps = 0.0
            j.stall_since_s = -1.0
            j.last_failed_dest = dest
            j.retry_attempts += 1
            j.failed_migrations += 1
            self.watchdog_aborts += 1
            if not j.fail_counted:
                self.failed_migrations += 1
            j.fail_counted = False
            j.ver += 1
            j.post_migration_wait = True  # queue wait = its own stall
            if j.retry_attempts >= retry.max_attempts:
                # out of retries: the job still runs locally — it is
                # simply never offered for migration again
                j.last_migration_end_s = 1e18
            else:
                backoff = retry.backoff_s(j.retry_attempts)
                j.last_migration_end_s = t + max(
                    0.0, backoff - cfg.migration_cooldown_s)
            self._colf[j.jid, _CF_LASTMIG] = j.last_migration_end_s
            self._move(j, state="queued")
            j.anchor_s = t

        def apply_fault_edges(t: float, dirty: set) -> bool:
            """Advance the live fault-state caches across the plan edges
            at ``t``: blackout starts roll back + requeue the site's
            workers, repairs re-open scheduling, straggler flips re-rate
            running completions, replica crashes/returns reach the
            serving plane.  Returns True when WAN flows must re-rate."""
            nonlocal fault_tput
            new_site_up = plan.site_up_vec(t)
            new_link_up = plan.link_up_mat(t)
            link_changed = not np.array_equal(new_link_up, self._link_up)
            started = (~new_site_up) & self._site_up
            repaired = new_site_up & (~self._site_up)
            for s in np.nonzero(started)[0]:
                s = int(s)
                # running jobs: every slot is down — checkpoint
                # rollback (corruption possible) and back to the queue
                for j in list(self._site_jobs.get((s, "running"),
                                                  {}).values()):
                    flush(j, t)
                    rollback(j)
                    self.failures += 1
                    j.ver += 1
                    self._move(j, state="queued")
                    j.anchor_s = t
                # interrupted checkpoint loads: the checkpoint landed
                # intact — the arrival requeues and waits out the repair
                for j in [x for x in by_state["loading"].values()
                          if x.site == s]:
                    flush(j, t)
                    j.load_remaining_s = 0.0
                    j.post_migration_wait = True
                    j.last_migration_end_s = t
                    self._colf[j.jid, _CF_LASTMIG] = t
                    j.ver += 1
                    self._move(j, state="queued")
                    j.anchor_s = t
            for s in np.nonzero(repaired)[0]:
                dirty.add(int(s))  # freed slots: schedule FIFO below
            self._site_up = new_site_up
            self._link_up = new_link_up
            if fault_tput is not None:
                new_tput = plan.tput_factor_vec(t)
                flipped = np.nonzero(new_tput != fault_tput)[0]
                if len(flipped):
                    affected = []
                    for s in flipped:
                        affected.extend(self._site_jobs.get(
                            (int(s), "running"), {}).values())
                    for j in affected:
                        flush(j, t)  # old factor up to t
                    fault_tput = new_tput
                    for j in affected:
                        push_run_completion(j, t)  # new factor from t
            if serving is not None:
                new_rep = plan.replica_down_vec(t)
                for s in np.nonzero(new_rep & ~self._replica_down)[0]:
                    link_changed |= serving.crash_replica(int(s), t)
                    self.replica_crashes += 1
                for s in np.nonzero(self._replica_down & ~new_rep)[0]:
                    link_changed |= serving.repair_replica(int(s), t)
                self._replica_down = new_rep
            return link_changed

        arrivals = self._arrivals
        # span-advance fast path: a chunked plane exposes process_span;
        # the scalar plane (serving_engine="event") does not, keeping the
        # historical one-heap-event-per-request interleave
        serving_span = getattr(serving, "process_span", None)
        t = 0.0
        while (len(by_state["done"]) < n_jobs
               or (serving is not None and serving.pending())):
            t_arr = (arrivals[self._arrival_ptr].arrival_s
                     if self._arrival_ptr < len(arrivals) else INF)
            t_ld = peek(load_heap, "loading")
            t_df = defer_heap[0][0] if defer_heap else INF
            t_ed = edges[eptr] if eptr < len(edges) else INF
            t_other = min(t_arr, peek(transfer_heap, "migrating"), t_ld,
                          t_df, peek(done_heap, "running"), t_ed,
                          next_brownout, next_failure, next_orch,
                          next_fault, peek_stall())
            t_srv = serving.next_event_s() if serving is not None else INF
            if (serving_span is not None and t_srv < t_other - EPS
                    and t_srv <= t_end):
                # every serving event strictly clear of the next engine
                # event advances in one span (one engine iteration per
                # event the per-event path would have ticked through);
                # events that could coalesce with an engine event fall
                # through to the normal tick below
                n_ev, t_last, fdirty = serving_span(t_other - EPS, t_end,
                                                    EPS)
                if n_ev:
                    t = t_last
                    self.ticks += n_ev
                    if fdirty:
                        refresh_transfers(t_last)
                    continue
            t_next = t_other if t_other < t_srv else t_srv
            if t_next > t_end:
                flush_live(t_end)  # account the unfinished tail to horizon
                break
            t = t_next
            self.ticks += 1
            dirty: set = set()
            transfers_dirty = False
            n_run_before = len(by_state["running"])

            # 1) arrivals
            while (self._arrival_ptr < len(arrivals)
                   and arrivals[self._arrival_ptr].arrival_s <= t + EPS):
                j = arrivals[self._arrival_ptr]
                self._arrival_ptr += 1
                if j.state == "pending":
                    self._move(j, state="queued")
                    j.anchor_s = t
                    dirty.add(j.site)
            # 2) WAN brownout edge: link capacities changed
            if next_brownout <= t + EPS:
                transfers_dirty = True
                next_brownout = topo.next_transition(t + EPS)
            # 2b) fault-plan span edges: blackouts start/repair, links
            #     fail/recover, straggler factors flip, replicas crash
            if plan is not None and next_fault <= t + EPS:
                transfers_dirty |= apply_fault_edges(t, dirty)
                next_fault = plan.next_edge_after(t + EPS)
            # 3) transfer completions (at current share rates)
            while peek(transfer_heap, "migrating") <= t + EPS:
                _, jid, _ = heapq.heappop(transfer_heap)
                j = jobs_by_id[jid]
                flush(j, t)
                j.transfer_remaining_bits = 0.0
                dest = j.transfer_dest
                j.transfer_dest = -1
                j.rate_bps = 0.0
                j.load_remaining_s = cfg.t_load_s + cfg.t_downtime_s
                self._move(j, state="loading", site=dest)
                j.anchor_s = t
                heapq.heappush(load_heap, (t + j.load_remaining_s, jid,
                                           j.ver))
                transfers_dirty = True
            # 4) checkpoint-load completions (ver-checked: a blackout can
            #    interrupt a load and requeue the job before this fires)
            while peek(load_heap, "loading") <= t + EPS:
                _, jid, _ = heapq.heappop(load_heap)
                j = jobs_by_id[jid]
                flush(j, t)
                j.load_remaining_s = 0.0
                j.post_migration_wait = True
                j.last_migration_end_s = t
                self._colf[jid, _CF_LASTMIG] = t
                j.retry_attempts = 0  # a landed migration resets the ladder
                j.last_failed_dest = -1
                self._move(j, state="queued")
                j.anchor_s = t
                dirty.add(j.site)
            # 5) defer expiries: the held job becomes schedulable
            while defer_heap and defer_heap[0][0] <= t + EPS:
                _, jid = heapq.heappop(defer_heap)
                j = jobs_by_id[jid]
                if j.state == "queued":
                    dirty.add(j.site)
            # 6) running-job completions
            while peek(done_heap, "running") <= t + EPS:
                _, jid, _ = heapq.heappop(done_heap)
                j = jobs_by_id[jid]
                flush(j, t)
                j.progress_s = j.compute_s
                j.done_s = t
                dirty.add(j.site)
                self._move(j, state="done")
            # 7) node failure: roll back to the last checkpoint
            if next_failure <= t + EPS:
                running = by_state["running"]
                if running:
                    jids = sorted(running)
                    jid = jids[int(self._fail_rng.integers(len(jids)))]
                    j = running[jid]
                    flush(j, t)
                    interval = cfg.checkpoint_interval_s
                    ckpt = (j.progress_s // interval) * interval
                    lost = j.progress_s - ckpt
                    j.progress_s = ckpt
                    j.last_ckpt_progress_s = ckpt
                    j.pause_s += lost
                    self.failures += 1
                    push_run_completion(j, t)
                resample_failure(t)
            # 8) renewable-window edges: pure span boundaries (energy is
            #    integrated analytically, so only the pointer advances)
            while eptr < len(edges) and edges[eptr] <= t + EPS:
                eptr += 1
            # 8b) serving events: request arrivals, batch closes, routed-
            #     batch landings, service completions.  A changed flow set
            #     re-splits EVERY WAN rate below (migrations included)
            if serving is not None and t_srv <= t + EPS:
                transfers_dirty |= serving.process(t, EPS)
            if transfers_dirty:
                refresh_transfers(t)
                transfers_dirty = False
            # 8c) transfer-stall watchdog: rates are fresh now — any
            #     transfer still at rate 0 past its deadline aborts,
            #     requeues at the source and climbs the retry ladder
            #     (the freed flow re-rates the survivors)
            if peek_stall() <= t + EPS:
                while peek_stall() <= t + EPS:
                    _, jid = heapq.heappop(stall_heap)
                    watchdog_abort(jobs_by_id[jid], t)
                    dirty.add(jobs_by_id[jid].site)
                refresh_transfers(t)
            # 9) scheduling: fill freed slots at touched sites, FIFO
            for s in sorted(dirty):
                schedule_site(s, t)
            dirty.clear()
            # 10) orchestrator tick: snapshot -> typed actions -> apply
            if next_orch <= t + EPS:
                next_orch = t + cfg.orch_dt_s
                if self._has_live_jobs():
                    flush_running(t)
                    state = self.snapshot(t)
                    actions = yield state
                    for action in actions:
                        j = (jobs_by_id.get(action.jid)
                             if isinstance(action, Action) else None)
                        pre = ((j.state, j.tput_frac, j.defer_until_s)
                               if j is not None else None)
                        if j is not None:
                            flush(j, t)  # account up to t before any move
                        self._apply_action(action, t, state, horizon)
                        if j is None:
                            continue
                        st0, tput0, defer0 = pre
                        if j.state != st0:
                            dirty.add(j.site)  # slot freed / job re-queued
                            if j.state == "migrating":
                                transfers_dirty = True
                        if j.tput_frac != tput0:
                            push_run_completion(j, t)  # throttle re-rates
                        if j.defer_until_s != defer0:
                            dirty.add(j.site)
                            if j.defer_until_s > t:
                                heapq.heappush(
                                    defer_heap, (j.defer_until_s, j.jid))
                    if transfers_dirty:
                        refresh_transfers(t)
                    for s in sorted(dirty):
                        schedule_site(s, t)
            if fail_enabled and len(by_state["running"]) != n_run_before:
                resample_failure(t)
        self._final_t = t

    # -- legacy fixed-dt engine (parity reference) ---------------------------
    def _run_fixed_dt(self) -> SimResult:
        if self.serving is not None:
            raise ValueError(
                "the serving plane requires the next-event engine; "
                "use engine='event' (fixed-dt is the training-only "
                "parity reference)")
        if self.cfg.faults is not None:
            raise ValueError(
                "fault injection (SimConfig.faults) requires the "
                "next-event engine; use engine='event' (blackout/"
                "link-failure edges and the stall watchdog are "
                "event sources, not tick samples)")
        if self.cfg.battery is not None:
            raise ValueError(
                "battery storage requires the next-event engine; "
                "use engine='event' (the charge/discharge timeline is "
                "integrated analytically per span)")
        cfg = self.cfg
        wall_t0 = time.perf_counter()
        horizon = cfg.days * 24 * HOUR
        # allow the tail of late jobs to finish
        t, t_end = 0.0, horizon * 2.0
        next_orch = 0.0
        n_jobs = len(self.jobs)
        by_state = self._by_state
        site_jobs = self._site_jobs
        while t < t_end:
            dt = cfg.dt_s
            self.ticks += 1
            # 1) arrivals (pending jobs, in arrival order)
            while (self._arrival_ptr < len(self._arrivals)
                   and self._arrivals[self._arrival_ptr].arrival_s <= t):
                j = self._arrivals[self._arrival_ptr]
                self._arrival_ptr += 1
                if j.state == "pending":
                    self._move(j, state="queued")
            # per-tick signal samples (rectangle rule; the stacks cache
            # the per-segment column, so this is one bisect per tick)
            carb = self.signals.carbon.value_grid(t)
            price = self.signals.price.value_grid(t)
            # 2) transfers progress
            if by_state["migrating"]:
                transfers = list(by_state["migrating"].values())
                eff = self._effective_bw(transfers, t)
                for j in transfers:
                    rate = eff[j.jid]
                    j.transfer_remaining_bits -= rate * dt
                    j.pause_s += dt
                    j.pause_transfer_s += dt
                    e = cfg.p_sys_kw * dt / HOUR
                    self.ledger.post_migration_tick(j.site, e, carb, price)
                    if j.transfer_remaining_bits <= 0:
                        dest = j.transfer_dest
                        j.transfer_dest = -1
                        j.load_remaining_s = cfg.t_load_s + cfg.t_downtime_s
                        self._move(j, state="loading", site=dest)
            # 3) checkpoint loads
            if by_state["loading"]:
                for j in list(by_state["loading"].values()):
                    j.load_remaining_s -= dt
                    j.pause_s += dt
                    j.pause_transfer_s += dt
                    if j.load_remaining_s <= 0:
                        j.post_migration_wait = True
                        j.last_migration_end_s = t
                        self._colf[j.jid, _CF_LASTMIG] = t
                        self._move(j, state="queued")
            # 4) scheduling: fill free slots FIFO (Defer holds jobs back)
            for s in range(cfg.n_sites):
                q = site_jobs.get((s, "queued"))
                if not q:
                    continue
                free = cfg.slots_per_site - self._running_count(s)
                if free <= 0:
                    continue
                ready = [j for j in q.values() if j.defer_until_s <= t]
                ready.sort(key=lambda x: (x.arrival_s, x.jid))
                for j in ready[:free]:
                    j.post_migration_wait = False
                    if j.started_s < 0:
                        j.started_s = t
                    self._move(j, state="running")
            # 5) compute progress + energy + failures
            for s in range(cfg.n_sites):
                running = site_jobs.get((s, "running"))
                if not running:
                    continue
                green = self.traces[s].active(t)
                for j in list(running.values()):
                    frac = j.power_frac
                    j.progress_s += dt * j.tput_frac
                    e = cfg.p_node_kw * frac * dt / HOUR
                    if green:
                        j.renewable_kwh += e
                    else:
                        j.grid_kwh += e
                    self.ledger.post_train_tick(s, e, green, carb, price)
                    self.ledger.post_dr(s, cfg.p_node_kw * frac,
                                        cfg.p_node_kw, t, t + dt)
                    if j.progress_s - j.last_ckpt_progress_s >= cfg.checkpoint_interval_s:
                        j.last_ckpt_progress_s = j.progress_s
                    if cfg.failure_rate_per_slot_hour > 0.0:
                        if self._fail_rng.random() < cfg.failure_rate_per_slot_hour * dt / HOUR:
                            # node failure: roll back to last checkpoint
                            lost = j.progress_s - j.last_ckpt_progress_s
                            j.progress_s = j.last_ckpt_progress_s
                            j.pause_s += lost
                            self.failures += 1
                    if j.progress_s >= j.compute_s:
                        j.done_s = t
                        self._move(j, state="done")
            # queue / pause time accounting
            for j in by_state["queued"].values():
                j.queue_s += dt
                if j.post_migration_wait:
                    j.pause_s += dt  # stalled by its own migration
                    j.pause_wait_s += dt
            for j in by_state["paused"].values():
                j.paused_policy_s += dt
            # 6) orchestrator tick: snapshot -> typed actions -> apply
            if t >= next_orch:
                next_orch = t + cfg.orch_dt_s
                if self._has_live_jobs():
                    state = self.snapshot(t)
                    d0 = time.perf_counter()
                    actions = self.policy.decide(state)
                    self._record_decide(time.perf_counter() - d0)
                    for action in actions:
                        self._apply_action(action, t, state, horizon)
            if len(by_state["done"]) == n_jobs:
                break
            t += dt
        return self._result(wall_t0)

    # -- scenario entry point ------------------------------------------------
    @classmethod
    def from_scenario(
        cls,
        scenario,
        policy: Union[str, Policy],
        *,
        overrides: Optional[dict] = None,
        jobs: Optional[List[SimJob]] = None,
        traces: Optional[List[SiteTrace]] = None,
        device: DeviceLike = None,
    ) -> "ClusterSimulator":
        """Build a simulator from a registered scenario name (or Scenario)
        and a registered policy name (or Policy instance).  When the
        policy is resolved by name, the scenario's ``policy_configs``
        entry for it (if any) supplies constructor kwargs — an explicit
        Policy instance is used as-is.  ``device``: see the constructor."""
        from repro_torch.core.scenarios import get_scenario

        scn = get_scenario(scenario)
        cfg = scn.sim_config(**(overrides or {}))
        if isinstance(policy, str):
            pconf = scn.policy_configs.get(
                policy.lower().replace("_", "-"), {})
            pol = make_policy(policy, device=device, **dict(pconf))
        else:
            pol = policy
        return cls(cfg, pol, jobs=jobs, traces=traces,
                   oracle_forecast=getattr(pol, "wants_oracle_forecast", False),
                   device=device)


def run_policy_comparison(
    cfg: Optional[SimConfig] = None,
    policies: Sequence[str] = ("static", "energy-only", "feasibility-aware", "oracle"),
    *,
    scenario=None,
    overrides: Optional[dict] = None,
    policy_configs: Optional[Dict[str, Union[PolicyConfig, dict]]] = None,
    device: DeviceLike = None,
) -> Dict[str, SimResult]:
    """Table VI / VIII: same trace + same jobs, one run per policy.

    ``scenario`` names a registered scenario (or passes a ``Scenario``);
    ``overrides`` tweaks individual ``SimConfig`` fields on top of it;
    ``policy_configs`` maps policy name -> ``PolicyConfig`` (or kwargs dict),
    so per-policy knobs like stochastic feasibility ``eps`` /
    ``forecast_sigma_s`` reach the comparison path.

    Implemented as a one-cell sweep through :mod:`repro_torch.core.sweep`
    (run inline, no process pool): the cell runner is what provides the
    same-trace-same-jobs guarantee, for this comparison and for every
    seed of a Monte-Carlo sweep alike.  ``device``: see the constructor.
    """
    from repro_torch.core.sweep import run_cells

    label = "config"
    if scenario is not None:
        if cfg is not None:
            raise ValueError(
                "pass either cfg or scenario (+overrides), not both")
        from repro_torch.core.scenarios import get_scenario

        scn = get_scenario(scenario)
        label = scn.name
        cfg = scn.sim_config(**(overrides or {}))
        if scn.policy_configs:
            # scenario-scoped defaults; explicit policy_configs win
            merged = {k: dict(v) for k, v in scn.policy_configs.items()}
            merged.update(dict(policy_configs or {}))
            policy_configs = merged
    elif overrides:
        cfg = dataclasses.replace(cfg or SimConfig(), **overrides)
    cfg = cfg or SimConfig()
    res = run_cells(
        [(cfg, label, cfg.seed, tuple(policies), dict(policy_configs or {}),
          True, cfg.seed)],
        workers=1, device=device)
    return {r.policy: r.result for r in res.runs}


def normalized_table(results: Dict[str, SimResult]) -> List[dict]:
    """Paper Table VI/VIII format: normalized to the static baseline, plus
    the action-validity and engine-throughput columns benchmarks surface."""
    base = results["static"]
    any_serving = any(r.requests_arrived > 0 for r in results.values())
    any_dr = any(r.dr_requested_ws > 0.0 for r in results.values())
    any_batt = any(r.battery_charge_kwh > 0.0 or r.sellback_kwh > 0.0
                   for r in results.values())
    any_faults = any(r.site_outages > 0 or r.watchdog_aborts > 0
                     or r.replica_crashes > 0 for r in results.values())
    rows = []
    for name, r in results.items():
        row = {
            "policy": name,
            "nonrenew_energy": round(r.grid_kwh / base.grid_kwh, 2) if base.grid_kwh else 0.0,
            "grid_gco2": round(r.grid_gco2 / base.grid_gco2, 2) if base.grid_gco2 else 0.0,
            "grid_cost": round(r.grid_cost / base.grid_cost, 2) if base.grid_cost else 0.0,
            "jct": round(r.mean_jct_s / base.mean_jct_s, 2),
            "migration_overhead": round(r.migration_overhead, 3),
            "stall_overhead": round(r.stall_overhead, 3),
            "renewable_frac": round(r.renewable_fraction, 3),
            "rejected_actions": r.rejected_actions,
            "ticks_per_sec": round(r.ticks_per_sec, 1),
            "decide_s": round(r.decide_s, 4),
        }
        if any_dr:
            # fraction of CurtailRequest span-watts actually shed
            row["dr_compliance"] = round(r.dr_compliance, 4)
        if any_batt:
            row["battery_cycles"] = round(r.battery_cycles, 3)
            row["sellback_usd"] = round(r.sellback_usd, 4)
        if any_faults:
            row["completed"] = r.completed
            row["site_outages"] = r.site_outages
            row["mttr_s"] = round(r.mttr_s, 1)
            row["retries"] = r.retries
            row["reroutes"] = r.reroutes
            row["watchdog_aborts"] = r.watchdog_aborts
            row["failed_migrations"] = r.failed_migrations
        if any_serving:
            row["requests_served"] = r.requests_served
            row["slo_attainment"] = round(r.slo_attainment, 4)
            row["request_gco2"] = round(r.request_gco2, 1)
            row["latency_p95_s"] = round(r.latency_p95_s, 3)
        rows.append(row)
    return rows
