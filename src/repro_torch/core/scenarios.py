"""Scenario registry: named, composable experiment setups.

A :class:`Scenario` bundles everything that defines an experiment other
than the policy: the renewable trace profile, the job mix, the WAN
topology/failure behaviour, the node-failure regime and the forecast noise.
The simulator (``ClusterSimulator.from_scenario`` /
``run_policy_comparison(scenario=...)``), the benchmarks and the examples
all consume scenarios by name, so new workloads are added here once instead
of by editing ``SimConfig`` defaults at every call site.

Built-ins:

  paper-table6       the paper's §VII setup (5 sites, 10 Gbps, 240 jobs,
                     7-day CAISO-calibrated trace, A/B/C = 70/20/10)
  flaky-wan          inter-site links randomly degrade to 0.5 Gbps for
                     hour-long episodes — feasibility filtering matters most
  solar-heavy        long midday surplus windows, little night wind
  large-ckpt-classC  half the jobs carry 100–300 GB (class C) checkpoints
  failure-storm      aggressive node failures + checkpoint/restart churn
  hub-spoke-wan      40 Gbps hub at site 0, 1 Gbps direct spoke-to-spoke
  asymmetric-uplink  2.5 Gbps egress / 10 Gbps ingress NICs everywhere
  partitioned-wan    two island fabrics joined by thin 0.25 Gbps links
  forecastable-brownouts  per-link brownout calendars readable through
                     state.forecast — the plan-ahead policy's home turf
  carbon-peaks       hard duck-curve carbon intensity (evening ~700
                     gCO2/kWh over a midday trough) — the
                     receding-horizon policy's home turf
  price-spread       wide per-site wholesale price spread; grid_cost
                     separates policies the kWh columns cannot
  demand-response    advisory curtail-request events during carbon peaks,
                     honoured only by signal-aware policies
  battery-bridging   per-site 20 kWh batteries charge from curtailed midday
                     surplus and discharge through the evening carbon peak
  sellback-spread    price seams + a 5 kW export line gated at 0.12 $/kWh:
                     sell-back revenue separates sites carbon cannot
  inference-diurnal  serving-dominated: evening-peaked request stream over
                     a light training load, routed green-first
  train-plus-serve   the combined fabric: paper-table6 training plus a
                     carbon-slo-routed inference stream on the same WAN
  chaos-monkey       all five fault classes at once at mild rates — the
                     whole recovery spine on one run, every job completes
  blackout-cascade   rolling correlated site blackouts + hard link
                     failures; fault-aware planning vs the fault-blind trap

The WAN half of a scenario is a :class:`repro_torch.core.wan.WanProfile`
(per-site NIC rates, per-link capacity matrix, fabric- or per-link-scoped
brownouts); ``Scenario.build_wan()`` materializes the
:class:`~repro_torch.core.wan.WanTopology` that the simulator, the dry-run
planner and the serve router all consume.

Register your own:

    from repro_torch.core.scenarios import Scenario, register_scenario
    register_scenario(Scenario(name="my-case", description="...",
                               wan=WanProfile(gbps=1.0)))

Scenarios are frozen dataclasses — derive variants with
``dataclasses.replace`` (composability without mutation).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Union

from repro_torch.core.faults import FaultRegime, RetryPolicy
from repro_torch.core.ledger import BatteryConfig, ThrottleCurve
from repro_torch.core.serving import ServingProfile
from repro_torch.core.signals import SignalProfile
from repro_torch.core.traces import SiteTrace, TraceProfile, generate_trace
from repro_torch.core.wan import (  # noqa: F401  (WanProfile re-exported)
    WanProfile, WanTopology, hub_spoke_links, partitioned_links,
)


@dataclass(frozen=True)
class JobMix:
    """Arrival volume and checkpoint-size classes (paper §VII)."""

    n_jobs: int = 240
    frac_a: float = 0.70
    frac_b: float = 0.20
    size_a_gb: tuple = (1.0, 6.0)
    size_b_gb: tuple = (10.0, 40.0)
    size_c_gb: tuple = (100.0, 300.0)
    mean_compute_h: float = 3.5


@dataclass(frozen=True)
class FailureRegime:
    """Legacy per-job Poisson rollback spec — the alias path for
    :class:`repro_torch.core.faults.FaultRegime.job_failure_rate_per_slot_hour`.
    New scenarios should carry a ``faults=FaultRegime(...)`` instead;
    both feed the same unified ``default_rng([seed, 23])`` stream."""

    rate_per_slot_hour: float = 0.0
    checkpoint_interval_s: float = 1800.0


@dataclass(frozen=True)
class ForecastNoise:
    sigma_s: float = 900.0  # 15-min 1-sigma error on remaining-window
    horizon_s: float = 24 * 3600.0  # ClusterState.forecast lookahead


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    n_sites: int = 5
    slots_per_site: int = 4
    days: int = 7
    dt_s: float = 30.0
    engine: str = "event"  # "event" (next-event) or "fixed-dt" (legacy)
    seed: int = 0
    trace: TraceProfile = field(default_factory=TraceProfile)
    jobs: JobMix = field(default_factory=JobMix)
    wan: WanProfile = field(default_factory=WanProfile)
    failures: FailureRegime = field(default_factory=FailureRegime)
    # fault-injection spec (core/faults.py): site blackouts, hard link
    # failures, checkpoint corruption, replica crashes, stragglers +
    # the recovery knobs (None = no injected faults; the legacy
    # ``failures`` field above remains the per-job-rollback alias)
    faults: Optional[FaultRegime] = None
    forecast: ForecastNoise = field(default_factory=ForecastNoise)
    signals: SignalProfile = field(default_factory=SignalProfile)
    # inference serving plane (None / disabled profile = training only)
    serving: Optional[ServingProfile] = None
    serving_router: str = "green-first"
    # prosumer microgrid layer (core/ledger.py): per-site battery /
    # sell-back spec and the physical power→throughput curve Throttle
    # actions map through (both None = the pre-ledger behaviour)
    battery: Optional[BatteryConfig] = None
    throttle_curve: Optional[ThrottleCurve] = None
    # per-policy default config overrides, applied when the policy is
    # resolved BY NAME for this scenario (an explicit Policy instance or
    # per-call policy_configs entry wins) — lets a scenario exercise a
    # policy knob (price-spread's price-primary objective) without
    # moving that policy's digits on every other scenario
    policy_configs: Mapping[str, Mapping] = field(default_factory=dict)

    def sim_config(self, **overrides):
        """Materialize a ``SimConfig`` for this scenario (overrides win).

        The legacy scalar WAN overrides (``wan_gbps``, ``wan_degrade_prob``,
        ``wan_degraded_gbps``) are folded back into the scenario's
        :class:`WanProfile` so the materialized topology honours them;
        pass ``wan=WanProfile(...)`` to replace the profile wholesale.
        """
        from repro_torch.core.simulator import SimConfig

        kw = dict(
            n_sites=self.n_sites,
            slots_per_site=self.slots_per_site,
            days=self.days,
            dt_s=self.dt_s,
            engine=self.engine,
            seed=self.seed,
            trace=self.trace,
            wan=self.wan,
            wan_gbps=self.wan.gbps,
            wan_degrade_prob=self.wan.hourly_degrade_prob,
            wan_degraded_gbps=self.wan.degraded_gbps,
            n_jobs=self.jobs.n_jobs,
            frac_a=self.jobs.frac_a,
            frac_b=self.jobs.frac_b,
            size_a_gb=self.jobs.size_a_gb,
            size_b_gb=self.jobs.size_b_gb,
            size_c_gb=self.jobs.size_c_gb,
            mean_compute_h=self.jobs.mean_compute_h,
            failure_rate_per_slot_hour=self.failures.rate_per_slot_hour,
            checkpoint_interval_s=self.failures.checkpoint_interval_s,
            faults=self.faults,
            forecast_sigma_s=self.forecast.sigma_s,
            forecast_horizon_s=self.forecast.horizon_s,
            signals=self.signals,
            serving=self.serving,
            serving_router=self.serving_router,
            battery=self.battery,
            throttle_curve=self.throttle_curve,
        )
        kw.update(overrides)
        if "wan" not in overrides:
            if "wan_gbps" in overrides and self.wan.nic_gbps is not None:
                raise ValueError(
                    f"scenario {self.name!r} sets per-site nic_gbps, which "
                    "shadows the uniform wan_gbps override — override "
                    "wan=dataclasses.replace(scenario.wan, nic_gbps=...) "
                    "instead")
            kw["wan"] = dataclasses.replace(
                kw["wan"],
                gbps=kw["wan_gbps"],
                hourly_degrade_prob=kw["wan_degrade_prob"],
                degraded_gbps=kw["wan_degraded_gbps"],
            )
        return SimConfig(**kw)

    def build_traces(self, seed: Optional[int] = None) -> List[SiteTrace]:
        return generate_trace(self.n_sites, self.days,
                              seed=self.seed if seed is None else seed,
                              profile=self.trace)

    def build_wan(self, seed: Optional[int] = None) -> WanTopology:
        """Materialize the scenario's WAN topology — the one object the
        simulator, ``dryrun --plan`` and ``serve --green-route`` share."""
        return self.wan.build_topology(
            self.n_sites, self.days, self.seed if seed is None else seed)

    def build_signals(self, seed: Optional[int] = None):
        """Materialize the scenario's grid signals (carbon/price traces +
        demand-response curtail requests) — identical to what the
        simulator bills against for this scenario/seed."""
        from repro_torch.core.signals import generate_signals

        return generate_signals(self.n_sites, self.days,
                                seed=self.seed if seed is None else seed,
                                profile=self.signals)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (also usable as a decorator on a
    zero-arg factory function returning a Scenario)."""
    if callable(scenario) and not isinstance(scenario, Scenario):
        scn = scenario()
        register_scenario(scn)
        return scenario
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: Union[str, Scenario]) -> Scenario:
    if isinstance(name, Scenario):
        return name
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; available: {', '.join(available_scenarios())}"
        )
    return _REGISTRY[name]


def available_scenarios() -> List[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------

register_scenario(Scenario(
    name="paper-table6",
    description="Paper §VII headline setup: 5 sites x 4 slots, 10 Gbps WAN, "
                "240 jobs / 7 days, A:70% 1-6 GB, B:20% 10-40 GB, "
                "C:10% 100-300 GB, CAISO-calibrated windows.",
))

register_scenario(Scenario(
    name="flaky-wan",
    description="Shared-backbone brownouts: every hour the fabric degrades "
                "to 0.5 Gbps with p=0.25. Transfer-time feasibility is the "
                "whole game; energy-only strands class-B checkpoints.",
    wan=WanProfile(gbps=10.0, hourly_degrade_prob=0.25, degraded_gbps=0.5),
))

register_scenario(Scenario(
    name="solar-heavy",
    description="Long midday curtailment (mean 6.5 h), almost no night "
                "wind: windows are wide but synchronized, so migration "
                "targets saturate.",
    trace=TraceProfile(mean_window_h=6.5, p_wind=0.1, phase_spread_h=4.0),
))

register_scenario(Scenario(
    name="large-ckpt-classC",
    description="Checkpoint-heavy mix: 50% class C (100-300 GB). The §VI.D "
                "class gate dominates; most of the fleet must stay put.",
    jobs=JobMix(frac_a=0.20, frac_b=0.30),
))

register_scenario(Scenario(
    name="failure-storm",
    description="Beyond-paper fault sweep: 0.2 node failures per slot-hour "
                "with 15-min checkpoints — rollback churn stresses the "
                "pause/restart accounting.  (Migrated from the legacy "
                "FailureRegime alias onto core/faults.FaultRegime.)",
    faults=FaultRegime(job_failure_rate_per_slot_hour=0.2,
                       checkpoint_interval_s=900.0),
))

register_scenario(Scenario(
    name="hub-spoke-wan",
    description="Hub-and-spoke fabric: site 0 is a 40 Gbps exchange hub; "
                "direct spoke-to-spoke links are capped at 1 Gbps, but "
                "multi-hop routing relays spoke-to-spoke transfers "
                "through the hub at the full 10 Gbps spoke NIC rate "
                "(contending with hub-adjacent traffic for the hub NICs).",
    wan=WanProfile(gbps=10.0,
                   nic_gbps=(40.0, 10.0, 10.0, 10.0, 10.0),
                   link_gbps=hub_spoke_links(5, hub=0, spoke_gbps=1.0),
                   multi_hop=True),
))

register_scenario(Scenario(
    name="asymmetric-uplink",
    description="Consumer-grade uplinks at renewable micro-sites: every "
                "site ingests at 10 Gbps but egresses at only 2.5 Gbps — "
                "the *source* NIC, not the destination, is the migration "
                "bottleneck, and concurrent evacuations of one dark site "
                "quarter each other.",
    wan=WanProfile(gbps=10.0,
                   nic_gbps=(2.5,) * 5,  # egress
                   nic_in_gbps=(10.0,) * 5),
))

register_scenario(Scenario(
    name="forecastable-brownouts",
    description="Per-link hourly brownouts (p=0.2 to 0.5 Gbps) whose "
                "calendar is published through state.forecast, over windows "
                "with wide geographic phase spread: a reactive policy "
                "starts transfers that stall mid-brownout and burns grid "
                "through dark gaps a planner would Pause or Defer across — "
                "the scenario where plan-ahead's lookahead pays.",
    trace=TraceProfile(mean_window_h=3.5, p_wind=0.35),
    wan=WanProfile(gbps=10.0, hourly_degrade_prob=0.2, degraded_gbps=0.5,
                   brownout_scope="per-link"),
))

register_scenario(Scenario(
    name="carbon-peaks",
    description="Hard duck curve: evening carbon peaks near 700 gCO2/kWh "
                "over a deep midday solar trough, with windows spread "
                "wide in phase.  Grid kWh are NOT interchangeable here — "
                "a kWh at 19:00 emits 3x one at 13:00 — so signal-aware "
                "planning (park across the peak, throttle through it, "
                "migrate toward the cleanest feasible site) beats "
                "plan-ahead's grid-second minimization on gCO2: the "
                "receding-horizon policy's home turf.",
    trace=TraceProfile(mean_window_h=3.0, p_wind=0.3, phase_spread_h=8.0),
    signals=SignalProfile(carbon_evening=400.0, carbon_morning=150.0,
                          carbon_midday_dip=200.0, carbon_noise=12.0,
                          carbon_site_spread=0.15),
))

register_scenario(Scenario(
    name="price-spread",
    description="Wide per-site wholesale price spread (interconnection "
                "seams: some micro-sites buy at a third of others' rate) "
                "with only mild carbon variation — the scenario where the "
                "grid_cost accounting separates policies the kWh and gCO2 "
                "columns cannot.",
    signals=SignalProfile(price_site_spread=0.6, price_coupling=0.3,
                          carbon_evening=120.0, carbon_midday_dip=60.0,
                          carbon_site_spread=0.05),
    # the price-primary objective is the point of this scenario: bias
    # receding-horizon toward $ (2000 g per $ ~ the scenario's own
    # carbon/price exchange rate) whenever it is resolved by name here
    policy_configs={"receding-horizon": {"price_weight_g_per_usd": 2000.0}},
))

register_scenario(Scenario(
    name="demand-response",
    description="Grid-operator demand response: curtail-request events "
                "published through state.forecast whenever a site's "
                "carbon tops 500 gCO2/kWh (every evening ramp), asking "
                "compute to cap at 40% power.  Requests are advisory — "
                "only signal-aware policies (receding-horizon) honour "
                "them, shifting energy out of exactly the hours the "
                "carbon accounting prices highest.",
    trace=TraceProfile(mean_window_h=3.0, p_wind=0.3, phase_spread_h=8.0),
    signals=SignalProfile(carbon_evening=350.0, carbon_midday_dip=180.0,
                          carbon_noise=12.0, curtail_threshold=500.0,
                          curtail_frac=0.4),
))

register_scenario(Scenario(
    name="battery-bridging",
    description="Prosumer storage over the duck curve: each site carries a "
                "20 kWh / 5 kW battery that charges from curtailed midday "
                "surplus and discharges through the evening carbon peak "
                "(mean dark intensity >= 250 gCO2/kWh), bridging compute "
                "across the dirtiest hours; residual green time exports at "
                "2 kW.  Throttle actions map through the measured DVFS "
                "power->throughput curve.  Identical trajectory to "
                "carbon-peaks-shaped runs without storage — the battery "
                "is pure accounting relief, so the gCO2 delta is the "
                "storage value itself.",
    trace=TraceProfile(mean_window_h=3.0, p_wind=0.3, phase_spread_h=8.0),
    signals=SignalProfile(carbon_evening=400.0, carbon_morning=150.0,
                          carbon_midday_dip=200.0, carbon_noise=12.0,
                          carbon_site_spread=0.15),
    battery=BatteryConfig(capacity_kwh=20.0, max_charge_kw=5.0,
                          max_discharge_kw=5.0, round_trip_efficiency=0.90,
                          discharge_threshold_g=250.0, sellback_kw=2.0),
    throttle_curve=ThrottleCurve(),
))

register_scenario(Scenario(
    name="sellback-spread",
    description="Prosumer economics on the price seams: wide per-site "
                "wholesale spread (as in price-spread) with a small 10 kWh "
                "battery and a 5 kW export line gated at 0.12 $/kWh — "
                "sites sell curtailed green energy only where their own "
                "price clears the floor, so sell-back revenue separates "
                "sites the carbon columns cannot.",
    signals=SignalProfile(price_site_spread=0.6, price_coupling=0.3,
                          carbon_evening=120.0, carbon_midday_dip=60.0,
                          carbon_site_spread=0.05),
    battery=BatteryConfig(capacity_kwh=10.0, max_charge_kw=3.0,
                          max_discharge_kw=3.0, round_trip_efficiency=0.90,
                          discharge_threshold_g=0.0, sellback_kw=5.0,
                          sellback_price_floor=0.12),
    policy_configs={"receding-horizon": {"price_weight_g_per_usd": 2000.0}},
))

register_scenario(Scenario(
    name="inference-diurnal",
    description="Serving-dominated fabric: a light training load (60 jobs) "
                "under an evening-peaked inference request stream (diurnal "
                "Poisson, 0.01 req/s/site at base) routed green-first — "
                "requests chase renewable windows while the peak lands "
                "exactly on the duck-curve carbon ramp.",
    trace=TraceProfile(mean_window_h=3.0, p_wind=0.3, phase_spread_h=8.0),
    jobs=JobMix(n_jobs=60),
    signals=SignalProfile(carbon_evening=350.0, carbon_morning=150.0,
                          carbon_midday_dip=180.0, carbon_noise=10.0,
                          carbon_site_spread=0.15),
    serving=ServingProfile(req_per_s_per_site=0.01),
    serving_router="green-first",
))

register_scenario(Scenario(
    name="train-plus-serve",
    description="The combined fabric: the paper-table6 training load plus "
                "an evening-peaked inference stream (0.004 req/s/site) "
                "routed carbon-slo — training migrations and routed "
                "request batches compete for the same WAN links and green "
                "windows, and the router sheds load away from forecast "
                "carbon peaks under the per-class latency SLOs.",
    trace=TraceProfile(mean_window_h=3.0, p_wind=0.3, phase_spread_h=8.0),
    signals=SignalProfile(carbon_evening=350.0, carbon_morning=150.0,
                          carbon_midday_dip=180.0, carbon_noise=10.0,
                          carbon_site_spread=0.25),
    serving=ServingProfile(req_per_s_per_site=0.004),
    serving_router="carbon-slo",
))

register_scenario(Scenario(
    name="inference-heavy",
    description="The serving plane at the paper's 'millions of users' "
                "scale: no training jobs, five replica pools taking "
                "~1.1M requests over the week (0.3 req/s/site base, "
                "evening-peaked) routed latency-greedy.  The acceptance "
                "scenario for the chunked serving fast path — the "
                "per-event engine ticks once per arrival/close/service "
                "here, the span engine chews through the same stream in "
                "array chunks with bit-identical digits.",
    jobs=JobMix(n_jobs=0),
    trace=TraceProfile(mean_window_h=3.0, p_wind=0.3, phase_spread_h=8.0),
    serving=ServingProfile(req_per_s_per_site=0.30),
    serving_router="nearest",
))

register_scenario(Scenario(
    name="chaos-monkey",
    description="All five fault classes at once, mildly: occasional site "
                "blackouts (rollback + requeue), hard link failures that "
                "kill transfers mid-flight (watchdog abort -> backoff -> "
                "re-routed retry), 10% checkpoint corruption on rollback, "
                "replica crashes and straggler throughput dips — rates "
                "tuned so every job still completes, exercising the whole "
                "recovery spine plus both chaos audits on one run.",
    faults=FaultRegime(site_blackout_rate_per_day=0.25,
                       site_blackout_mean_s=1800.0,
                       link_failure_rate_per_day=0.3,
                       link_failure_mean_s=900.0,
                       ckpt_corruption_prob=0.10,
                       replica_crash_rate_per_day=0.5,
                       replica_crash_mean_s=1200.0,
                       straggler_rate_per_day=0.5,
                       straggler_mean_s=3600.0,
                       straggler_factor=0.6),
))

register_scenario(Scenario(
    name="blackout-cascade",
    description="Rolling site blackouts (mean 6 h, ~1/day per site) plus "
                "long hard link failures (mean 14 h, ~3.5/day across the "
                "fabric): blacked-out sites keep advertising free slots and "
                "live windows, so a fault-blind policy herds migrations onto "
                "dark links — and without the watchdog those transfers stall "
                "silently for the life of the outage — while a fault-aware "
                "planner masks down destinations and routes around "
                "soon-to-fail links.  The acceptance scenario for the "
                "recovery subsystem.",
    trace=TraceProfile(mean_window_h=3.0, p_wind=0.3, phase_spread_h=8.0),
    signals=SignalProfile(carbon_evening=400.0, carbon_morning=150.0,
                          carbon_midday_dip=200.0, carbon_noise=12.0,
                          carbon_site_spread=0.15),
    faults=FaultRegime(site_blackout_rate_per_day=1.0,
                       site_blackout_mean_s=6 * 3600.0,
                       link_failure_rate_per_day=3.5,
                       link_failure_mean_s=14 * 3600.0,
                       ckpt_corruption_prob=0.05,
                       stall_timeout_s=2 * 3600.0,
                       retry=RetryPolicy(max_attempts=2,
                                         backoff_base_s=7200.0,
                                         backoff_mult=2.0)),
))

register_scenario(Scenario(
    name="partitioned-wan",
    description="Two island fabrics ({0,1,2} and {3,4}) joined by thin "
                "0.25 Gbps links: intra-partition moves run at the full "
                "10 Gbps NIC while cross-partition migration is class-A "
                "only (a 6 GB checkpoint already takes 192 s) — renewable "
                "windows on the far island are mostly unreachable.",
    wan=WanProfile(gbps=10.0,
                   link_gbps=partitioned_links(((0, 1, 2), (3, 4)),
                                               inter_gbps=0.25)),
))


__all__ = [
    "BatteryConfig", "FailureRegime", "FaultRegime", "ForecastNoise",
    "JobMix", "RetryPolicy", "Scenario", "ServingProfile", "SignalProfile",
    "ThrottleCurve", "TraceProfile", "WanProfile", "WanTopology",
    "available_scenarios", "get_scenario", "hub_spoke_links",
    "partitioned_links", "register_scenario",
]
