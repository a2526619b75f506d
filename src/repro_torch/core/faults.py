"""Deterministic fault injection + recovery machinery.

The paper's feasibility model admits a migration and assumes it runs to
completion, but §VII.E names stalled transfers, congestion and retries
as the operational failure mode of WAN-migrated training.  This module
makes faults a first-class, *pre-materialized* input to the simulator:

``FaultRegime``
    The scenario-composable spec — rates and mean durations for five
    fault classes (site blackouts, hard WAN link failures, checkpoint
    corruption on rollback, serving replica crashes, straggler
    degradation) plus the recovery knobs (transfer-stall watchdog
    timeout and a bounded-retry ``RetryPolicy``).  All fields default to
    *off*; an unset/inactive regime draws **zero** RNG numbers and adds
    zero float ops, so every faults-off digit stays byte-identical.

``FaultPlan``
    The regime *realized* against a concrete ``(n_sites, horizon_s,
    seed)``: every fault span is sampled up front from its own
    ``default_rng([seed, 173, k])`` stream (the repo-wide list-seed
    convention — enabling faults never perturbs job, trace, serving or
    forecast streams).  The plan is pure data — sorted non-overlapping
    ``(start, end)`` span arrays per site / link — and answers point
    queries (``site_up``, ``link_up_mat``, ``tput_factor``) and
    event-scheduling queries (``next_edge_after``).  Because the plan is
    materialized before the run, the forecast layer can treat it as
    exactly forecastable (the same precedent as WAN brownout calendars):
    ``repair_time_s`` and ``next_fault_start_after`` feed the
    fault-aware policies.

``RetryPolicy``
    Bounded attempts with exponential backoff for aborted migrations —
    the watchdog replaces today's silent infinite stall with
    abort → requeue at source → cooldown → (possibly re-routed) retry.

Nothing here touches the event loop; the simulator consults the plan at
fault-span edges it schedules like any other event source.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_TAG = 173  # fault-stream RNG tag (serving=151, forecast=97, signals=131)

_DAY_S = 86400.0


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for aborted/failed migrations.

    Attempt ``n`` (1-based) that fails parks the job at its source for
    ``backoff_base_s * backoff_mult**(n-1)`` seconds before it becomes
    schedulable/migratable again; after ``max_attempts`` aborted
    transfers the job stops being offered retries and simply requeues
    (it can still run locally — no job is ever lost to the retry
    ladder).
    """

    max_attempts: int = 3
    backoff_base_s: float = 600.0
    backoff_mult: float = 2.0

    def backoff_s(self, attempt: int) -> float:
        """Cooldown after the ``attempt``-th (1-based) failed try."""
        return self.backoff_base_s * self.backoff_mult ** max(
            0, attempt - 1)


@dataclass(frozen=True)
class FaultRegime:
    """Scenario-level fault spec (all classes default to *off*).

    Rates are Poisson arrivals per simulated day; durations are sampled
    exponentially around the given means.  ``checkpoint_interval_s``
    optionally overrides ``SimConfig.checkpoint_interval_s`` so a
    scenario can carry its whole fault story in one object.
    """

    # site blackouts: every slot down; running jobs roll back to their
    # last checkpoint and requeue; the site is unschedulable (and its
    # NICs dark — links touching it carry zero traffic) until repair
    site_blackout_rate_per_day: float = 0.0
    site_blackout_mean_s: float = 3600.0
    # hard WAN link failures: capacity -> 0 mid-transfer (distinct from
    # the *scheduled* brownout calendar the forecast already knows)
    link_failure_rate_per_day: float = 0.0
    link_failure_mean_s: float = 1800.0
    # checkpoint corruption: with this probability a rollback's target
    # checkpoint is unreadable and the job falls back one more interval
    ckpt_corruption_prob: float = 0.0
    # serving replica crashes: one replica down for the repair span;
    # queued requests re-drain, the in-flight batch re-routes
    replica_crash_rate_per_day: float = 0.0
    replica_crash_mean_s: float = 1800.0
    # stragglers: site throughput multiplied by ``straggler_factor``
    straggler_rate_per_day: float = 0.0
    straggler_mean_s: float = 7200.0
    straggler_factor: float = 0.5
    # legacy per-job Poisson rollback (the old
    # ``SimConfig.failure_rate_per_slot_hour`` — kept there as an alias)
    job_failure_rate_per_slot_hour: float = 0.0
    ckpt_corruption_extra_intervals: int = 1
    checkpoint_interval_s: Optional[float] = None
    # recovery machinery
    stall_timeout_s: float = 1800.0
    retry: RetryPolicy = field(default_factory=RetryPolicy)

    def any_active(self) -> bool:
        """True when any fault class can actually fire — the gate the
        simulator uses to keep the faults-off path draw- and op-free."""
        return (self.site_blackout_rate_per_day > 0.0
                or self.link_failure_rate_per_day > 0.0
                or self.ckpt_corruption_prob > 0.0
                or self.replica_crash_rate_per_day > 0.0
                or self.straggler_rate_per_day > 0.0
                or self.job_failure_rate_per_slot_hour > 0.0)


def _sample_spans(rng: np.random.Generator, rate_per_day: float,
                  mean_s: float, t_end: float) -> np.ndarray:
    """Poisson-process ``(k, 2)`` span array over ``[0, t_end]`` —
    exponential inter-arrival gaps at ``rate_per_day``, exponential
    durations around ``mean_s``, merged to sorted non-overlapping form
    (so ``searchsorted`` point queries below stay O(log k))."""
    if rate_per_day <= 0.0 or t_end <= 0.0:
        return np.empty((0, 2))
    scale = _DAY_S / rate_per_day
    starts: List[float] = []
    durs: List[float] = []
    t = float(rng.exponential(scale))
    while t < t_end:
        starts.append(t)
        durs.append(float(rng.exponential(mean_s)))
        t += float(rng.exponential(scale))
    if not starts:
        return np.empty((0, 2))
    spans = np.column_stack([starts, np.asarray(starts) + np.asarray(durs)])
    spans[:, 1] = np.minimum(spans[:, 1], t_end)
    merged: List[List[float]] = []
    for s0, e0 in spans:
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e0)
        else:
            merged.append([float(s0), float(e0)])
    return np.asarray(merged)


def _in_span(spans: np.ndarray, t: float) -> bool:
    """Point-in-span for a sorted non-overlapping ``(k, 2)`` array
    (half-open ``[start, end)`` — at the repair instant the fault is
    over, matching the simulator's edge processing order)."""
    if len(spans) == 0:
        return False
    i = int(np.searchsorted(spans[:, 0], t, side="right")) - 1
    return i >= 0 and t < spans[i, 1]


def _next_start_after(spans: np.ndarray, t: float) -> float:
    """First span start strictly after ``t`` (``inf`` when none)."""
    if len(spans) == 0:
        return float("inf")
    i = int(np.searchsorted(spans[:, 0], t, side="right"))
    return float(spans[i, 0]) if i < len(spans) else float("inf")


def _span_end(spans: np.ndarray, t: float) -> float:
    """End of the span covering ``t`` (``t`` itself when uncovered) —
    the repair-time estimate the forecast layer exposes."""
    if len(spans) == 0:
        return t
    i = int(np.searchsorted(spans[:, 0], t, side="right")) - 1
    if i >= 0 and t < spans[i, 1]:
        return float(spans[i, 1])
    return t


@dataclass(frozen=True)
class FaultPlan:
    """A :class:`FaultRegime` realized against one cluster + seed.

    All arrays are sorted, non-overlapping ``(k, 2)`` ``(start, end)``
    spans.  ``link_spans`` holds *hard link failures* keyed by the
    unordered ``(min, max)`` site pair (failures take out both
    directions); site-blackout NIC darkness is composed on top by
    :meth:`link_up_mat` / :meth:`next_fault_start_after`, so callers see
    one effective up/down truth.
    """

    regime: FaultRegime
    n_sites: int
    horizon_s: float
    seed: int
    site_spans: Tuple[np.ndarray, ...]
    link_spans: Dict[Tuple[int, int], np.ndarray]
    replica_spans: Tuple[np.ndarray, ...]
    straggler_spans: Tuple[np.ndarray, ...]
    edges: np.ndarray  # unique sorted span boundaries (event sources)

    # ---- construction ------------------------------------------------------
    @classmethod
    def build(cls, regime: FaultRegime, n_sites: int, horizon_s: float,
              seed: int) -> "FaultPlan":
        """Materialize every fault span over ``[0, 2*horizon_s]`` (the
        engine's hard stop) from per-class ``default_rng([seed, 173,
        k])`` streams — adding a fault class never reshuffles another's
        spans, and no draw ever touches a non-fault stream."""
        t_end = 2.0 * horizon_s
        site_spans = []
        if regime.site_blackout_rate_per_day > 0.0:
            for s in range(n_sites):
                rng = np.random.default_rng([seed, _TAG, 1, s])
                site_spans.append(_sample_spans(
                    rng, regime.site_blackout_rate_per_day,
                    regime.site_blackout_mean_s, t_end))
        else:
            site_spans = [np.empty((0, 2))] * n_sites
        link_spans: Dict[Tuple[int, int], np.ndarray] = {}
        if regime.link_failure_rate_per_day > 0.0:
            for a in range(n_sites):
                for b in range(a + 1, n_sites):
                    rng = np.random.default_rng([seed, _TAG, 2, a, b])
                    sp = _sample_spans(rng, regime.link_failure_rate_per_day,
                                       regime.link_failure_mean_s, t_end)
                    if len(sp):
                        link_spans[(a, b)] = sp
        replica_spans = []
        if regime.replica_crash_rate_per_day > 0.0:
            for s in range(n_sites):
                rng = np.random.default_rng([seed, _TAG, 3, s])
                replica_spans.append(_sample_spans(
                    rng, regime.replica_crash_rate_per_day,
                    regime.replica_crash_mean_s, t_end))
        else:
            replica_spans = [np.empty((0, 2))] * n_sites
        straggler_spans = []
        if regime.straggler_rate_per_day > 0.0:
            for s in range(n_sites):
                rng = np.random.default_rng([seed, _TAG, 4, s])
                straggler_spans.append(_sample_spans(
                    rng, regime.straggler_rate_per_day,
                    regime.straggler_mean_s, t_end))
        else:
            straggler_spans = [np.empty((0, 2))] * n_sites
        parts = ([sp for sp in site_spans] + list(link_spans.values())
                 + [sp for sp in replica_spans]
                 + [sp for sp in straggler_spans])
        flat = ([p.ravel() for p in parts if len(p)] or [np.empty(0)])
        edges = np.unique(np.concatenate(flat))
        return cls(regime=regime, n_sites=n_sites, horizon_s=horizon_s,
                   seed=seed, site_spans=tuple(site_spans),
                   link_spans=link_spans,
                   replica_spans=tuple(replica_spans),
                   straggler_spans=tuple(straggler_spans), edges=edges)

    def corruption_rng(self) -> np.random.Generator:
        """The checkpoint-corruption Bernoulli stream (one draw per
        rollback, consumed by the simulator — its own tag, so enabling
        corruption perturbs nothing else)."""
        return np.random.default_rng([self.seed, _TAG, 5])

    # ---- point queries -----------------------------------------------------
    def site_up(self, s: int, t: float) -> bool:
        return not _in_span(self.site_spans[s], t)

    def site_up_vec(self, t: float) -> np.ndarray:
        return np.array([not _in_span(sp, t) for sp in self.site_spans],
                        dtype=bool)

    def link_failed(self, a: int, b: int, t: float) -> bool:
        """Hard link failure only (no blackout composition)."""
        sp = self.link_spans.get((min(a, b), max(a, b)))
        return sp is not None and _in_span(sp, t)

    def link_up_mat(self, t: float) -> np.ndarray:
        """Effective ``(n, n)`` link-up truth: a link is down while
        either endpoint is blacked out (NICs dark) *or* the link itself
        has hard-failed.  Diagonal stays True."""
        n = self.n_sites
        up = np.ones((n, n), dtype=bool)
        site_up = self.site_up_vec(t)
        if not site_up.all():
            up &= site_up[:, None] & site_up[None, :]
        for (a, b), sp in self.link_spans.items():
            if _in_span(sp, t):
                up[a, b] = up[b, a] = False
        np.fill_diagonal(up, True)
        return up

    def replica_down(self, s: int, t: float) -> bool:
        return _in_span(self.replica_spans[s], t)

    def replica_down_vec(self, t: float) -> np.ndarray:
        return np.array([_in_span(sp, t) for sp in self.replica_spans],
                        dtype=bool)

    def tput_factor(self, s: int, t: float) -> float:
        if _in_span(self.straggler_spans[s], t):
            return self.regime.straggler_factor
        return 1.0

    def tput_factor_vec(self, t: float) -> np.ndarray:
        f = np.ones(self.n_sites)
        for s, sp in enumerate(self.straggler_spans):
            if _in_span(sp, t):
                f[s] = self.regime.straggler_factor
        return f

    # ---- event scheduling --------------------------------------------------
    def next_edge_after(self, t: float) -> float:
        """First span boundary strictly after ``t`` (``inf`` when none)
        — the simulator's fault event source."""
        i = int(np.searchsorted(self.edges, t, side="right"))
        return float(self.edges[i]) if i < len(self.edges) else float("inf")

    # ---- forecast-layer queries (the plan is exactly forecastable, the
    # same precedent as the WAN brownout calendar) ---------------------------
    def repair_time_s(self, s: int, t: float) -> float:
        """When site ``s`` comes back up (``t`` itself if it is up)."""
        return _span_end(self.site_spans[s], t)

    def repair_time_vec(self, t: float) -> np.ndarray:
        return np.array([_span_end(sp, t) for sp in self.site_spans])

    def next_fault_start_after(self, a: int, b: int, t: float) -> float:
        """First instant strictly after ``t`` at which the ``a``→``b``
        path loses capacity to a fault: the next hard failure of the
        link *or* the next blackout of either endpoint."""
        out = _next_start_after(self.site_spans[a], t)
        out = min(out, _next_start_after(self.site_spans[b], t))
        sp = self.link_spans.get((min(a, b), max(a, b)))
        if sp is not None:
            out = min(out, _next_start_after(sp, t))
        return out

    def next_fault_start_grid(self, t: float) -> np.ndarray:
        """(n, n) matrix of :meth:`next_fault_start_after` (``inf``-
        filled diagonal and fault-free pairs)."""
        n = self.n_sites
        site_next = np.array([_next_start_after(sp, t)
                              for sp in self.site_spans])
        grid = np.minimum(site_next[:, None], site_next[None, :])
        for (a, b), sp in self.link_spans.items():
            nx = _next_start_after(sp, t)
            if nx < grid[a, b]:
                grid[a, b] = grid[b, a] = nx
        np.fill_diagonal(grid, float("inf"))
        return grid

    # ---- telemetry ---------------------------------------------------------
    def outage_stats(self, t_end: float) -> Tuple[int, float]:
        """``(site_outages, mttr_s)`` over blackout spans that *started*
        before ``t_end`` — the count and the mean time-to-repair the
        run actually experienced (repairs past ``t_end`` clip there)."""
        count = 0
        total = 0.0
        for sp in self.site_spans:
            for s0, e0 in sp:
                if s0 >= t_end:
                    break
                count += 1
                total += min(e0, t_end) - s0
        return count, (total / count if count else 0.0)


__all__ = ["FaultPlan", "FaultRegime", "RetryPolicy"]
