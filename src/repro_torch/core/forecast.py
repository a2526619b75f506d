"""Forecast-and-planning subsystem: the lookahead view of renewable
windows and WAN brownouts (paper §VI.H; cf. XWind's per-farm renewable
horizons and Wiesner et al.'s curtailment-window feasibility study).

The reactive snapshot fields (``SiteView.window_remaining_s``,
``next_window_start_s``, the advertised bandwidth matrix) describe *now*.
:class:`ForecastHorizon` is the *plan-ahead* product attached to every
:class:`~repro_torch.core.state.ClusterState` as ``state.forecast``:

  * per-site sequences of upcoming renewable windows over a lookahead
    ``horizon_s``, derived from :class:`~repro_torch.core.traces.SiteTrace`
    windows with the same Gaussian ``sigma_s`` noise model the
    :class:`~repro_torch.core.traces.Forecaster` applies to remaining-window
    queries (σ=0 reproduces the oracle view), and
  * per-link brownout *outage* forecasts derived from a
    :class:`~repro_torch.core.wan.WanTopology` calendar — brownout calendars are
    schedules (grid-operator curtailment notices, maintenance windows), so
    they are forecast exactly, with the degraded capacity attached, and
  * grid-signal forecasts — the run's :class:`~repro_torch.core.signals.
    GridSignals` carbon/price stacks plus demand-response *curtail-request*
    events.  Day-ahead carbon and price schedules are published by grid
    operators, so (like brownout calendars) they are forecast exactly;
    the planning queries (``grid_carbon_g``, ``carbon_grid``,
    ``curtail_frac_grid``) are what lets the ``receding-horizon`` policy
    score multi-window plans in grams instead of grid-seconds.

Window noise is **hash-deterministic**: each (seed, site) pair seeds its
own stream and jitters that site's windows in trace order, so every
consumer — the simulator's per-tick snapshot, ``dryrun --plan``,
``serve --green-route`` — sees the *same* noisy horizon for a given seed
regardless of when or how often it queries.  That is what lets a policy
compose multi-step plans (Pause now, Resume at the forecast window start)
without the plan shifting under it between ticks.

All queries take an explicit sim-time ``t`` and gate visibility at
``t + horizon_s``: the horizon is a sliding lookahead window, not a fixed
batch, so one ``ForecastHorizon`` (built once per run) serves every
snapshot.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FaultPlan
from repro_torch.core.signals import CurtailRequest, GridSignals

HOUR = 3600.0
DAY = 24 * HOUR

#: Default lookahead: one diurnal cycle (every site sees its next solar
#: window plus the night wind window that may precede it).
DEFAULT_HORIZON_S = DAY


@dataclass(frozen=True, slots=True)
class WindowForecast:
    """A forecast renewable-surplus window (edges carry the sigma noise)."""

    start_s: float
    end_s: float

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    def overlap_s(self, t0: float, t1: float) -> float:
        return max(0.0, min(t1, self.end_s) - max(t0, self.start_s))


@dataclass(frozen=True, slots=True)
class OutageForecast:
    """A forecast WAN brownout span.

    ``src == dst == -1`` marks a fabric-scope outage (every link degrades
    at once — the legacy flaky-WAN regime); otherwise the span applies to
    the single directed link ``(src, dst)``.  ``capacity_bps`` is the
    degraded capacity during the span — combine it with the current
    advertised bandwidth via ``min`` (the calendar degrades, never
    upgrades).
    """

    start_s: float
    end_s: float
    src: int = -1
    dst: int = -1
    capacity_bps: float = 0.0

    @property
    def fabric_wide(self) -> bool:
        return self.src < 0

    def affects(self, src: int, dst: int) -> bool:
        return self.fabric_wide or (self.src == src and self.dst == dst)


def _compress_hours(mask_1d: np.ndarray) -> List[Tuple[int, int]]:
    """Runs of consecutive True hours as [h_start, h_end) pairs."""
    runs: List[Tuple[int, int]] = []
    start = None
    for h, bad in enumerate(mask_1d):
        if bad and start is None:
            start = h
        elif not bad and start is not None:
            runs.append((start, h))
            start = None
    if start is not None:
        runs.append((start, len(mask_1d)))
    return runs


@dataclass(frozen=True)
class ForecastHorizon:
    """Sliding-lookahead forecast of renewable windows and WAN outages.

    Built once per run (:meth:`build`) and attached to every snapshot;
    queries take the current sim-time ``t`` and only reveal entries that
    begin before ``t + horizon_s``.
    """

    horizon_s: float
    sigma_s: float
    site_windows: Tuple[Tuple[WindowForecast, ...], ...]
    outages: Tuple[OutageForecast, ...]  # sorted by start_s
    # grid-signal forecasts (carbon/price stacks + curtail-request events);
    # None when the run carries no signals — every signal query then
    # degrades to the zero-signal answer (0 g/kWh, $0, no DR spans)
    signals: Optional[GridSignals] = None
    # realized fault plan (core/faults.py); pre-materialized spans are
    # exactly forecastable, same precedent as WAN brownout calendars.
    # None (every fault-free run) degrades every fault query to the
    # no-fault answer (inf next-start, 0 repair time) at zero cost.
    faults: Optional[FaultPlan] = None

    @property
    def n_sites(self) -> int:
        return len(self.site_windows)

    # -- renewable-window queries -------------------------------------------
    @cached_property
    def _window_starts(self) -> Tuple[List[float], ...]:
        return tuple([w.start_s for w in wins] for wins in self.site_windows)

    def windows(self, site: int, t: float) -> List[WindowForecast]:
        """Forecast windows still relevant at ``t``: end after ``t``, start
        inside the lookahead."""
        limit = t + self.horizon_s
        return [w for w in self.site_windows[site]
                if w.end_s > t and w.start_s < limit]

    def next_window(self, site: int, t: float) -> Optional[WindowForecast]:
        """The current-or-next forecast window at ``t`` (None when nothing
        begins inside the lookahead)."""
        wins = self.site_windows[site]
        i = bisect.bisect_right(self._window_starts[site], t)
        # wins[i-1] may still be open (covers t)
        if i > 0 and wins[i - 1].end_s > t:
            return wins[i - 1]
        if i < len(wins) and wins[i].start_s < t + self.horizon_s:
            return wins[i]
        return None

    def next_window_start_s(self, site: int, t: float) -> float:
        """Forecast start of the next window strictly after ``t`` (inf if
        none inside the lookahead) — the planning analogue of
        ``SiteView.next_window_start_s``."""
        wins = self.site_windows[site]
        i = bisect.bisect_right(self._window_starts[site], t)
        if i < len(wins) and wins[i].start_s < t + self.horizon_s:
            return wins[i].start_s
        return float("inf")

    def active(self, site: int, t: float) -> bool:
        w = self.next_window(site, t)
        return w is not None and w.start_s <= t

    def green_seconds(self, site: int, t0: float, t1: float) -> float:
        """Forecast renewable seconds overlapping [t0, t1] (t1 capped at
        the lookahead)."""
        t1 = min(t1, t0 + self.horizon_s)
        return sum(w.overlap_s(t0, t1) for w in self.site_windows[site]
                   if w.end_s > t0 and w.start_s < t1)

    # -- grid-signal queries -------------------------------------------------
    #
    # Signals are exact (day-ahead schedules, like brownout calendars);
    # the integrals extend past ``t + horizon_s`` by the stacks' constant
    # extrapolation, but renewable-window *credit* against them is gated
    # at the lookahead like every other window query — beyond the horizon
    # a plan must assume grid power.

    def carbon_value(self, site: int, t: float) -> float:
        """Forecast carbon intensity (gCO2/kWh) at ``t`` (0 w/o signals)."""
        sig = self.signals
        return sig.carbon.value(site, t) if sig is not None else 0.0

    def carbon_grid(self, t: float) -> np.ndarray:
        """(n_sites,) batched :meth:`carbon_value` (read-only view)."""
        sig = self.signals
        if sig is not None:
            return sig.carbon.value_grid(t)
        return np.zeros(self.n_sites)

    def price_value(self, site: int, t: float) -> float:
        """Forecast grid price ($/kWh) at ``t`` (0 w/o signals)."""
        sig = self.signals
        return sig.price.value(site, t) if sig is not None else 0.0

    def price_grid(self, t: float) -> np.ndarray:
        sig = self.signals
        if sig is not None:
            return sig.price.value_grid(t)
        return np.zeros(self.n_sites)

    def carbon_integral(self, site: int, t0: float, t1: float) -> float:
        """``∫ carbon dt`` over the whole span (grams·s/kWh·s — multiply
        by kW/3600 for grams); the transfer-leg cost term (transfer power
        is billed entirely to grid)."""
        sig = self.signals
        return sig.carbon.integral(site, t0, t1) if sig is not None else 0.0

    def price_integral(self, site: int, t0: float, t1: float) -> float:
        """``∫ price dt`` over the whole span — the transfer-leg $ term
        (no renewable credit: transfer power is billed entirely to grid)."""
        sig = self.signals
        return sig.price.integral(site, t0, t1) if sig is not None else 0.0

    def _grid_signal_integral(self, stack, site: int, t0: float,
                              t1: float) -> float:
        """``∫ signal dt`` over the forecast NON-renewable portion of
        ``[t0, t1]``: the total integral minus the overlap with forecast
        windows, window credit gated at ``t0 + horizon_s``."""
        if t1 <= t0:
            return 0.0
        tot = stack.integral(site, t0, t1)
        limit = min(t1, t0 + self.horizon_s)
        for w in self.site_windows[site]:
            if w.end_s > t0 and w.start_s < limit:
                tot -= stack.integral(site, max(t0, w.start_s),
                                      min(limit, w.end_s))
        return tot

    def grid_carbon_g(self, site: int, t0: float, t1: float,
                      p_kw: float) -> float:
        """Forecast gCO2 of drawing ``p_kw`` at ``site`` over ``[t0, t1]``
        with renewable windows covering their overlap for free — the
        planning analogue of the simulator's per-span accounting.  With no
        signals, degrades to ``p_kw``-weighted *grid seconds* (constant
        carbon 1), so signal-free plans still minimize grid time."""
        sig = self.signals
        if sig is None:
            green = self.green_seconds(site, t0, t1)
            return p_kw / HOUR * max(0.0, (t1 - t0) - green)
        return p_kw / HOUR * self._grid_signal_integral(
            sig.carbon, site, t0, t1)

    def grid_price_usd(self, site: int, t0: float, t1: float,
                       p_kw: float) -> float:
        """Forecast $ cost of drawing ``p_kw`` at ``site`` over
        ``[t0, t1]`` net of renewable-window overlap (0 w/o signals)."""
        sig = self.signals
        if sig is None:
            return 0.0
        return p_kw / HOUR * self._grid_signal_integral(
            sig.price, site, t0, t1)

    def battery_cover_g(self, site: int, t0: float, t1: float, p_kw: float,
                        soc_kwh: float, batt) -> float:
        """Forecast gCO2 a battery with ``soc_kwh`` of charge could shave
        off :meth:`grid_carbon_g` for the same span: the grid carbon
        scaled by the fraction of the span's dark energy the battery can
        deliver (bounded by its discharge-rate budget and state of
        charge).  ``batt`` is a :class:`~repro_torch.core.ledger.BatteryConfig`
        (untyped to keep forecast ledger-free); 0 without one.

        A planning *estimate*, deliberately simpler than the ledger's
        posting-time discharge gates — it assumes charge available now
        stays available for this span, which receding-horizon's
        branch-relative comparisons tolerate."""
        if batt is None or soc_kwh <= 0.0:
            return 0.0
        g = self.grid_carbon_g(site, t0, t1, p_kw)
        if g <= 0.0:
            return 0.0
        green = self.green_seconds(site, t0, t1)
        dark = max(0.0, (t1 - t0) - green)
        need = p_kw * dark / HOUR
        if need <= 0.0:
            return 0.0
        avail = min(soc_kwh, batt.max_discharge_kw * dark / HOUR)
        return g * min(1.0, avail / need)

    # -- batched planning-cost rows ------------------------------------------
    #
    # Elementwise mirrors of the scalar cost queries over broadcastable
    # ``(site, t0, t1)`` arrays — the receding-horizon planner's
    # whole-grid branch-cost tensors.  Every mirror repeats the scalar's
    # float operations in the scalar's order (window credits subtract
    # sequentially in window order; masked lanes evaluate on dummy
    # arguments and are then where-masked), so each lane is bit-identical
    # to the corresponding scalar call — the property the
    # action-for-action parity oracle (``decide_scalar``) checks.

    def carbon_integral_rows(self, sites, t0s, t1s) -> np.ndarray:
        """Elementwise :meth:`carbon_integral` (whole-span, no window
        credit — the transfer-leg term)."""
        sig = self.signals
        if sig is None:
            return np.zeros(np.broadcast(
                np.asarray(sites), np.asarray(t0s), np.asarray(t1s)).shape)
        return sig.carbon.integral_rows(sites, t0s, t1s)

    def price_integral_rows(self, sites, t0s, t1s) -> np.ndarray:
        """Elementwise :meth:`price_integral`."""
        sig = self.signals
        if sig is None:
            return np.zeros(np.broadcast(
                np.asarray(sites), np.asarray(t0s), np.asarray(t1s)).shape)
        return sig.price.integral_rows(sites, t0s, t1s)

    def _signal_integral_rows(self, stack, sites, t0s, t1s) -> np.ndarray:
        """Elementwise :meth:`_grid_signal_integral`.  Window credit
        subtracts per window column *sequentially* (``tot - credit_j`` in
        window order) because float subtraction is not associative and
        the scalar subtracts one window at a time; non-qualifying lanes
        subtract exactly ``0.0`` (a bit-exact identity)."""
        sites = np.asarray(sites)
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        sites, t0s, t1s = np.broadcast_arrays(sites, t0s, t1s)
        tot = stack.integral_rows(sites, t0s, t1s)
        limit = np.minimum(t1s, t0s + self.horizon_s)
        starts, ends = self._window_mats
        wsr = starts[sites]
        wer = ends[sites]
        qual = (wer > t0s[..., None]) & (wsr < limit[..., None])
        for j in range(wsr.shape[-1]):
            qj = qual[..., j]
            if not qj.any():
                continue
            a = np.where(qj, np.maximum(t0s, wsr[..., j]), t0s)
            b = np.where(qj, np.minimum(limit, wer[..., j]), t0s)
            tot = tot - np.where(qj, stack.integral_rows(sites, a, b), 0.0)
        return np.where(t1s <= t0s, 0.0, tot)

    def _green_seconds_rows(self, sites, t0s, t1s) -> np.ndarray:
        """Elementwise :meth:`green_seconds` (overlaps accumulate in
        window order, like the scalar's ``sum``)."""
        sites = np.asarray(sites)
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        sites, t0s, t1s = np.broadcast_arrays(sites, t0s, t1s)
        t1c = np.minimum(t1s, t0s + self.horizon_s)
        starts, ends = self._window_mats
        wsr = starts[sites]
        wer = ends[sites]
        qual = (wer > t0s[..., None]) & (wsr < t1c[..., None])
        tot = np.zeros(t0s.shape)
        for j in range(wsr.shape[-1]):
            qj = qual[..., j]
            if not qj.any():
                continue
            ov = np.maximum(0.0, np.minimum(t1c, wer[..., j])
                            - np.maximum(t0s, wsr[..., j]))
            tot = tot + np.where(qj, ov, 0.0)
        return tot

    def grid_carbon_g_rows(self, sites, t0s, t1s, p_kw: float) -> np.ndarray:
        """Elementwise :meth:`grid_carbon_g`."""
        sig = self.signals
        if sig is None:
            sites = np.asarray(sites)
            t0s = np.asarray(t0s, dtype=np.float64)
            t1s = np.asarray(t1s, dtype=np.float64)
            sites, t0s, t1s = np.broadcast_arrays(sites, t0s, t1s)
            green = self._green_seconds_rows(sites, t0s, t1s)
            return p_kw / HOUR * np.maximum(0.0, (t1s - t0s) - green)
        return p_kw / HOUR * self._signal_integral_rows(
            sig.carbon, sites, t0s, t1s)

    def grid_price_usd_rows(self, sites, t0s, t1s, p_kw: float) -> np.ndarray:
        """Elementwise :meth:`grid_price_usd`."""
        sig = self.signals
        if sig is None:
            return np.zeros(np.broadcast(
                np.asarray(sites), np.asarray(t0s), np.asarray(t1s)).shape)
        return p_kw / HOUR * self._signal_integral_rows(
            sig.price, sites, t0s, t1s)

    def battery_cover_g_rows(self, sites, t0s, t1s, p_kw: float,
                             soc_kwh, batt) -> np.ndarray:
        """Elementwise :meth:`battery_cover_g` (``soc_kwh`` broadcasts
        with the span arrays; lanes repeat the scalar's float ops)."""
        sites = np.asarray(sites)
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        soc = np.asarray(soc_kwh, dtype=np.float64)
        sites, t0s, t1s, soc = np.broadcast_arrays(sites, t0s, t1s, soc)
        if batt is None:
            return np.zeros(sites.shape)
        g = self.grid_carbon_g_rows(sites, t0s, t1s, p_kw)
        green = self._green_seconds_rows(sites, t0s, t1s)
        dark = np.maximum(0.0, (t1s - t0s) - green)
        need = p_kw * dark / HOUR
        avail = np.minimum(soc, batt.max_discharge_kw * dark / HOUR)
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(need > 0.0, avail / need, 0.0)
        out = g * np.minimum(1.0, frac)
        return np.where((soc > 0.0) & (g > 0.0) & (need > 0.0), out, 0.0)

    # -- demand-response curtail requests ------------------------------------
    @cached_property
    def _site_curtails(self) -> Tuple[Tuple[CurtailRequest, ...], ...]:
        by: List[List[CurtailRequest]] = [[] for _ in range(self.n_sites)]
        if self.signals is not None:
            for c in self.signals.curtailments:
                if 0 <= c.site < self.n_sites:
                    by[c.site].append(c)
        return tuple(tuple(sorted(v, key=lambda c: c.start_s)) for v in by)

    def active_curtail(self, site: int, t: float) -> Optional[CurtailRequest]:
        """The demand-response request covering ``t`` at ``site`` (None
        when the operator is not asking for load shed right now)."""
        for c in self._site_curtails[site]:
            if c.start_s <= t < c.end_s:
                return c
            if c.start_s > t:
                break
        return None

    def curtail_frac_grid(self, t: float) -> np.ndarray:
        """(n_sites,) requested power cap at ``t`` (1.0 where no active
        curtail request) — the batched :meth:`active_curtail`.  Cached per
        curtail-edge epoch; treat as read-only."""
        def compute():
            out = np.ones(self.n_sites)
            for s, cs in enumerate(self._site_curtails):
                for c in cs:
                    if c.start_s <= t < c.end_s:
                        out[s] = c.power_frac
                        break
                    if c.start_s > t:
                        break
            return out

        key = ("cf", bisect.bisect_right(self._curtail_edges, t))
        return self._cached_grid(key, compute)

    @cached_property
    def _curtail_edges(self) -> List[float]:
        return sorted({e for cs in self._site_curtails for c in cs
                       for e in (c.start_s, c.end_s)})

    def next_curtail_start_s(self, site: int, t: float) -> float:
        """First curtail-request start strictly after ``t`` at ``site``
        (inf when none inside the lookahead)."""
        limit = t + self.horizon_s
        for c in self._site_curtails[site]:
            if c.start_s > t:
                return c.start_s if c.start_s < limit else float("inf")
        return float("inf")

    # -- WAN outage queries --------------------------------------------------
    @cached_property
    def _link_outages(self) -> Dict[Tuple[int, int], Tuple[OutageForecast, ...]]:
        by: Dict[Tuple[int, int], List[OutageForecast]] = {}
        for o in self.outages:
            by.setdefault((o.src, o.dst), []).append(o)
        return {k: tuple(v) for k, v in by.items()}

    @cached_property
    def _merged_outage_cache(self) -> Dict[Tuple[int, int], Tuple[OutageForecast, ...]]:
        return {}

    def _outages_for(self, src: int, dst: int) -> Tuple[OutageForecast, ...]:
        """Fabric + per-link outages affecting (src, dst), start-sorted.
        Merged once per link and cached — plan-ahead queries every
        (candidate, destination) pair every tick."""
        key = (src, dst)
        got = self._merged_outage_cache.get(key)
        if got is None:
            got = tuple(sorted(
                (*self._link_outages.get((-1, -1), ()),
                 *self._link_outages.get(key, ())),
                key=lambda o: o.start_s))
            self._merged_outage_cache[key] = got
        return got

    def next_outage(self, src: int, dst: int, t: float) -> Optional[OutageForecast]:
        """The first forecast outage affecting link (src, dst) that is
        still open at / begins after ``t``, inside the lookahead."""
        limit = t + self.horizon_s
        for o in self._outages_for(src, dst):
            if o.end_s > t and o.start_s < limit:
                return o
        return None

    def next_outage_start_s(self, src: int, dst: int, t: float) -> float:
        o = self.next_outage(src, dst, t)
        return o.start_s if o is not None else float("inf")

    def next_outage_start_after(self, src: int, dst: int, t: float) -> float:
        """First forecast outage START strictly after ``t`` on (src, dst)
        (inf if none inside the lookahead).  Unlike :meth:`next_outage`,
        an outage already in progress does not mask a later one — this is
        the query arrival checks need: "does anything begin while my
        transfer is still in flight?"."""
        limit = t + self.horizon_s
        for o in self._outages_for(src, dst):
            if o.start_s > t:
                return o.start_s if o.start_s < limit else float("inf")
        return float("inf")

    def next_uplink_outage_start_s(self, src: int, t: float) -> float:
        """Earliest forecast outage start affecting ANY link out of
        ``src`` (inf if none inside the lookahead) — the evacuation
        trigger: after this instant the site's checkpoints may no longer
        drain at full rate."""
        limit = t + self.horizon_s
        best = float("inf")
        for (s, _d), outs in self._link_outages.items():
            if s != -1 and s != src:
                continue
            for o in outs:
                if o.end_s > t and o.start_s < limit:
                    best = min(best, max(o.start_s, t))
                    break
        return best

    # -- batched grids (one numpy pass instead of n^2 scalar queries) --------
    @cached_property
    def _window_mats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Padded (n_sites, Kw) window start/end matrices (+inf padded; Kw
        = max window count + 1 so searchsorted indices always gather)."""
        k = max((len(w) for w in self.site_windows), default=0) + 1
        n = self.n_sites
        starts = np.full((n, k), np.inf)
        ends = np.full((n, k), np.inf)
        for i, wins in enumerate(self.site_windows):
            for j, w in enumerate(wins):
                starts[i, j] = w.start_s
                ends[i, j] = w.end_s
        return starts, ends

    @cached_property
    def _outage_mats(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded (n, n, Ko) per-link merged-outage start/end/capacity
        matrices (fabric spans folded into every link, start-sorted — the
        array form of :meth:`_outages_for`).  Pads: start=+inf, end=-inf,
        cap=+inf."""
        n = self.n_sites
        k = 1
        per_link = {}
        for s in range(n):
            for d in range(n):
                outs = self._outages_for(s, d)
                per_link[(s, d)] = outs
                k = max(k, len(outs) + 1)
        starts = np.full((n, n, k), np.inf)
        ends = np.full((n, n, k), -np.inf)
        caps = np.full((n, n, k), np.inf)
        for (s, d), outs in per_link.items():
            for j, o in enumerate(outs):
                starts[s, d, j] = o.start_s
                ends[s, d, j] = o.end_s
                caps[s, d, j] = o.capacity_bps
        return starts, ends, caps

    # The grids below cache only quantities that are piecewise-constant in
    # ``t`` between breakpoints, and apply every comparison that involves
    # the live ``t`` (window-still-open checks, the ``t + horizon_s``
    # reveal limit) per call on the cached gathers — like
    # ``TraceStack.point``.  Caching comparison *results* would be wrong
    # at the breakpoints themselves: a predicate like
    # ``start < t + horizon`` is False exactly at ``t = start - horizon``
    # but True just after, so a value computed at the edge must not be
    # reused for the epoch's interior (orchestrator ticks land exactly on
    # hour-aligned edges all the time).
    @cached_property
    def _grid_cache(self) -> dict:
        return {}

    @staticmethod
    def _breaks(*arrays: np.ndarray) -> List[float]:
        vals = np.unique(np.concatenate([np.asarray(a).ravel()
                                         for a in arrays]))
        return [float(v) for v in vals if np.isfinite(v)]

    @cached_property
    def _outage_end_breaks(self) -> List[float]:
        _, ends, _ = self._outage_mats
        return self._breaks(ends)

    @cached_property
    def _outage_reveal_breaks(self) -> List[float]:
        starts, _, _ = self._outage_mats
        return self._breaks(starts - self.horizon_s)

    @cached_property
    def _outage_start_breaks(self) -> List[float]:
        starts, _, _ = self._outage_mats
        return self._breaks(starts)

    @cached_property
    def _window_start_breaks(self) -> List[float]:
        starts, _ = self._window_mats
        return self._breaks(starts)

    def _cached_grid(self, key: tuple, compute):
        got = self._grid_cache.get(key)
        if got is None:
            got = self._grid_cache[key] = compute()
        return got

    def next_outage_grid(self, t: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(start, end, capacity) ``(n, n)`` grids of the first forecast
        outage per link still open at / beginning after ``t`` inside the
        lookahead — the batched :meth:`next_outage` (start=+inf, cap=+inf
        where there is none).  Treat the returned arrays as read-only
        (cached per breakpoint epoch).

        The qualifying mask mixes two edge semantics: expiry flips
        (``end > t``) become False *at* the edge (``bisect_right``
        epochs), reveal flips (``start < t + horizon``) become True just
        *after* theirs (``bisect_left`` epochs) — the cache key combines
        both, so every ``t`` sharing a key evaluates to the same mask."""
        def compute():
            starts, ends, caps = self._outage_mats
            qual = (ends > t) & (starts < t + self.horizon_s)
            first = qual.argmax(axis=2)[:, :, None]
            any_ = np.take_along_axis(qual, first, axis=2)[:, :, 0]
            o_start = np.where(
                any_, np.take_along_axis(starts, first, axis=2)[:, :, 0],
                np.inf)
            o_end = np.where(
                any_, np.take_along_axis(ends, first, axis=2)[:, :, 0],
                np.inf)
            o_cap = np.where(
                any_, np.take_along_axis(caps, first, axis=2)[:, :, 0],
                np.inf)
            return o_start, o_end, o_cap

        key = ("no", bisect.bisect_right(self._outage_end_breaks, t),
               bisect.bisect_left(self._outage_reveal_breaks, t))
        return self._cached_grid(key, compute)

    def next_outage_start_after_grid(self, t: float) -> np.ndarray:
        """(n, n) grid of the first outage START strictly after ``t`` per
        link (inf when none inside the lookahead) — the batched
        :meth:`next_outage_start_after`.  Read-only; the reveal limit is
        applied with the live ``t``."""
        def compute():
            starts, _, _ = self._outage_mats
            after = np.where(starts > t, starts, np.inf)
            return after.min(axis=2)

        # ``starts > t`` flips False at the start itself: bisect_right
        first = self._cached_grid(
            ("na", bisect.bisect_right(self._outage_start_breaks, t)),
            compute)
        return np.where(first < t + self.horizon_s, first, np.inf)

    def next_uplink_outage_grid(self, t: float) -> np.ndarray:
        """(n_sites,) batched :meth:`next_uplink_outage_start_s`: earliest
        forecast outage start affecting any link out of each site.  (The
        clamp uses the live ``t`` — an outage already open clamps to
        ``t``.)"""
        o_start, _, _ = self.next_outage_grid(t)
        return np.maximum(o_start, t).min(axis=1)

    def next_window_start_grid(self, t: float) -> np.ndarray:
        """(n_sites,) batched :meth:`next_window_start_s`.  Read-only;
        the reveal limit is applied with the live ``t``."""
        def compute():
            starts, _ = self._window_mats
            j = (starts <= t).sum(axis=1)
            return starts[np.arange(self.n_sites), j]

        # ``starts <= t`` flips True at the start itself: bisect_right
        nxt = self._cached_grid(
            ("nw", bisect.bisect_right(self._window_start_breaks, t)),
            compute)
        return np.where(nxt < t + self.horizon_s, nxt, np.inf)

    def window_open_or_next_start_grid(self, t: float) -> np.ndarray:
        """(n_sites,) start of the current-or-next forecast window — the
        batched ``next_window(site, t).start_s`` (+inf when
        :meth:`next_window` would return None).  Read-only; the
        still-open and reveal checks use the live ``t``."""
        def compute():
            starts, ends = self._window_mats
            r = np.arange(self.n_sites)
            j = (starts <= t).sum(axis=1)
            jm = np.maximum(j - 1, 0)
            return j > 0, starts[r, jm], ends[r, jm], starts[r, j]

        has_prev, prev_start, prev_end, nxt = self._cached_grid(
            ("cn", bisect.bisect_right(self._window_start_breaks, t)),
            compute)
        open_ = has_prev & (prev_end > t)
        return np.where(open_, prev_start,
                        np.where(nxt < t + self.horizon_s, nxt, np.inf))

    def capacity_floor_bps(self, src: int, dst: int, t0: float, t1: float) -> float:
        """Minimum forecast degraded capacity on (src, dst) over [t0, t1]
        (inf when no outage overlaps — i.e. the calendar forecasts no
        degradation; combine with the advertised bandwidth via min)."""
        t1 = min(t1, t0 + self.horizon_s)
        floor = float("inf")
        for o in self._outages_for(src, dst):
            if o.end_s > t0 and o.start_s < t1:
                floor = min(floor, o.capacity_bps)
        return floor

    # -- fault-plan queries (core/faults.py) ---------------------------------
    # A realized FaultPlan is pre-materialized data, so (like brownout
    # calendars) it is forecast exactly.  Next-start queries gate at the
    # same ``t + horizon_s`` reveal limit as outage queries; repair-time
    # queries describe an outage already in progress, so no limit applies.
    def next_fault_start_after(self, src: int, dst: int, t: float) -> float:
        """First hard-fault START strictly after ``t`` that would kill
        link (src, dst) — a blackout at either endpoint or a hard link
        failure (inf when no plan / none inside the lookahead).  The
        fault analogue of :meth:`next_outage_start_after`."""
        if self.faults is None:
            return float("inf")
        s = self.faults.next_fault_start_after(src, dst, t)
        return s if s < t + self.horizon_s else float("inf")

    def next_fault_start_grid(self, t: float) -> Optional[np.ndarray]:
        """(n, n) batched :meth:`next_fault_start_after` (None when no
        plan — callers skip the masking pass entirely; inf diagonal)."""
        if self.faults is None:
            return None
        g = self.faults.next_fault_start_grid(t)
        return np.where(g < t + self.horizon_s, g, np.inf)

    def site_repair_s(self, site: int, t: float) -> float:
        """Remaining blackout time at ``site`` (0 when the site is up) —
        the repair-time estimate fault-aware policies weigh against a
        destination's queue."""
        if self.faults is None:
            return 0.0
        return self.faults.repair_time_s(site, t)

    def site_repair_grid(self, t: float) -> Optional[np.ndarray]:
        """(n_sites,) batched :meth:`site_repair_s` (None when no plan)."""
        if self.faults is None:
            return None
        return self.faults.repair_time_vec(t)

    # -- builder -------------------------------------------------------------
    @classmethod
    def build(
        cls,
        traces: Sequence,
        *,
        wan=None,
        signals: Optional[GridSignals] = None,
        horizon_s: float = DEFAULT_HORIZON_S,
        sigma_s: float = 0.0,
        seed: int = 0,
        faults: Optional[FaultPlan] = None,
    ) -> "ForecastHorizon":
        """Materialize the forecast from site traces (+ optionally a
        :class:`~repro_torch.core.wan.WanTopology` brownout calendar and the
        run's :class:`~repro_torch.core.signals.GridSignals` — signal forecasts
        are exact day-ahead schedules, attached as-is).

        Window edges get i.i.d. Gaussian jitter N(0, sigma_s²) from a
        per-(seed, site) stream drawn in trace order — deterministic and
        query-order-independent.  Windows whose noisy duration collapses
        below 60 s are dropped (the forecaster "missed" them), and
        windows the jitter pushed into overlap are merged — the query
        surface (bisect coverage in :meth:`next_window`, the overlap sum
        in :meth:`green_seconds`) assumes disjoint windows.  Outage spans
        are exact (calendars are schedules); the per-span
        ``capacity_bps`` is the calendar's degraded rate.
        """
        site_windows: List[Tuple[WindowForecast, ...]] = []
        for s, tr in enumerate(traces):
            rng = np.random.default_rng([seed, 97, s]) if sigma_s > 0 else None
            noisy: List[Tuple[float, float]] = []
            for w in tr.windows:
                if rng is not None:
                    ds, de = rng.normal(0.0, sigma_s, 2)
                else:
                    ds = de = 0.0
                a, b = max(0.0, w.start_s + ds), w.end_s + de
                if b - a >= 60.0:
                    noisy.append((a, b))
            noisy.sort()
            merged: List[List[float]] = []
            for a, b in noisy:
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            site_windows.append(tuple(WindowForecast(a, b)
                                      for a, b in merged))

        outages: List[OutageForecast] = []
        mask = getattr(wan, "brownout_mask", None)
        if mask is not None:
            degraded = wan.degraded_bps
            if mask.ndim == 1:  # fabric scope
                for h0, h1 in _compress_hours(mask):
                    outages.append(OutageForecast(
                        h0 * HOUR, h1 * HOUR, -1, -1, degraded))
            else:  # per-link scope: (n_hours, n, n)
                n = mask.shape[1]
                for src in range(n):
                    for dst in range(n):
                        if src == dst or not mask[:, src, dst].any():
                            continue
                        cap = float(min(degraded, wan.link_bps[src, dst]))
                        for h0, h1 in _compress_hours(mask[:, src, dst]):
                            outages.append(OutageForecast(
                                h0 * HOUR, h1 * HOUR, src, dst, cap))
        outages.sort(key=lambda o: (o.start_s, o.src, o.dst))
        return cls(horizon_s=float(horizon_s), sigma_s=float(sigma_s),
                   site_windows=tuple(site_windows), outages=tuple(outages),
                   signals=signals, faults=faults)


__all__ = [
    "DEFAULT_HORIZON_S", "CurtailRequest", "ForecastHorizon",
    "OutageForecast", "WindowForecast",
]
