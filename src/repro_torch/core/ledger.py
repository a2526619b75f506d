"""Unified per-site power ledger + prosumer microgrid layer.

Historically the energy/carbon/price accounting was smeared across four
layers: the simulator's per-span kWh integration (``flush``), the
signal integrals (:mod:`repro_torch.core.signals`), the serving plane's
separate ``serve_*`` accumulators and the scalar model in
``feasibility``.  Any storage or sell-back model must hook into *all*
of them, so the prerequisite is one accounting spine:
:class:`PowerLedger` — a per-site ledger that reconciles **sources**
(renewable window, grid, battery discharge) against **sinks** (training
compute, serving compute, migration NIC draw, battery charge, sell-back
export) analytically per inter-event span.

The ledger is a pure relocation of the existing accounting when storage
is disabled: every posting reproduces the historical float expressions
*op for op* (same association order, same guards), so all benchmark
digits are bit-identical with ``battery=None``.  The invariant is
enforced structurally — every posting feeds a per-site source/sink
pair (:meth:`PowerLedger.audit` checks sources ≡ sinks), and the
conservation accumulators are separate floats that never touch the
billing arithmetic.

On top of the ledger sits the prosumer layer (the paper's §VIII
"grid-level control and demand-response ecosystems" horizon; cf.
*Carbon-Aware Compute–Power Scheduling with Microgrid Prosumer
Operations* for the battery/sell-back operating model and the
curtailment-window studies for why charging from otherwise-curtailed
energy dominates the economics):

  * :class:`BatteryConfig` — per-site storage that charges from
    curtailed renewables (green window time at ``max_charge_kw``, the
    round-trip efficiency applied on the charge leg so delivered energy
    is exactly ``e_in * rte``), and discharges through carbon peaks
    (demand-driven at posting time, gated on the span's mean dark-time
    carbon intensity) — grid kWh/gCO2/$ billed for a span shrink by the
    battery-covered fraction.
  * sell-back: residual green time after the battery is full exports at
    ``sellback_kw``, billed in :class:`~repro_torch.core.signals.SignalStack`
    dollars only over segments with ``price >= sellback_price_floor``
    (the negative-price guard: exporting into a negative price would
    *cost* money, so the prosumer simply doesn't).
  * :class:`ThrottleCurve` — a physical power-cap model: ``Throttle``
    actions set a GPU *power* fraction which maps through a measured
    piecewise-linear power→throughput curve (DVFS-sweep shaped —
    sub-linear power savings at high caps, super-linear throughput loss
    near idle) instead of the legacy linear scalar.

All of the battery/sell-back machinery is fully deterministic and
consumes **zero** RNG draws; enabling it changes no stream anywhere.

Approximations (documented, conservative): concurrently-posted spans at
one site each see up to ``max_discharge_kw`` of battery power (the
energy budget is shared and never exceeds the state of charge, but the
power cap is per-flow); the battery timeline is advanced to each span's
*end* before discharging, so charge landed late in a span can serve
dark time earlier in the same span (spans are one inter-event interval,
typically minutes).  Serving compute is reconciled as a sink but not
battery-backed.
"""
from __future__ import annotations

import numpy as np

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.signals import GridSignals, grid_signal_integral

HOUR = 3600.0

#: Measured DVFS-sweep shape (normalized): capping GPU power to 50%
#: keeps ~66% of throughput — power savings are sub-linear because
#: static/idle draw doesn't scale with the cap.
DVFS_CURVE_POINTS: Tuple[Tuple[float, float], ...] = (
    (0.0, 0.0), (0.3, 0.42), (0.5, 0.66), (0.7, 0.85), (1.0, 1.0),
)


@dataclass(frozen=True, eq=False)
class ThrottleCurve:
    """Piecewise-linear power→throughput map for power-capped compute.

    ``points`` are ``(power_frac, throughput_frac)`` knots, strictly
    increasing in power, interpolated linearly (``np.interp``) and
    clamped at the ends.  The default is the normalized DVFS-sweep
    shape above.  ``ThrottleCurve.linear()`` gives the legacy
    throughput == power identity.
    """

    points: Tuple[Tuple[float, float], ...] = DVFS_CURVE_POINTS

    def __post_init__(self):
        px = [p for p, _ in self.points]
        if len(px) < 2 or any(b <= a for a, b in zip(px, px[1:])):
            raise ValueError(
                "ThrottleCurve needs >= 2 points, strictly increasing "
                f"in power_frac: {self.points!r}")

    @classmethod
    def linear(cls) -> "ThrottleCurve":
        return cls(points=((0.0, 0.0), (1.0, 1.0)))

    @cached_property
    def _px(self) -> np.ndarray:
        return np.array([p for p, _ in self.points], dtype=np.float64)

    @cached_property
    def _py(self) -> np.ndarray:
        return np.array([y for _, y in self.points], dtype=np.float64)

    def throughput(self, power_frac: float) -> float:
        """Throughput fraction delivered at ``power_frac`` of nominal."""
        return float(np.interp(power_frac, self._px, self._py))

    def throughput_rows(self, power_fracs: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`throughput` (same interp, same clamping)."""
        return np.interp(np.asarray(power_fracs, dtype=np.float64),
                         self._px, self._py)


@dataclass(frozen=True)
class BatteryConfig:
    """Per-site storage + sell-back spec (scenario-composable, frozen).

    The charge leg applies the full round-trip efficiency (state of
    charge gains ``e_in * round_trip_efficiency``); the discharge leg
    delivers 1:1 — so round-trip delivered energy is *exactly*
    ``e_in * rte`` in one multiply (the property tests check this
    bit-exactly).  ``discharge_threshold_g`` gates discharge on the
    span's mean dark-time carbon intensity (discharge through forecast
    carbon peaks, hold through clean hours); ``<= 0`` discharges
    whenever there is dark demand.  ``sellback_kw > 0`` exports
    residual green time (after the battery is full) at that power,
    credited in dollars only where ``price >= sellback_price_floor``.
    """

    capacity_kwh: float = 20.0
    max_charge_kw: float = 5.0
    max_discharge_kw: float = 5.0
    round_trip_efficiency: float = 0.90
    discharge_threshold_g: float = 250.0  # mean dark gCO2/kWh gate
    sellback_kw: float = 0.0  # 0 = no export
    sellback_price_floor: float = 0.0  # $/kWh; the negative-price guard
    initial_soc_frac: float = 0.0

    def __post_init__(self):
        if self.capacity_kwh <= 0.0:
            raise ValueError("capacity_kwh must be > 0")
        if not 0.0 < self.round_trip_efficiency <= 1.0:
            raise ValueError("round_trip_efficiency must be in (0, 1]")
        if not 0.0 <= self.initial_soc_frac <= 1.0:
            raise ValueError("initial_soc_frac must be in [0, 1]")


class PowerLedger:
    """Per-site source/sink reconciliation for one simulation run.

    Owns every energy/carbon/price accumulator the run reports:

    ======================  =================================================
    attribute               meaning
    ======================  =================================================
    ``grid_kwh``            grid energy drawn by training + migration
    ``renewable_kwh``       in-window energy consumed by training
    ``migration_kwh``       NIC/system draw of checkpoint transfers
    ``grid_gco2/grid_cost`` signal-billed training+migration carbon / $
    ``site_grid_gco2/...``  the per-site split of the same (sums exactly)
    ``serve_*``             the serving plane's separate accumulators
    ``request_gco2``        signal-billed serving carbon (+ per-site split)
    ``battery_*_kwh``       charge input / discharged / conversion loss
    ``sellback_kwh/usd``    exported energy and SignalStack-billed revenue
    ``dr_*_ws``             demand-response requested vs shed watt-seconds
    ``soc``                 (n,) current state of charge, kWh
    ======================  =================================================

    Postings (``post_train`` / ``post_migration`` / ``post_serve``)
    reproduce the historical accounting bit-for-bit when
    ``battery is None``; every posting also feeds the per-site
    conservation pair checked by :meth:`audit`.
    """

    def __init__(
        self,
        n_sites: int,
        *,
        signals: Optional[GridSignals] = None,
        traces: Optional[Sequence] = None,
        battery: Optional[BatteryConfig] = None,
    ):
        self.n_sites = n_sites
        self.signals = signals
        self.traces = traces
        self.battery = battery
        # training + migration accounting (the simulator's historical set)
        self.grid_kwh = 0.0
        self.renewable_kwh = 0.0
        self.migration_kwh = 0.0
        self.grid_gco2 = 0.0
        self.grid_cost = 0.0
        self.site_grid_gco2 = np.zeros(n_sites)
        self.site_grid_cost = np.zeros(n_sites)
        # serving accounting (the plane's historical separate set)
        self.serve_grid_kwh = 0.0
        self.serve_renewable_kwh = 0.0
        self.request_gco2 = 0.0
        self.site_request_gco2 = np.zeros(n_sites)
        # prosumer layer
        self.battery_charge_kwh = 0.0  # energy drawn INTO the charger
        self.battery_discharge_kwh = 0.0  # energy delivered to compute
        self.battery_loss_kwh = 0.0  # conversion loss (charge leg)
        self.sellback_kwh = 0.0
        self.sellback_usd = 0.0
        # demand-response compliance (watt-seconds, see dr_compliance)
        self.dr_requested_ws = 0.0
        self.dr_shed_ws = 0.0
        # battery state
        if battery is not None:
            self.soc = np.full(
                n_sites, battery.capacity_kwh * battery.initial_soc_frac)
            self._batt_t = np.zeros(n_sites)
        else:
            self.soc = np.zeros(n_sites)
        # per-site conservation pair (separate floats: these NEVER feed
        # the billing arithmetic, so tracking them cannot move a digit)
        self._src_kwh = np.zeros(n_sites)
        self._snk_kwh = np.zeros(n_sites)
        # serve-bill sync hook: a serving plane that defers its bills
        # registers its flush here; every OTHER posting (and the audit)
        # drains the deferred bills first so the global add order onto
        # the shared accumulators stays exactly the per-event order
        self._serve_sync: Optional[Callable[[], None]] = None
        # demand-response curtail index: per-site start-sorted arrays
        self._dr: Optional[List] = None
        if signals is not None and signals.curtailments:
            per: List[List] = [[] for _ in range(n_sites)]
            for c in signals.curtailments:
                if 0 <= c.site < n_sites:
                    per[c.site].append(c)
            self._dr = []
            for lst in per:
                if lst:
                    self._dr.append((
                        np.array([c.start_s for c in lst]),
                        np.array([c.end_s for c in lst]),
                        np.array([c.power_frac for c in lst])))
                else:
                    self._dr.append(None)

    # -- postings ------------------------------------------------------------
    def post_train(
        self, site: int, p_kw: float, t0: float, t1: float,
        green_s: float = 0.0, p_nominal_kw: Optional[float] = None,
    ) -> Tuple[float, float]:
        """Bill one training-compute span drawing ``p_kw``.

        ``green_s`` is the renewable-window overlap of ``[t0, t1]``
        (the caller's ``traces[site].renewable_seconds``).  Returns
        ``(renewable_kwh, grid_kwh)`` for the span so the caller can
        keep per-job accounting; with a battery the grid half is net of
        battery discharge.  ``p_nominal_kw`` (the un-throttled draw)
        enables demand-response compliance tracking.
        """
        if self._serve_sync is not None:
            self._serve_sync()
        span = t1 - t0
        e_g = p_kw * green_s / HOUR
        e_b = p_kw * (span - green_s) / HOUR
        self.renewable_kwh += e_g
        self._src_kwh[site] += e_g
        self._snk_kwh[site] += e_g + e_b
        if p_nominal_kw is not None and self._dr is not None:
            self.post_dr(site, p_kw, p_nominal_kw, t0, t1)
        e_grid = self._grid_sink(site, p_kw, e_b, t0, t1, green_s)
        return e_g, e_grid

    def post_migration(
        self, site: int, p_kw: float, t0: float, t1: float,
    ) -> float:
        """Bill one migration (NIC/system draw) span: all grid, no
        renewable credit — exactly the historical treatment."""
        if self._serve_sync is not None:
            self._serve_sync()
        span = t1 - t0
        e = p_kw * span / HOUR
        self.migration_kwh += e
        self._snk_kwh[site] += e
        return self._grid_sink(site, p_kw, e, t0, t1, 0.0)

    def post_serve(self, site: int, p_kw: float, t0: float, t1: float):
        """Bill one serving-replica service span (the plane's historical
        ``_bill``, guards and all — serving digits never move)."""
        if self._serve_sync is not None:
            self._serve_sync()
        span = t1 - t0
        if span <= 0.0:
            return
        green = self.traces[site].renewable_seconds(t0, t1)
        self.serve_renewable_kwh += p_kw * green / HOUR
        self.serve_grid_kwh += p_kw * (span - green) / HOUR
        e_tot = p_kw * span / HOUR
        self._src_kwh[site] += e_tot
        self._snk_kwh[site] += e_tot
        if self.signals is None or green >= span:
            if self.signals is None:
                return
        if green <= 0.0:
            ci = self.signals.carbon.integral(site, t0, t1)
        else:
            ov = self.traces[site].overlaps(t0, t1)
            ci = grid_signal_integral(self.signals.carbon, site, ov, t0, t1)
        g = p_kw / HOUR * ci
        self.request_gco2 += g
        self.site_request_gco2[site] += g

    @cached_property
    def _serve_window_stack(self):
        """Padded window stack for :meth:`post_serve_block` span
        classification (built lazily; serving traces are static for the
        life of a run, matching the plane's own stack assumption)."""
        from repro_torch.core.traces import stack_traces
        return stack_traces(self.traces)

    @cached_property
    def _serve_window_lists(self):
        """Per-site window boundaries as Python lists plus the mutable
        warm-start pointer state for :meth:`post_serve_block` (the +inf
        padding from the stack doubles as the sentinel that stops the
        pointer advance)."""
        st = self._serve_window_stack
        return ([row.tolist() for row in st.starts],
                [row.tolist() for row in st.ends],
                [-1] * len(st.starts))

    def post_serve_block(self, sites, p_kw: float, t0s, t1s) -> None:
        """Bill a sequence of service spans, bit-identical to calling
        :meth:`post_serve` once per span in order.

        Sub-second service spans almost never straddle a renewable
        window edge, which leaves two exact-arithmetic regimes:

        * fully inside one window — ``renewable_seconds`` returns the
          span itself (one ``min/max`` clip, no summation), so the grid
          half is ``p_kw * (span - span) / HOUR == +0.0`` and
          ``grid_signal_integral`` over the full overlap is
          ``tot - tot == +0.0``: both adds are bitwise no-ops and can
          be skipped;
        * fully inside one gap — ``renewable_seconds`` is ``+0.0``, the
          renewable add is a no-op, and the carbon integral takes the
          ``green <= 0`` branch, whose batched mirror is
          ``SignalStack.integral_rows`` (documented bit-identical).

        Spans that do straddle an edge (or are non-positive) fall back
        to the scalar posting, preserving sequence order around them.
        """
        n = len(sites)
        if n == 0:
            return
        if self.traces is None or n < 8:
            for i in range(n):
                self.post_serve(sites[i], p_kw, t0s[i], t1s[i])
            return
        if n >= 4096:
            self._post_serve_block_vec(sites, p_kw, t0s, t1s)
            return
        sig = self.signals
        has_sig = sig is not None
        # classify each span against its site's renewable windows with a
        # persistent per-site pointer: service spans complete in nearly
        # monotone time order per site, so the warm-start walk is O(1)
        # amortized (the pointer regresses only when a span's start
        # jitters back across a boundary)
        st_l, en_l, ptrs = self._serve_window_lists
        # 0 = skip (span <= 0), 1 = window, 2 = gap, 3 = straddle
        cls_l: list = []
        ca = cls_l.append
        gi_: list = []
        gs_: list = []
        g0_: list = []
        g1_: list = []
        i = -1
        for s, t0v, t1v in zip(sites, t0s, t1s):
            i += 1
            if t1v <= t0v:
                ca(0)
                continue
            sts = st_l[s]
            p = ptrs[s]
            while sts[p + 1] <= t0v:
                p += 1
            while p >= 0 and sts[p] > t0v:
                p -= 1
            ptrs[s] = p
            if p >= 0:
                if t1v <= en_l[s][p]:
                    ca(1)
                    continue
                if not (t0v >= en_l[s][p] and t1v <= sts[p + 1]):
                    ca(3)
                    continue
            elif t1v > sts[0]:
                ca(3)
                continue
            ca(2)
            if has_sig:
                gi_.append(i)
                gs_.append(s)
                g0_.append(t0v)
                g1_.append(t1v)
        g_l = None
        if has_sig and gi_:
            ci = sig.carbon.integral_rows(
                np.asarray(gs_, dtype=np.int64),
                np.asarray(g0_, dtype=np.float64),
                np.asarray(g1_, dtype=np.float64))
            coef = p_kw / HOUR
            g_l = [0.0] * n
            cil = ci.tolist()
            for j, i in enumerate(gi_):
                g_l[i] = coef * cil[j]
        src = self._src_kwh
        snk = self._snk_kwh
        sg = self.site_request_gco2
        # hoisted float accumulators (flushed around scalar fallbacks,
        # which mutate the same attributes)
        ren = self.serve_renewable_kwh
        grd = self.serve_grid_kwh
        rg = self.request_gco2
        i = -1
        for c, s, t0v, t1v in zip(cls_l, sites, t0s, t1s):
            i += 1
            if c == 1:
                e = p_kw * (t1v - t0v) / HOUR
                ren += e
                src[s] += e
                snk[s] += e
            elif c == 2:
                e = p_kw * (t1v - t0v) / HOUR
                grd += e
                if has_sig:
                    g = g_l[i]
                    rg += g
                    sg[s] += g
                src[s] += e
                snk[s] += e
            elif c == 3:
                self.serve_renewable_kwh = ren
                self.serve_grid_kwh = grd
                self.request_gco2 = rg
                self.post_serve(s, p_kw, t0v, t1v)
                ren = self.serve_renewable_kwh
                grd = self.serve_grid_kwh
                rg = self.request_gco2
        self.serve_renewable_kwh = ren
        self.serve_grid_kwh = grd
        self.request_gco2 = rg

    def _post_serve_block_vec(
        self, sites, p_kw: float, t0s, t1s,
    ) -> None:
        """Large-flush mirror of the pointer-walk path: classification
        by padded-stack broadcast, energies elementwise, and every float
        accumulator advanced with ``np.add.accumulate`` — a strict left
        fold, so the bits match the equivalent scalar ``+=`` loop.
        Straddle spans split the flush into segments and replay through
        the scalar posting at their exact position in the sequence."""
        sa = np.asarray(sites, dtype=np.int64)
        t0a = np.asarray(t0s, dtype=np.float64)
        t1a = np.asarray(t1s, dtype=np.float64)
        n = sa.shape[0]
        st = self._serve_window_stack
        starts, ends = st.starts, st.ends
        cls = np.empty(n, dtype=np.int8)
        # chunked so the (rows, windows) gather/broadcast temporaries
        # stay a few MB regardless of flush size
        for lo in range(0, n, 65536):
            hi = min(lo + 65536, n)
            s_ = sa[lo:hi]
            t0_ = t0a[lo:hi]
            t1_ = t1a[lo:hi]
            stg = starts[s_]
            # p = last window start <= t0 (same count the pointer walk
            # converges to; the +inf padding never counts)
            p = (t0_[:, None] >= stg).sum(axis=1) - 1
            endp = ends[s_, np.maximum(p, 0)]
            nxt = stg[np.arange(hi - lo), p + 1]
            has_p = p >= 0
            w = has_p & (t1_ <= endp)
            gap = np.where(has_p, (t0_ >= endp) & (t1_ <= nxt),
                           t1_ <= stg[:, 0])
            c = np.full(hi - lo, 3, dtype=np.int8)
            c[gap] = 2
            c[w] = 1
            c[t1_ <= t0_] = 0
            cls[lo:hi] = c
        e = p_kw * (t1a - t0a) / HOUR
        wm = cls == 1
        gm = cls == 2
        sig = self.signals
        g_arr = None
        if sig is not None and gm.any():
            ci = sig.carbon.integral_rows(sa[gm], t0a[gm], t1a[gm])
            g_arr = np.zeros(n)
            g_arr[gm] = (p_kw / HOUR) * ci
        e12 = wm | gm
        src = self._src_kwh
        snk = self._snk_kwh
        sg = self.site_request_gco2
        present = np.unique(sa).tolist()

        def _acc(lo: int, hi: int) -> None:
            seg_w = wm[lo:hi]
            seg_g = gm[lo:hi]
            seg_e = e[lo:hi]
            ew = seg_e[seg_w]
            if ew.size:
                self.serve_renewable_kwh = _chain(
                    self.serve_renewable_kwh, ew)
            eg = seg_e[seg_g]
            if eg.size:
                self.serve_grid_kwh = _chain(self.serve_grid_kwh, eg)
                if g_arr is not None:
                    self.request_gco2 = _chain(
                        self.request_gco2, g_arr[lo:hi][seg_g])
            seg_s = sa[lo:hi]
            seg_12 = e12[lo:hi]
            for s in present:
                ms = seg_s == s
                es = seg_e[ms & seg_12]
                if es.size:
                    src[s] = _chain(src[s], es)
                    snk[s] = _chain(snk[s], es)
                if g_arr is not None:
                    gs_v = g_arr[lo:hi][ms & seg_g]
                    if gs_v.size:
                        sg[s] = _chain(sg[s], gs_v)

        prev = 0
        for si in np.flatnonzero(cls == 3).tolist():
            if si > prev:
                _acc(prev, si)
            self.post_serve(int(sa[si]), p_kw,
                            float(t0a[si]), float(t1a[si]))
            prev = si + 1
        if prev < n:
            _acc(prev, n)

    def post_train_tick(
        self, site: int, e_kwh: float, green: bool,
        carb: np.ndarray, price: np.ndarray,
    ) -> None:
        """Fixed-dt (rectangle-rule) training posting — the legacy
        engine's per-tick accounting.  Storage is event-engine only."""
        if self._serve_sync is not None:
            self._serve_sync()
        self._snk_kwh[site] += e_kwh
        self._src_kwh[site] += e_kwh
        if green:
            self.renewable_kwh += e_kwh
        else:
            self.grid_kwh += e_kwh
            self._bill_tick(site, e_kwh, carb, price)

    def post_migration_tick(
        self, site: int, e_kwh: float, carb: np.ndarray, price: np.ndarray,
    ) -> None:
        if self._serve_sync is not None:
            self._serve_sync()
        self.migration_kwh += e_kwh
        self.grid_kwh += e_kwh
        self._snk_kwh[site] += e_kwh
        self._src_kwh[site] += e_kwh
        self._bill_tick(site, e_kwh, carb, price)

    def post_dr(
        self, site: int, p_kw: float, p_nominal_kw: float,
        t0: float, t1: float,
    ) -> None:
        """Demand-response compliance accounting: for every
        :class:`~repro_torch.core.signals.CurtailRequest` overlapping the
        span, accumulate the watt-seconds the request asked to shed
        (``p_nominal * (1 - power_frac)``) and the watt-seconds
        actually shed (``p_nominal - p_kw``)."""
        if self._dr is None or self._dr[site] is None:
            return
        starts, ends, fracs = self._dr[site]
        i = int(np.searchsorted(ends, t0, side="right"))
        n = len(starts)
        while i < n and starts[i] < t1:
            ov = min(t1, ends[i]) - max(t0, starts[i])
            if ov > 0.0:
                self.dr_requested_ws += p_nominal_kw * (1.0 - fracs[i]) * ov
                self.dr_shed_ws += (p_nominal_kw - p_kw) * ov
            i += 1

    # -- the shared grid/battery sink --------------------------------------
    def _grid_sink(
        self, site: int, p_kw: float, e_b: float,
        t0: float, t1: float, green_s: float,
    ) -> float:
        """Grid-draw posting shared by training and migration spans:
        signal-bill the dark portion, let the battery cover what it can,
        and return the net grid kWh actually drawn."""
        span = t1 - t0
        sig = self.signals
        billable = not (span <= 0.0 or green_s >= span) and sig is not None
        if billable:
            if green_s <= 0.0:
                # fully dark span: straight integral
                ci = sig.carbon.integral(site, t0, t1)
                pi = sig.price.integral(site, t0, t1)
            else:
                # mixed span: subtract the window overlaps
                ov = self.traces[site].overlaps(t0, t1)
                ci = grid_signal_integral(sig.carbon, site, ov, t0, t1)
                pi = grid_signal_integral(sig.price, site, ov, t0, t1)
        else:
            ci = pi = 0.0
        if self.battery is None:
            # storage-off fast path: the historical accounting verbatim
            # (no extra multiplies anywhere near the billed values)
            self.grid_kwh += e_b
            self._src_kwh[site] += e_b
            if billable:
                g = p_kw / HOUR * ci
                c = p_kw / HOUR * pi
                self.grid_gco2 += g
                self.grid_cost += c
                self.site_grid_gco2[site] += g
                self.site_grid_cost[site] += c
            return e_b
        # prosumer branch: advance the battery timeline through this
        # span (charging / selling its green subspans), then discharge
        # into its dark demand
        batt = self.battery
        self._advance_battery(site, t1)
        e_d = 0.0
        dark_s = span - green_s
        if e_b > 0.0 and dark_s > 0.0 and self.soc[site] > 0.0:
            thr = batt.discharge_threshold_g
            if thr <= 0.0 or (billable and ci / dark_s >= thr):
                e_d = min(self.soc[site],
                          batt.max_discharge_kw * dark_s / HOUR, e_b)
                if e_d > 0.0:
                    self.soc[site] -= e_d
                    self.battery_discharge_kwh += e_d
        e_grid = e_b - e_d
        self.grid_kwh += e_grid
        self._src_kwh[site] += e_grid + e_d
        if billable:
            g = p_kw / HOUR * ci
            c = p_kw / HOUR * pi
            if e_d > 0.0:
                scale = e_grid / e_b
                g *= scale
                c *= scale
            self.grid_gco2 += g
            self.grid_cost += c
            self.site_grid_gco2[site] += g
            self.site_grid_cost[site] += c
        return e_grid

    def _bill_tick(self, site: int, e_kwh: float,
                   carb: np.ndarray, price: np.ndarray) -> None:
        """Rectangle-rule signal billing of one fixed-dt grid tick."""
        if self.signals is None or e_kwh <= 0.0:
            return
        g = e_kwh * float(carb[site])
        c = e_kwh * float(price[site])
        self.grid_gco2 += g
        self.grid_cost += c
        self.site_grid_gco2[site] += g
        self.site_grid_cost[site] += c

    # -- battery timeline ----------------------------------------------------
    def _advance_battery(self, site: int, t: float) -> None:
        """Advance a site's battery cursor to ``t``: charge from the
        renewable windows (curtailed energy — the trace's green time is
        surplus by construction) at ``max_charge_kw`` until full, then
        export residual green time at ``sellback_kw`` wherever the
        price clears the floor.  Deterministic, zero RNG."""
        t0 = float(self._batt_t[site])
        if t <= t0 or self.traces is None:
            if t > t0:
                self._batt_t[site] = t
            return
        batt = self.battery
        rte = batt.round_trip_efficiency
        cap = batt.capacity_kwh
        for a, b in self.traces[site].overlaps(t0, t):
            if b <= a:
                continue
            # charge leg: rte applied here, so discharge delivers 1:1
            # and round-trip = e_in * rte exactly
            a2 = a
            room = cap - self.soc[site]
            if room > 0.0 and batt.max_charge_kw > 0.0:
                t_full = a + room / (batt.max_charge_kw * rte) * HOUR
                chg_end = min(b, t_full)
                if chg_end > a:
                    e_in = batt.max_charge_kw * (chg_end - a) / HOUR
                    e_st = e_in * rte
                    self.soc[site] += e_st
                    if self.soc[site] > cap:
                        self.soc[site] = cap
                    self.battery_charge_kwh += e_in
                    self.battery_loss_kwh += e_in - e_st
                    self._src_kwh[site] += e_in
                    self._snk_kwh[site] += e_st + (e_in - e_st)
                    a2 = chg_end
            # sell-back: export residual green time where price >= floor
            if (batt.sellback_kw > 0.0 and b > a2
                    and self.signals is not None):
                pi, dur = self.signals.price.integral_where_ge(
                    site, a2, b, batt.sellback_price_floor)
                if dur > 0.0:
                    e_x = batt.sellback_kw * dur / HOUR
                    self.sellback_kwh += e_x
                    self.sellback_usd += batt.sellback_kw / HOUR * pi
                    self._src_kwh[site] += e_x
                    self._snk_kwh[site] += e_x
        self._batt_t[site] = t

    def finalize(self, t_end: float) -> None:
        """Run the battery/sell-back timeline of every site out to the
        end of the simulation (idle sites still charge and export)."""
        if self.battery is not None and self.traces is not None:
            for s in range(self.n_sites):
                self._advance_battery(s, t_end)

    # -- derived metrics -----------------------------------------------------
    @property
    def battery_cycles(self) -> float:
        """Equivalent full discharge cycles summed over the fleet."""
        if self.battery is None:
            return 0.0
        return self.battery_discharge_kwh / self.battery.capacity_kwh

    @property
    def dr_compliance(self) -> float:
        """Fraction of curtail-request span-watts actually shed
        (1.0 when no request overlapped any compute span)."""
        if self.dr_requested_ws <= 0.0:
            return 1.0
        return min(1.0, max(0.0, self.dr_shed_ws / self.dr_requested_ws))

    # -- invariants ----------------------------------------------------------
    def audit(self, rel_tol: float = 1e-9, abs_tol: float = 1e-6) -> None:
        """Conservation invariants (AssertionError on violation):
        per-site sources ≡ sinks (within float accumulation tolerance —
        ``(e_b - e_d) + e_d`` is one ulp off ``e_b``), and the state of
        charge stays within ``[0, capacity]``."""
        if self._serve_sync is not None:
            self._serve_sync()
        scale = np.maximum(np.abs(self._src_kwh), np.abs(self._snk_kwh))
        err = np.abs(self._src_kwh - self._snk_kwh)
        bad = err > np.maximum(rel_tol * scale, abs_tol)
        assert not bad.any(), (
            "ledger sources != sinks at sites "
            f"{np.nonzero(bad)[0].tolist()}: src="
            f"{self._src_kwh[bad]}, snk={self._snk_kwh[bad]}")
        if self.battery is not None:
            cap = self.battery.capacity_kwh
            assert (self.soc >= -abs_tol).all() and (
                self.soc <= cap + abs_tol).all(), (
                f"battery SoC out of [0, {cap}]: {self.soc}")


def _chain(x0, vals: np.ndarray):
    """Sequential-order sum ``(((x0 + v0) + v1) + ...)``: ufunc
    ``accumulate`` is a strict left fold (no pairwise regrouping), so
    the result is bit-identical to a Python loop of ``+=`` adds."""
    buf = np.empty(vals.size + 1)
    buf[0] = x0
    buf[1:] = vals
    np.add.accumulate(buf, out=buf)
    return float(buf[-1])


__all__ = [
    "BatteryConfig", "DVFS_CURVE_POINTS", "PowerLedger", "ThrottleCurve",
]
