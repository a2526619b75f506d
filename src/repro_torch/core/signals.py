"""Grid-signals subsystem: per-site time-varying carbon-intensity and
price traces (the paper's extended vision §VIII "integration with
grid-level control and demand-response ecosystems"; cf. Zhang et al.'s
carbon-aware compute-power scheduling and Wiesner et al.'s curtailment-
window studies — both show carbon/price signals change the optimal
schedule versus pure energy minimization).

The energy-accounting spine historically collapsed everything to a single
grid-kWh scalar, so no policy could distinguish a dirty-peak hour from a
clean-but-curtailed one.  This module adds the missing axis:

  * :class:`SignalStack` — piecewise-constant per-site signal traces in
    the same searchsorted/epoch-cached batched-query shape as
    :class:`~repro_torch.core.traces.TraceStack`: shared hourly breakpoints,
    ``(n_sites, K)`` value matrix, cumulative-integral rows so any
    ``∫ signal dt`` over ``[t0, t1]`` is two O(log K) lookups — which is
    what lets the next-event engine integrate gCO2/$ *analytically* per
    inter-event span (exact for piecewise-constant signals, like its kWh
    accounting).
  * :class:`GridSignals` — the carbon (gCO2/kWh) + price ($/kWh) pair a
    simulation run carries, plus derived demand-response
    :class:`CurtailRequest` events (grid-operator "shed load now" spans,
    derived from carbon-peak hours — DR notices track system stress).
  * :func:`generate_signals` — deterministic duck-curve generator
    (morning/evening carbon peaks, midday solar trough, per-site spread),
    parameterized by a scenario-composable :class:`SignalProfile`.

Accounting invariants (tests/test_signals.py):

  * grid kWh is untouched — signal accounting is a parallel integral,
    never a rewrite of the energy path;
  * per-site ``grid_gco2``/``grid_cost`` sums equal the fleet totals
    exactly (each gram is billed to exactly one site);
  * the event engine's analytic per-span integrals equal a fixed-dt
    Riemann sum in the limit, and are *exact* whenever the signal is
    piecewise-constant (our generator always is).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from functools import cached_property
from typing import Iterable, List, Optional, Tuple

import numpy as np

HOUR = 3600.0


@dataclass(frozen=True, slots=True)
class CurtailRequest:
    """A demand-response curtail-request span: the grid operator asks
    ``site`` to cap compute power at ``power_frac`` of nominal during
    ``[start_s, end_s)``.  Requests are *advisory* — the simulator never
    enforces them; a policy that honours them (receding-horizon does, via
    ``Throttle``) shifts energy out of exactly the hours the grid is
    dirtiest, which is what the carbon accounting rewards."""

    start_s: float
    end_s: float
    site: int
    power_frac: float = 0.5

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


@dataclass(frozen=True)
class SignalProfile:
    """Shape of the grid-signal process (scenario-composable; defaults
    approximate a CAISO-like duck curve: solar floods midday, the evening
    ramp is the dirty peak)."""

    # carbon intensity, gCO2/kWh
    carbon_base: float = 320.0
    carbon_morning: float = 110.0  # ~08:00 ramp bump
    carbon_evening: float = 240.0  # ~19:00 peak bump
    carbon_midday_dip: float = 130.0  # ~13:00 solar trough
    carbon_noise: float = 20.0
    carbon_min: float = 40.0
    carbon_site_spread: float = 0.10  # +- multiplicative per-site spread
    # wholesale price, $/kWh
    price_base: float = 0.12
    price_coupling: float = 0.8  # fraction of relative carbon swing tracked
    price_noise: float = 0.008
    price_min: float = 0.0
    price_site_spread: float = 0.10
    # demand-response: curtail-request spans wherever carbon >= threshold
    curtail_threshold: Optional[float] = None  # gCO2/kWh; None = no DR
    curtail_frac: float = 0.5  # requested power cap during a DR span


@dataclass(frozen=True, eq=False)
class SignalStack:
    """Piecewise-constant per-site signal traces behind batched queries.

    ``edges`` are the shared breakpoints (strictly increasing,
    ``(K+1,)``); ``values[s, k]`` holds the signal on
    ``[edges[k], edges[k+1])``; ``cum[s, k]`` is ``∫`` from ``edges[0]``
    to ``edges[k]``.  Outside the covered range the signal extrapolates
    as a constant (first/last segment value) — simulations run past the
    trace horizon for the late-job tail and must keep integrating.
    """

    edges: np.ndarray  # (K+1,)
    values: np.ndarray  # (n_sites, K)
    cum: np.ndarray  # (n_sites, K+1)

    @classmethod
    def from_values(cls, edges: np.ndarray, values: np.ndarray) -> "SignalStack":
        edges = np.asarray(edges, dtype=np.float64)
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        if edges.ndim != 1 or len(edges) != values.shape[1] + 1:
            raise ValueError("need len(edges) == values.shape[1] + 1")
        seg = np.diff(edges)
        if not (seg > 0).all():
            raise ValueError("edges must be strictly increasing")
        cum = np.zeros((values.shape[0], len(edges)))
        np.cumsum(values * seg[None, :], axis=1, out=cum[:, 1:])
        return cls(edges, values, cum)

    @property
    def n_sites(self) -> int:
        return len(self.values)

    def _seg(self, t: float) -> int:
        """Segment index covering ``t`` (clamped: constant extrapolation)."""
        k = bisect.bisect_right(self._edge_list, t) - 1
        return min(max(k, 0), self.values.shape[1] - 1)

    @cached_property
    def _edge_list(self) -> List[float]:
        return [float(v) for v in self.edges]

    @cached_property
    def _epoch_cache(self) -> dict:
        return {}

    # -- point queries -------------------------------------------------------
    def value(self, site: int, t: float) -> float:
        """Signal value at ``t`` for one site."""
        return float(self.values[site, self._seg(t)])

    def value_grid(self, t: float) -> np.ndarray:
        """(n_sites,) signal values at ``t`` — cached per breakpoint epoch
        (piecewise-constant: every ``t`` in a segment shares the column).
        Treat as read-only."""
        k = self._seg(t)
        got = self._epoch_cache.get(k)
        if got is None:
            got = self._epoch_cache[k] = self.values[:, k]
        return got

    # -- analytic integrals --------------------------------------------------
    def _cum_at(self, site: int, x: float) -> float:
        """``∫ signal dt`` from ``edges[0]`` to ``x`` (constant
        extrapolation outside the covered range)."""
        e = self._edge_list
        if x <= e[0]:
            return float((x - e[0]) * self.values[site, 0])
        if x >= e[-1]:
            return float(self.cum[site, -1]
                         + (x - e[-1]) * self.values[site, -1])
        k = bisect.bisect_right(e, x) - 1
        return float(self.cum[site, k] + (x - e[k]) * self.values[site, k])

    def integral(self, site: int, t0: float, t1: float) -> float:
        """Exact ``∫ signal dt`` over ``[t0, t1]`` (0 when t1 <= t0)."""
        if t1 <= t0:
            return 0.0
        return self._cum_at(site, t1) - self._cum_at(site, t0)

    def _cum_at_grid(self, x: float) -> np.ndarray:
        e = self._edge_list
        if x <= e[0]:
            return (x - e[0]) * self.values[:, 0]
        if x >= e[-1]:
            return self.cum[:, -1] + (x - e[-1]) * self.values[:, -1]
        k = bisect.bisect_right(e, x) - 1
        return self.cum[:, k] + (x - e[k]) * self.values[:, k]

    def integral_grid(self, t0: float, t1: float) -> np.ndarray:
        """(n_sites,) batched :meth:`integral` over a shared span."""
        if t1 <= t0:
            return np.zeros(self.n_sites)
        return self._cum_at_grid(t1) - self._cum_at_grid(t0)

    def cum_at_rows(self, sites: np.ndarray, xs: np.ndarray) -> np.ndarray:
        """Elementwise :meth:`_cum_at` over broadcastable ``(site, x)``
        arrays — the op-for-op batched mirror (same branch expressions,
        same float order), so results are bit-identical to the scalar.
        Used by the receding-horizon planner's whole-grid cost tensors."""
        sites = np.asarray(sites)
        xs = np.asarray(xs, dtype=np.float64)
        sites, xs = np.broadcast_arrays(sites, xs)
        e = self.edges
        k = np.searchsorted(e, xs, side="right") - 1
        kc = np.clip(k, 0, self.values.shape[1] - 1)
        lo = (xs - e[0]) * self.values[sites, 0]
        hi = self.cum[sites, -1] + (xs - e[-1]) * self.values[sites, -1]
        mid = self.cum[sites, kc] + (xs - e[kc]) * self.values[sites, kc]
        return np.where(xs <= e[0], lo, np.where(xs >= e[-1], hi, mid))

    def integral_rows(self, sites: np.ndarray, t0s: np.ndarray,
                      t1s: np.ndarray) -> np.ndarray:
        """Elementwise :meth:`integral` over broadcastable ``(site, t0,
        t1)`` arrays (0 where ``t1 <= t0``, exactly like the scalar)."""
        sites = np.asarray(sites)
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        sites, t0s, t1s = np.broadcast_arrays(sites, t0s, t1s)
        return np.where(t1s <= t0s, 0.0,
                        self.cum_at_rows(sites, t1s)
                        - self.cum_at_rows(sites, t0s))

    def mean(self, site: int, t0: float, t1: float) -> float:
        return self.integral(site, t0, t1) / (t1 - t0) if t1 > t0 else \
            self.value(site, t0)

    def integral_where_ge(
        self, site: int, t0: float, t1: float, floor: float,
    ) -> Tuple[float, float]:
        """``(∫ v·1[v >= floor] dt, Σ time with v >= floor)`` over
        ``[t0, t1]`` — the segment-gated integral the sell-back
        accounting bills export revenue with (a prosumer only exports
        into segments whose price clears the floor; with ``floor=0``
        this is exactly the negative-price guard).  Piecewise-exact,
        constant extrapolation outside the covered range."""
        if t1 <= t0:
            return 0.0, 0.0
        e = self._edge_list
        vals = self.values[site]
        last = len(vals) - 1
        k0 = min(max(bisect.bisect_right(e, t0) - 1, 0), last)
        k1 = min(max(bisect.bisect_right(e, t1) - 1, 0), last)
        tot = 0.0
        dur = 0.0
        for k in range(k0, k1 + 1):
            a = t0 if k == k0 else e[k]
            b = t1 if k == k1 else e[k + 1]
            if b <= a:
                continue
            v = float(vals[k])
            if v >= floor:
                tot += v * (b - a)
                dur += b - a
        return tot, dur


def grid_signal_integral(
    stack: SignalStack, site: int,
    green_overlaps: Iterable[Tuple[float, float]], t0: float, t1: float,
) -> float:
    """``∫ signal dt`` over the NON-renewable portion of ``[t0, t1]`` —
    the total integral minus the integral over the (clipped, disjoint)
    renewable-window overlaps.  Exact for piecewise-constant signals; this
    is the quantity the event engine bills per span:
    ``gCO2 = P_kW / 3600 · grid_signal_integral(carbon, ...)``."""
    tot = stack.integral(site, t0, t1)
    for a, b in green_overlaps:
        tot -= stack.integral(site, max(t0, a), min(t1, b))
    return tot


@dataclass(frozen=True, eq=False)
class GridSignals:
    """The per-run signal bundle: carbon + price stacks over the same
    site fleet, plus derived demand-response curtail-request events
    (start-sorted)."""

    carbon: SignalStack  # gCO2/kWh
    price: SignalStack  # $/kWh
    curtailments: Tuple[CurtailRequest, ...] = ()

    @property
    def n_sites(self) -> int:
        return self.carbon.n_sites


def _compress_true_runs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Runs of consecutive True entries as [k0, k1) index pairs."""
    runs: List[Tuple[int, int]] = []
    start = None
    for k, hot in enumerate(mask):
        if hot and start is None:
            start = k
        elif not hot and start is not None:
            runs.append((start, k))
            start = None
    if start is not None:
        runs.append((start, len(mask)))
    return runs


def curtail_requests_from_carbon(
    carbon: SignalStack, threshold: float, power_frac: float,
) -> Tuple[CurtailRequest, ...]:
    """Derive demand-response spans from the carbon trace: every maximal
    run of segments with ``carbon >= threshold`` at a site becomes one
    :class:`CurtailRequest` (DR notices track system stress, which the
    carbon signal proxies)."""
    out: List[CurtailRequest] = []
    edges = carbon.edges
    for s in range(carbon.n_sites):
        for k0, k1 in _compress_true_runs(carbon.values[s] >= threshold):
            out.append(CurtailRequest(float(edges[k0]), float(edges[k1]),
                                      s, power_frac))
    out.sort(key=lambda c: (c.start_s, c.site))
    return tuple(out)


def _bump(hod: np.ndarray, center: float, width: float) -> np.ndarray:
    """Diurnal Gaussian bump on hour-of-day (wrap-around distance)."""
    d = np.abs(hod - center)
    d = np.minimum(d, 24.0 - d)
    return np.exp(-0.5 * (d / width) ** 2)


def generate_signals(
    n_sites: int = 5,
    days: int = 7,
    *,
    seed: int = 0,
    profile: Optional[SignalProfile] = None,
    **overrides,
) -> GridSignals:
    """Deterministic hourly carbon/price traces for a site fleet.

    Hourly piecewise-constant duck curve per site: morning and evening
    carbon bumps, a midday solar trough, a per-site multiplicative spread
    (geographic grid mix) and i.i.d. hourly noise; price tracks the
    relative carbon swing through ``price_coupling`` plus its own spread/
    noise.  Traces cover ``2 * days`` (the simulator runs the late-job
    tail to twice the horizon) and extrapolate as constants beyond.

    Deterministic per ``(seed, profile)`` and independent of every other
    RNG stream in the run (own ``default_rng([seed, 131])`` seeding) —
    adding signals to a simulation changes no existing draw.
    """
    import dataclasses as _dc

    prof = profile or SignalProfile()
    if overrides:
        prof = _dc.replace(prof, **overrides)
    n_hours = 2 * days * 24
    edges = np.arange(n_hours + 1, dtype=np.float64) * HOUR
    hod = (np.arange(n_hours, dtype=np.float64) + 0.5) % 24.0
    shape = (prof.carbon_morning * _bump(hod, 8.0, 1.5)
             + prof.carbon_evening * _bump(hod, 19.0, 2.0)
             - prof.carbon_midday_dip * _bump(hod, 13.0, 2.5))
    rng = np.random.default_rng([seed, 131])
    carbon = np.empty((n_sites, n_hours))
    price = np.empty((n_sites, n_hours))
    for s in range(n_sites):
        c_scale = 1.0 + prof.carbon_site_spread * float(rng.uniform(-1, 1))
        p_scale = 1.0 + prof.price_site_spread * float(rng.uniform(-1, 1))
        c = (prof.carbon_base * c_scale + shape
             + rng.normal(0.0, prof.carbon_noise, n_hours))
        carbon[s] = np.maximum(prof.carbon_min, c)
        rel = (carbon[s] - prof.carbon_base) / prof.carbon_base
        p = (prof.price_base * p_scale * (1.0 + prof.price_coupling * rel)
             + rng.normal(0.0, prof.price_noise, n_hours))
        price[s] = np.maximum(prof.price_min, p)
    carbon_stack = SignalStack.from_values(edges, carbon)
    price_stack = SignalStack.from_values(edges, price)
    curtail: Tuple[CurtailRequest, ...] = ()
    if prof.curtail_threshold is not None:
        curtail = curtail_requests_from_carbon(
            carbon_stack, prof.curtail_threshold, prof.curtail_frac)
    return GridSignals(carbon=carbon_stack, price=price_stack,
                       curtailments=curtail)


__all__ = [
    "CurtailRequest", "GridSignals", "SignalProfile", "SignalStack",
    "curtail_requests_from_carbon", "generate_signals",
    "grid_signal_integral",
]
