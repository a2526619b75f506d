"""Renewable-surplus window traces calibrated on CAISO curtailment
statistics (paper §VII: 7-day trace, mean window ≈ 2.5 h; footnote 1:
events last 2.5–9.5 h; solar curtailment peaks midday).

Windows are generated per site with a diurnal solar profile: one surplus
window per day with probability `p_window`, centered near local noon
(per-site phase offsets model geographic spread), duration ~ clipped
lognormal with mean 2.5 h. Deterministic given a seed.

Forecasts: the orchestrator sees the true window start/end with Gaussian
noise on the remaining duration (σ configurable); the Oracle policy gets
σ = 0 (paper Table VIII 'Perfect Forecast').
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR


@dataclass(frozen=True, slots=True)
class Window:
    start_s: float
    end_s: float

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s


@dataclass
class TraceProfile:
    """Shape of the renewable-surplus process a trace is drawn from.
    Scenario dataclasses compose one of these; ``generate_trace`` consumes
    it. Defaults reproduce the paper's CAISO calibration (§VII, fn. 1)."""

    mean_window_h: float = 4.25
    max_window_h: float = 9.5
    min_window_h: float = 1.5
    p_window: float = 1.0
    noon_h: float = 12.5
    phase_spread_h: float = 9.0
    p_wind: float = 0.5
    wind_mean_h: float = 2.5


@dataclass(slots=True)
class SiteTrace:
    site: int
    windows: List[Window]
    # bisect cache over the (sorted, non-overlapping) window bounds; rebuilt
    # whenever the window count changes
    _starts: List[float] = field(default=None, repr=False, compare=False)
    _ends: List[float] = field(default=None, repr=False, compare=False)
    _n_cached: int = field(default=-1, repr=False, compare=False)

    def _refresh(self) -> None:
        if self._n_cached != len(self.windows):
            self.windows.sort(key=lambda w: w.start_s)
            self._starts = [w.start_s for w in self.windows]
            self._ends = [w.end_s for w in self.windows]
            self._n_cached = len(self.windows)

    def _index(self, t: float) -> int:
        """Index of the window containing t, or -1."""
        self._refresh()
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self._ends[i]:
            return i
        return -1

    def active(self, t: float) -> bool:
        return self._index(t) >= 0

    def remaining(self, t: float) -> float:
        """Remaining surplus seconds at time t (0 if not in a window)."""
        i = self._index(t)
        return self._ends[i] - t if i >= 0 else 0.0

    def next_window(self, t: float) -> Optional[Window]:
        self._index(t)  # refresh cache / sort
        i = bisect.bisect_right(self._starts, t)
        return self.windows[i] if i < len(self.windows) else None

    def overlaps(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        """Clipped ``(start, end)`` overlaps of surplus windows with
        ``[t0, t1]`` (disjoint, sorted) — what the signal accounting
        subtracts from a span's carbon/price integral
        (:func:`repro_torch.core.signals.grid_signal_integral`)."""
        if t1 <= t0:
            return []
        self._refresh()
        starts, ends = self._starts, self._ends
        lo = bisect.bisect_right(ends, t0)
        hi = bisect.bisect_left(starts, t1)
        out = []
        for k in range(lo, hi):
            a, b = max(t0, starts[k]), min(t1, ends[k])
            if b > a:
                out.append((a, b))
        return out

    def renewable_seconds(self, t0: float, t1: float) -> float:
        """Surplus seconds overlapping [t0, t1] — bisect over the sorted
        window-bounds cache, touching only windows that can overlap (the
        event engine integrates energy with this on every span)."""
        if t1 <= t0:
            return 0.0
        self._refresh()
        starts, ends = self._starts, self._ends
        lo = bisect.bisect_right(ends, t0)  # first window ending after t0
        hi = bisect.bisect_left(starts, t1)  # windows starting before t1
        tot = 0.0
        for k in range(lo, hi):
            tot += max(0.0, min(t1, ends[k]) - max(t0, starts[k]))
        return tot


@dataclass(frozen=True, eq=False)
class TraceStack:
    """Padded structure-of-arrays view over a fleet of :class:`SiteTrace`
    windows, for whole-fleet batched queries (the decide-path hot loop asks
    "remaining / next start / renewable seconds" for *every* site or job
    every tick; per-call bisect over Python lists was ~60k scalar calls per
    7-day run).

    ``starts``/``ends`` are ``(n_sites, K)`` float64 padded with ``+inf``
    (K = max window count + 1 so a searchsorted index can always be used to
    gather); ``cum[i, k]`` is the total duration of site ``i``'s windows
    ``0..k-1``.  Built once per run from static traces — a stack does NOT
    track later mutations of the underlying ``SiteTrace.windows``.
    """

    starts: np.ndarray  # (n, K) window starts, +inf padded
    ends: np.ndarray  # (n, K) window ends, +inf padded
    cum: np.ndarray  # (n, K + 1) cumulative window durations
    n_windows: np.ndarray  # (n,)

    @property
    def n_sites(self) -> int:
        return len(self.starts)

    # -- point-in-time fleet queries (scalar t -> (n_sites,) arrays) --------
    @cached_property
    def _rows(self) -> np.ndarray:
        return np.arange(len(self.starts))

    @cached_property
    def _edge_list(self) -> List[float]:
        """Sorted window edges: between two consecutive edges the per-site
        window index is constant, so its gathers are cached per epoch."""
        vals = np.unique(np.concatenate([self.starts.ravel(),
                                         self.ends.ravel()]))
        return [float(v) for v in vals if np.isfinite(v)]

    @cached_property
    def _epoch_cache(self) -> dict:
        return {}

    def _epoch(self, t: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(j, end[j-1], start[j]) per site for the epoch containing t."""
        key = bisect.bisect_right(self._edge_list, t)
        got = self._epoch_cache.get(key)
        if got is None:
            j = (self.starts <= t).sum(axis=1)  # == bisect_right per site
            r = self._rows
            got = self._epoch_cache[key] = (
                j, self.ends[r, np.maximum(j - 1, 0)], self.starts[r, j])
        return got

    def point(self, t: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One pass for the three per-site point queries the snapshot
        needs: ``(active, remaining, next_window_start)`` — matching
        ``SiteTrace.active`` / ``.remaining`` /
        ``.next_window().start_s`` (+inf when none) per site."""
        j, end, nxt = self._epoch(t)
        act = (j > 0) & (t < end)
        rem = np.where(act, end - t, 0.0)
        return act, rem, nxt

    def active(self, t: float) -> np.ndarray:
        """(n,) bool: site inside a surplus window at ``t``."""
        return self.point(t)[0]

    def remaining(self, t: float) -> np.ndarray:
        """(n,) surplus seconds left at ``t`` (0 outside windows)."""
        return self.point(t)[1]

    def next_window_start(self, t: float) -> np.ndarray:
        """(n,) start of the first window strictly after ``t`` (+inf when
        none)."""
        return self.point(t)[2]

    # -- batched span overlap ------------------------------------------------
    def _cover(self, sites: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Renewable seconds before time ``x`` at each site (cumulative
        window coverage; the searchsorted analogue of summing overlaps)."""
        j = (self.starts[sites] <= x[:, None]).sum(axis=1)
        jm = np.maximum(j - 1, 0)
        with np.errstate(invalid="ignore"):  # inf-inf on empty-trace pads
            open_tail = np.maximum(0.0, self.ends[sites, jm] - x)
            # window j-1 is the only one that can still be open at x
            dur = self.ends[sites, jm] - self.starts[sites, jm]
        return self.cum[sites, j] - np.where(j > 0,
                                             np.minimum(open_tail, dur), 0.0)

    def renewable_seconds(
        self, sites: np.ndarray, t0: np.ndarray, t1
    ) -> np.ndarray:
        """Batched ``SiteTrace.renewable_seconds``: surplus seconds
        overlapping ``[t0[k], t1]`` at ``sites[k]`` (``t1`` scalar or
        array).  Agrees with the scalar loop to float round-off (cumulative
        differences instead of per-window overlap sums)."""
        sites = np.asarray(sites)
        t0 = np.asarray(t0, dtype=np.float64)
        t1 = np.broadcast_to(np.asarray(t1, dtype=np.float64), t0.shape)
        return np.maximum(0.0, self._cover(sites, t1) - self._cover(sites, t0))


def stack_traces(traces: Sequence[SiteTrace]) -> TraceStack:
    """Build the padded :class:`TraceStack` for a fleet (sorts each site's
    windows exactly like ``SiteTrace._refresh``)."""
    sorted_wins = []
    for tr in traces:
        tr._refresh()
        sorted_wins.append(list(zip(tr._starts, tr._ends)))
    k = max((len(w) for w in sorted_wins), default=0) + 1
    n = len(traces)
    starts = np.full((n, k), np.inf)
    ends = np.full((n, k), np.inf)
    cum = np.zeros((n, k + 1))
    n_windows = np.zeros(n, dtype=np.int64)
    for i, wins in enumerate(sorted_wins):
        n_windows[i] = len(wins)
        for j, (a, b) in enumerate(wins):
            starts[i, j] = a
            ends[i, j] = b
        if wins:
            cum[i, 1:len(wins) + 1] = np.cumsum(
                [b - a for a, b in wins])
            cum[i, len(wins) + 1:] = cum[i, len(wins)]
    return TraceStack(starts, ends, cum, n_windows)


def generate_trace(
    n_sites: int = 5,
    days: int = 7,
    *,
    seed: int = 0,
    profile: Optional[TraceProfile] = None,
    **overrides,
) -> List[SiteTrace]:
    """CAISO-calibrated per-site renewable windows over `days`:
    one solar-curtailment window per day (midday, site-phase-shifted) plus
    an optional night wind-curtailment window.  The window process is
    parameterized by a :class:`TraceProfile` (scenario-composable); keyword
    overrides adjust individual fields."""
    import dataclasses as _dc

    prof = profile or TraceProfile()
    if overrides:
        prof = _dc.replace(prof, **overrides)
    mean_window_h, max_window_h, min_window_h = (
        prof.mean_window_h, prof.max_window_h, prof.min_window_h)
    p_window, noon_h, phase_spread_h = prof.p_window, prof.noon_h, prof.phase_spread_h
    p_wind, wind_mean_h = prof.p_wind, prof.wind_mean_h
    rng = np.random.default_rng(seed)
    # lognormal with mean mean_window_h: mu = ln(mean) - sigma^2/2
    sigma = 0.55
    mu = np.log(mean_window_h) - sigma ** 2 / 2
    mu_w = np.log(wind_mean_h) - sigma ** 2 / 2
    traces = []
    for s in range(n_sites):
        phase = (s / max(n_sites - 1, 1) - 0.5) * 2 * phase_spread_h  # hours
        wins: List[Window] = []
        for d in range(days):
            if rng.random() <= p_window:
                dur = float(np.clip(rng.lognormal(mu, sigma), min_window_h, max_window_h))
                center = d * 24 + noon_h + phase + rng.normal(0, 0.75)
                start = max(d * 24.0, center - dur / 2)
                end = min((d + 1) * 24.0, start + dur)
                if end - start >= min_window_h:
                    wins.append(Window(start * HOUR, end * HOUR))
            if rng.random() <= p_wind:
                dur = float(np.clip(rng.lognormal(mu_w, sigma), 1.0, 6.0))
                center = d * 24 + (2.5 + (phase if abs(phase) < 6 else 0) + rng.normal(0, 1.0)) % 24
                start = max(d * 24.0, center - dur / 2)
                end = min((d + 1) * 24.0, start + dur)
                if end - start >= 1.0 and not any(
                    max(w.start_s, start * HOUR) < min(w.end_s, end * HOUR) for w in wins
                ):
                    wins.append(Window(start * HOUR, end * HOUR))
        wins.sort(key=lambda w: w.start_s)
        traces.append(SiteTrace(s, wins))
    return traces


@dataclass
class Forecaster:
    """Noisy view of the remaining-window duration (§VI.H)."""

    traces: Sequence[SiteTrace]
    sigma_s: float = 900.0  # 15 min 1-sigma forecast error
    seed: int = 17

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # separate stream for next-window noise so adding/removing those
        # queries never perturbs the remaining-window noise sequence
        self._rng_next = np.random.default_rng(self.seed + 1)
        self._stack: Optional[TraceStack] = None

    def _trace_stack(self) -> TraceStack:
        """Padded window arrays for the batched queries (built lazily —
        traces must be static by first batched use)."""
        if self._stack is None:
            self._stack = stack_traces(self.traces)
        return self._stack

    def remaining(self, site: int, t: float) -> float:
        true = self.traces[site].remaining(t)
        if self.sigma_s <= 0:
            return true
        if true <= 0:
            return 0.0
        return max(0.0, true + float(self._rng.normal(0, self.sigma_s)))

    def next_window_start(self, site: int, t: float) -> float:
        """Forecast start of the next surplus window (inf if none); subject
        to the same sigma noise as remaining-window forecasts."""
        nw = self.traces[site].next_window(t)
        if nw is None:
            return float("inf")
        if self.sigma_s <= 0:
            return nw.start_s
        return max(t, nw.start_s + float(self._rng_next.normal(0, self.sigma_s)))

    def active(self, site: int, t: float) -> bool:
        return self.traces[site].active(t)

    # -- batched fleet queries (bit-identical noise streams) ----------------
    def _noisy_remaining(self, true: np.ndarray) -> np.ndarray:
        if self.sigma_s <= 0:
            return true
        mask = true > 0
        k = int(mask.sum())
        if k == 0:
            return true  # all zero: no draws, exactly the scalar behaviour
        noise = self._rng.normal(0, self.sigma_s, k)
        if k == len(true):
            return np.maximum(0.0, true + noise)
        out = np.zeros(len(true))
        out[mask] = np.maximum(0.0, true[mask] + noise)
        return out

    def _noisy_next_start(self, t: float, starts: np.ndarray) -> np.ndarray:
        if self.sigma_s <= 0:
            return starts
        mask = np.isfinite(starts)
        k = int(mask.sum())
        if k == 0:
            return starts  # all inf: no draws
        noise = self._rng_next.normal(0, self.sigma_s, k)
        if k == len(starts):
            return np.maximum(t, starts + noise)
        out = np.full(len(starts), np.inf)
        out[mask] = np.maximum(t, starts[mask] + noise)
        return out

    def snapshot_all(self, t: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(active, noisy remaining, noisy next-window start) for every
        site in one pass.  Per-site noise draws happen in site order from
        the same streams as the scalar calls (a batched ``normal(size=k)``
        consumes the generator identically to ``k`` scalar draws), so
        interleaving batched and scalar queries yields the same
        sequence."""
        act, rem, nxt = self._trace_stack().point(t)
        return act, self._noisy_remaining(rem), self._noisy_next_start(t, nxt)


def trace_stats(traces: Sequence[SiteTrace]) -> dict:
    durs = [w.duration_s / HOUR for tr in traces for w in tr.windows]
    total = sum(durs)
    return {
        "n_windows": len(durs),
        "mean_h": float(np.mean(durs)) if durs else 0.0,
        "min_h": float(np.min(durs)) if durs else 0.0,
        "max_h": float(np.max(durs)) if durs else 0.0,
        "total_surplus_h": total,
    }
