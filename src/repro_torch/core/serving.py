"""Streaming multi-site inference serving plane (paper §II "fluid,
geographically adaptive" execution; cf. Heron's renewable-aware request
routing in *AI Greenferencing* and XWind's cross-farm balancing).

The training side of the repo migrates long-running jobs between
renewable windows; this module adds the other half of the green-compute
story: a *request-driven* serving plane that shares the event spine, the
renewable traces, the grid signals and the WAN fabric with the training
simulator, so inference traffic and checkpoint transfers compete for the
same green windows and the same links.

Pieces:

  * :func:`generate_requests` — Poisson request arrivals per origin
    region with a diurnal rate curve (same ``_bump`` shape family as
    :func:`repro_torch.core.signals.generate_signals`), or trace-driven
    arrivals via ``ServingProfile.arrival_trace``.  Deterministic
    per-seed: each site draws from its own ``default_rng([seed, 151,
    site])`` stream, so enabling serving consumes **zero** draws from
    any existing stream (serving off ⇒ bit-identical training results).
  * :class:`ServingPlane` — per-site replica pools with FIFO batch
    queues: arrivals accumulate into per-(origin, model-class) batches
    closed by ``max_batch`` or ``batch_timeout_s``; closed batches are
    routed, ship their request bytes over the WAN as first-class flows
    (sharing :meth:`WanTopology.shared_rates` with migrations), queue at
    the chosen site and occupy a replica for a latency-table service
    time.  Per-request deadline accounting yields p50/p95/p99 latency
    and SLO-violation counts; grid energy drawn by serving is billed in
    gCO2 through the same signal integrals as training.
  * the :class:`Router` registry (``@register_router`` — mirroring the
    policy registry) with three built-ins: ``nearest`` (latency-greedy
    baseline), ``green-first`` (renewable-window-first with grid spill —
    the ``serve --green-route`` behaviour made dynamic) and
    ``carbon-slo`` (forecast-carbon-aware: sheds load away from sites
    ahead of forecast brownouts / carbon peaks while respecting the
    per-class latency SLO).

Event classes (all interleaved with the training engine's events):
request **arrival**, **batch-close** (timeout), **transfer completion**
(routed batch bytes arrive), **service completion**.  The plane exposes
``next_event_s()`` / ``process(t)`` to the next-event loop and
``flow_pairs()`` / ``rerate()`` to the shared WAN re-split, so a
brownout or a new checkpoint transfer slows in-flight request batches
exactly as it slows migrations (and vice versa).
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ledger import PowerLedger
from repro_torch.core.signals import GridSignals, _bump

HOUR = 3600.0
#: RNG stream tag for serving (jobs=+1, failures=+23, forecaster=+7,
#: WAN=+31, signals=131 — serving draws only from [seed, 151, ...]).
_RNG_TAG = 151

#: Router sentinel: "serve nowhere".  A router may return SHED instead
#: of a site id to drop the batch *before* it burns queue space or
#: service energy (``carbon-slo``'s proactive load-shedding ahead of
#: forecast blackouts).  The plane counts shed requests separately from
#: queue-overflow drops (``requests_shed`` vs ``requests_dropped``).
SHED = -2


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelClass:
    """One row of the per-model-class latency table.

    ``batch_s`` is the fixed per-batch service cost (prefill / weight
    paging), ``per_req_s`` the marginal per-request decode cost;
    ``slo_s`` the per-request latency SLO (deadline = arrival + slo),
    ``req_bytes`` the payload shipped over the WAN when routed off the
    origin region (prompt + KV/stream state).
    """

    name: str
    frac: float  # fraction of arrivals drawing this class
    batch_s: float  # fixed service cost per batch
    per_req_s: float  # marginal service cost per request
    slo_s: float  # latency SLO (deadline = t_arrival + slo_s)
    req_bytes: float  # WAN payload per request when routed remotely


DEFAULT_MODEL_CLASSES: Tuple[ModelClass, ...] = (
    ModelClass("chat-small", 0.70, 0.25, 0.05, 10.0, 0.5e6),
    ModelClass("chat-large", 0.25, 1.00, 0.20, 30.0, 2.0e6),
    ModelClass("embed-batch", 0.05, 2.50, 0.40, 120.0, 8.0e6),
)


@dataclass(frozen=True)
class ServingProfile:
    """Scenario-composable serving spec (all plain floats/tuples, frozen).

    ``req_per_s_per_site`` is the base Poisson rate per origin region;
    the realized rate follows a diurnal curve ``base * site_mult *
    (1 + diurnal_amplitude * bump(hour_of_day))`` peaking at
    ``peak_hour`` (evening by default — inference demand peaks exactly
    when the duck-curve carbon does).  ``arrival_trace`` switches to
    trace-driven arrivals: an explicit ``(t_s, origin_site)`` sequence
    replayed verbatim (model classes still drawn per-seed).
    """

    req_per_s_per_site: float = 0.0  # 0 and no trace => serving disabled
    diurnal_amplitude: float = 0.8
    peak_hour: float = 20.5
    peak_width_h: float = 3.5
    site_spread: float = 0.25  # per-site rate multiplier half-range
    model_classes: Tuple[ModelClass, ...] = DEFAULT_MODEL_CLASSES
    replicas_per_site: int = 2
    #: optional per-site replica override (len >= n_sites slices apply);
    #: a 0 entry marks the site *dead* — it serves nothing and, crucially,
    #: :func:`generate_requests` skips its arrival stream entirely so
    #: editing replica counts never shifts RNG draws for live sites
    replicas_by_site: Optional[Tuple[int, ...]] = None
    max_batch: int = 8
    batch_timeout_s: float = 2.0
    max_queue_batches: int = 16  # per-site FIFO bound; beyond => drop
    p_serve_kw: float = 0.35  # replica power draw while serving
    jitter_frac: float = 0.10  # lognormal sigma on service times
    arrival_trace: Optional[Tuple[Tuple[float, int], ...]] = None
    validate: bool = False  # audit conservation at every event boundary

    @property
    def enabled(self) -> bool:
        return self.req_per_s_per_site > 0.0 or bool(self.arrival_trace)

    def replicas_at(self, site: int) -> int:
        """Replica pool size for ``site`` (honouring the optional
        per-site override; sites past the override tuple fall back to
        ``replicas_per_site``)."""
        if (self.replicas_by_site is not None
                and 0 <= site < len(self.replicas_by_site)):
            return int(self.replicas_by_site[site])
        return int(self.replicas_per_site)


# ---------------------------------------------------------------------------
# Runtime records
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class Request:
    rid: int
    t_arrival_s: float
    origin: int
    cls: ModelClass
    deadline_s: float


@dataclass(slots=True)
class RequestBatch:
    """A formed batch: accumulates at the origin until closed (max size
    or timeout), is routed once, ships as one WAN flow when remote, and
    occupies one replica for one service span."""

    bid: int
    origin: int
    cls: ModelClass
    requests: List[Request]
    opened_s: float
    site: int = -1  # routed destination (-1 until routed)
    t_service_start_s: float = -1.0
    service_s: float = 0.0

    @property
    def nominal_service_s(self) -> float:
        """Jitter-free service estimate (what routers may assume without
        consuming RNG)."""
        return self.cls.batch_s + self.cls.per_req_s * len(self.requests)

    @property
    def wan_bits(self) -> float:
        return 8.0 * self.cls.req_bytes * len(self.requests)

    @property
    def earliest_deadline_s(self) -> float:
        return min(r.deadline_s for r in self.requests)


@dataclass(slots=True)
class ServeFlow:
    """An in-flight routed batch on the WAN (one flow per remote batch),
    sharing capacity with checkpoint transfers via the same
    ``shared_rates`` split — same lazy heap-invalidation protocol as
    ``SimJob`` transfers (``ver`` bumps on every re-rate)."""

    fid: int
    batch: RequestBatch
    src: int
    dst: int
    remaining_bits: float
    rate_bps: float = 0.0
    anchor_s: float = 0.0
    ver: int = 0


@dataclass(frozen=True, eq=False)
class ServingView:
    """Immutable per-site serving summary attached to
    ``ClusterState.serving`` — what routers read (alongside the site /
    forecast arrays) to place a batch."""

    replicas: np.ndarray  # (n,) int replica pool size
    busy_replicas: np.ndarray  # (n,) int replicas in service
    queue_batches: np.ndarray  # (n,) int batches waiting (excl. in service)
    queue_requests: np.ndarray  # (n,) int requests waiting
    est_wait_s: np.ndarray  # (n,) float est. queueing delay for a new batch
    max_queue_batches: int = 16
    p_serve_kw: float = 0.35

    def queue_full(self, site: int) -> bool:
        return int(self.queue_batches[site]) >= self.max_queue_batches


# ---------------------------------------------------------------------------
# Arrival process
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RequestEvents:
    """Columnar request stream — the chunked fast path's native format.

    Rows are sorted by ``(t_s, origin)`` (ties broken by draw order,
    matching the historical stable sort over Request tuples); ``cls_idx``
    indexes ``profile.model_classes``.  :func:`generate_requests` is a
    thin wrapper materializing per-row :class:`Request` objects from
    these arrays, so both paths consume the *same* draws."""

    t_s: np.ndarray  # (m,) float64 arrival times
    origin: np.ndarray  # (m,) int64 origin site
    cls_idx: np.ndarray  # (m,) int64 index into profile.model_classes
    deadline_s: np.ndarray  # (m,) float64 == t_s + slo_s[cls_idx]

    def __len__(self) -> int:
        return int(self.t_s.shape[0])


def generate_request_events(
    profile: ServingProfile, n_sites: int, days: int, *, seed: int = 0,
) -> RequestEvents:
    """Materialize the request stream as sorted columnar arrays.

    Poisson mode: per-site *thinned* non-homogeneous Poisson — draw at
    the per-site peak rate ``lam_max`` and accept each point with
    probability ``rate(t)/lam_max`` (exact for a piecewise-smooth rate
    curve).  Each site owns its stream ``default_rng([seed, 151, site])``
    so the merged process is deterministic per seed and independent of
    every other stream in the run; a site with zero replicas configured
    (``replicas_by_site``) is skipped *before* its rng is constructed,
    so dead sites consume no draws and editing replica counts never
    shifts the arrivals of live sites.  Trace mode replays
    ``profile.arrival_trace`` verbatim (class draws still per-seed).
    """
    horizon = days * 24 * HOUR
    classes = profile.model_classes
    fracs = np.array([c.frac for c in classes], dtype=np.float64)
    cum = np.cumsum(fracs / fracs.sum())
    slo = np.array([c.slo_s for c in classes], dtype=np.float64)

    t_parts: List[np.ndarray] = []
    o_parts: List[np.ndarray] = []
    u_parts: List[np.ndarray] = []
    if profile.arrival_trace is not None:
        rng = np.random.default_rng([seed, _RNG_TAG, 0])
        tr_t: List[float] = []
        tr_o: List[int] = []
        tr_u: List[float] = []
        for t, origin in profile.arrival_trace:
            if 0 <= origin < n_sites:
                tr_t.append(float(t))
                tr_o.append(int(origin))
                tr_u.append(float(rng.random()))
        if tr_t:
            t_parts.append(np.asarray(tr_t, dtype=np.float64))
            o_parts.append(np.asarray(tr_o, dtype=np.int64))
            u_parts.append(np.asarray(tr_u, dtype=np.float64))
    else:
        base = profile.req_per_s_per_site
        amp = profile.diurnal_amplitude
        spread = profile.site_spread
        for site in range(n_sites):
            if profile.replicas_at(site) == 0:
                continue  # dead site: no stream, no draws (see docstring)
            rng = np.random.default_rng([seed, _RNG_TAG, site])
            mult = 1.0 + spread * (2.0 * rng.random() - 1.0)
            lam_max = base * mult * (1.0 + max(amp, 0.0))
            if lam_max <= 0.0:
                continue
            n = rng.poisson(lam_max * horizon)
            ts = np.sort(rng.uniform(0.0, horizon, n))
            hod = (ts / HOUR) % 24.0
            rate = base * mult * (1.0 + amp * _bump(
                hod, profile.peak_hour, profile.peak_width_h))
            keep = rng.random(n) < rate / lam_max
            us = rng.random(n)
            t_parts.append(ts[keep])
            o_parts.append(np.full(int(keep.sum()), site, dtype=np.int64))
            u_parts.append(us[keep])
    if t_parts:
        t_all = np.concatenate(t_parts).astype(np.float64, copy=False)
        o_all = np.concatenate(o_parts).astype(np.int64, copy=False)
        u_all = np.concatenate(u_parts).astype(np.float64, copy=False)
    else:
        t_all = np.zeros(0, dtype=np.float64)
        o_all = np.zeros(0, dtype=np.int64)
        u_all = np.zeros(0, dtype=np.float64)
    # lexsort is stable per key, so equal (t, origin) rows keep draw
    # order — identical to the historical stable list.sort on (t, origin)
    order = np.lexsort((o_all, t_all))
    t_all, o_all, u_all = t_all[order], o_all[order], u_all[order]
    cls_idx = np.searchsorted(cum, u_all, side="left").astype(np.int64)
    deadline = t_all + slo[cls_idx]
    return RequestEvents(t_all, o_all, cls_idx, deadline)


def generate_requests(
    profile: ServingProfile, n_sites: int, days: int, *, seed: int = 0,
) -> List[Request]:
    """Materialize the request stream as time-sorted :class:`Request`
    objects (the scalar plane's format) — a row-wise view of
    :func:`generate_request_events`, bit-identical draws."""
    ev = generate_request_events(profile, n_sites, days, seed=seed)
    classes = profile.model_classes
    return [
        Request(rid, t, origin, classes[ci], dl)
        for rid, (t, origin, ci, dl) in enumerate(zip(
            ev.t_s.tolist(), ev.origin.tolist(),
            ev.cls_idx.tolist(), ev.deadline_s.tolist()))
    ]


# ---------------------------------------------------------------------------
# Router registry (mirrors the policy registry in core/orchestrator.py)
# ---------------------------------------------------------------------------

_ROUTERS: Dict[str, type] = {}
_ROUTER_ALIASES: Dict[str, str] = {}


def _norm(name: str) -> str:
    return name.lower().replace("_", "-")


def register_router(name: str, *, aliases: Tuple[str, ...] = ()):
    """Class decorator: add a Router under ``name`` (stored normalized).
    Unlike the policy registry, re-registering a taken name is an error —
    silently shadowing a built-in router would change routing results."""
    key = _norm(name)

    def deco(cls: type) -> type:
        if key in _ROUTERS and _ROUTERS[key] is not cls:
            raise ValueError(f"router {key!r} is already registered")
        cls.name = key
        _ROUTERS[key] = cls
        for a in aliases:
            _ROUTER_ALIASES[_norm(a)] = key
        return cls

    return deco


def make_router(name: str, **kw) -> "Router":
    key = _norm(name)
    key = _ROUTER_ALIASES.get(key, key)
    if key not in _ROUTERS:
        raise KeyError(
            f"unknown router {name!r}; available: "
            f"{', '.join(available_routers())}")
    return _ROUTERS[key](**kw)


def available_routers() -> List[str]:
    return sorted(_ROUTERS)


class Router:
    """Pluggable batch placement: ``route(batch, state) -> site``.

    ``state`` is a :class:`~repro_torch.core.state.ClusterState` carrying the
    serving view (``state.serving``), the site/forecast arrays and the
    WAN (``state.post_admission_bps`` for admission).  Return any site
    id; the plane guards unreachable / over-full choices (falls back to
    the origin queue, dropping only when that is full too)."""

    name = "router"

    def route(self, batch: RequestBatch, state) -> int:  # pragma: no cover
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------
    @staticmethod
    def _xfer_s(batch: RequestBatch, state, site: int) -> float:
        """Estimated WAN shipping time origin -> site for this batch
        (post-admission rate: the batch's own flow dilutes the links)."""
        if site == batch.origin:
            return 0.0
        rate = state.post_admission_bps(batch.origin, site)
        return batch.wan_bits / rate if rate > 0.0 else float("inf")

    @staticmethod
    def _candidates(batch: RequestBatch, state) -> List[int]:
        """Sites a batch could go to: queue not full, and (for remote
        sites) structurally reachable from the origin.  The origin is
        always a candidate — over-full origins are the plane's drop
        decision, not the router's."""
        sv = state.serving
        wan = state.wan
        out = [batch.origin]
        for s in range(state.n_sites):
            if s == batch.origin or sv.queue_full(s):
                continue
            if wan is not None and not wan.reachable(batch.origin, s):
                continue
            out.append(s)
        return out


@register_router("nearest", aliases=("latency", "local-first"))
class NearestRouter(Router):
    """Latency-greedy baseline: stay at the origin unless its queue is
    full (or clearly slower); otherwise the candidate minimizing
    transfer + queueing delay.  Carbon-blind by construction."""

    def route(self, batch: RequestBatch, state) -> int:
        sv = state.serving
        if not sv.queue_full(batch.origin):
            return batch.origin
        best, best_key = batch.origin, (float("inf"), batch.origin)
        for s in self._candidates(batch, state):
            delay = self._xfer_s(batch, state, s) + float(sv.est_wait_s[s])
            key = (delay, s)
            if key < best_key:
                best, best_key = s, key
        return best


@register_router("green-first", aliases=("green", "renewable-first"))
class GreenFirstRouter(Router):
    """The ``serve --green-route`` behaviour made dynamic: renewable
    sites first (longest remaining window wins), then sites whose
    forecast window opens within ``lookahead_s``, then grid spill by
    least queue (cleanest grid breaking ties).  ``min_gbps`` > 0 demands
    that post-admission bandwidth for remote placement."""

    def __init__(self, lookahead_s: float = 2 * HOUR, min_gbps: float = 0.0):
        self.lookahead_s = float(lookahead_s)
        self.min_gbps = float(min_gbps)

    def _admissible(self, batch: RequestBatch, state, site: int) -> bool:
        if site == batch.origin or self.min_gbps <= 0.0:
            return True
        return (state.post_admission_bps(batch.origin, site)
                >= self.min_gbps * 1e9)

    def route(self, batch: RequestBatch, state) -> int:
        sv = state.serving
        green = state.site_renewable
        window = state.site_window_s
        nxt = state.site_next_window_s
        cands = [s for s in self._candidates(batch, state)
                 if self._admissible(batch, state, s)]
        free_green = [s for s in cands if green[s]]
        if free_green:
            return max(free_green, key=lambda s: (
                float(window[s]), -float(sv.est_wait_s[s]), -s))
        soon = [s for s in cands
                if state.t < float(nxt[s]) <= state.t + self.lookahead_s]
        if soon:
            return min(soon, key=lambda s: (
                float(nxt[s]), float(sv.est_wait_s[s]), s))
        carbon = state.site_carbon
        return min(cands, key=lambda s: (
            float(sv.est_wait_s[s]), bool(not green[s]),
            float(carbon[s]), s))


@register_router("carbon-slo", aliases=("carbon", "slo-carbon"))
class CarbonSloRouter(Router):
    """Carbon-aware routing under the latency SLO: estimate, per
    candidate site, when the batch would start and finish service
    (transfer + queue + service), veto remote placements whose transfer
    window collides with a forecast WAN outage, and pick the minimum
    *forecast grid carbon* of the service span among SLO-feasible sites
    (falling back to earliest-completion when none is feasible) —
    shedding load away from sites heading into forecast brownouts or
    carbon peaks while respecting deadlines.

    Under an active fault plan the router additionally consults the
    realized fault calendar (``ForecastHorizon.site_repair_grid`` /
    ``next_fault_start_grid``): remote candidates whose endpoint is dark
    *now* or whose link is forecast to die before the payload lands are
    vetoed, and when ``proactive_shed`` is on and no candidate can meet
    the SLO budget at all, the batch is **shed** (:data:`SHED`) instead
    of burning queue space and service energy on a guaranteed miss.
    Both layers are inert on fault-free scenarios (the grids are None
    without a plan), so fault-free routing digits are untouched."""

    def __init__(self, slo_margin: float = 0.9, proactive_shed: bool = True):
        self.slo_margin = float(slo_margin)
        self.proactive_shed = bool(proactive_shed)

    def route(self, batch: RequestBatch, state) -> int:
        sv = state.serving
        fc = state.forecast
        t = state.t
        deadline = batch.earliest_deadline_s
        # feasibility budget: finish within slo_margin of the tightest
        # remaining deadline (absorbs jitter + estimate error)
        budget = t + self.slo_margin * max(deadline - t, 0.0)
        svc = batch.nominal_service_s
        # realized fault calendar — None without an active fault plan,
        # which keeps every fault-aware branch below inert on fault-free
        # scenarios (bit-identical routing to the pre-fault router)
        rep = fc.site_repair_grid(t) if fc is not None else None
        nf = fc.next_fault_start_grid(t) if rep is not None else None
        best, best_key = batch.origin, None
        for s in self._candidates(batch, state):
            xfer = self._xfer_s(batch, state, s)
            if not np.isfinite(xfer):
                continue
            if s != batch.origin:
                if rep is not None and (rep[s] > 0.0
                                        or rep[batch.origin] > 0.0):
                    continue  # endpoint blacked out right now
                # a forecast outage opening before the payload lands
                # would stall the batch mid-flight: shed away from it
                if fc is not None and fc.next_outage_start_s(
                        batch.origin, s, t) < t + xfer:
                    continue
                if nf is not None and nf[batch.origin, s] < t + xfer:
                    continue  # hard fault forecast to cut the link
            est_start = t + xfer + float(sv.est_wait_s[s])
            est_done = est_start + svc
            feasible = est_done <= budget
            if fc is not None:
                grams = fc.grid_carbon_g(s, est_start, est_done,
                                         sv.p_serve_kw)
            else:
                grams = 0.0
            key = (not feasible, grams, est_done, s)
            if best_key is None or key < best_key:
                best, best_key = s, key
        if (self.proactive_shed and rep is not None
                and best_key is not None and best_key[0]):
            # fault plan active and *no* candidate meets the SLO budget:
            # serving would burn energy on a guaranteed miss — shed
            return SHED
        return best


# ---------------------------------------------------------------------------
# The serving plane
# ---------------------------------------------------------------------------


class ServingPlane:
    """Per-site replica pools + batch queues + WAN request flows, driven
    by the next-event loop.

    Protocol with the engine (``ClusterSimulator._run_event``):

      * ``next_event_s()`` joins the engine's ``min()`` over event
        sources;
      * ``process(t)`` handles every due serving event (arrivals, batch
        closes, flow landings, service completions) and returns True
        when the WAN flow set changed (the engine then re-splits all
        rates, migrations included);
      * ``flow_pairs()`` / ``rerate(t, rates)`` let the engine's
        ``refresh_transfers`` treat request flows and checkpoint
        transfers as one flow set over :meth:`WanTopology.shared_rates`.

    All RNG use is confined to the ``[seed, 151, ...]`` streams (arrival
    generation at construction + one jitter stream at service start), so
    a run with serving disabled draws identically to one without the
    plane constructed at all.
    """

    def __init__(
        self,
        profile: ServingProfile,
        router: Router,
        *,
        n_sites: int,
        days: int,
        seed: int,
        topo,
        traces: Sequence,
        signals: Optional[GridSignals] = None,
        state_fn: Optional[Callable[[float], object]] = None,
        ledger: Optional[PowerLedger] = None,
    ):
        self.profile = profile
        self.router = router
        self.n_sites = n_sites
        self.topo = topo
        self.traces = traces
        self.signals = signals
        self._state_fn = state_fn
        # all serve-energy/request-carbon accounting posts to the shared
        # per-site PowerLedger (the simulator passes its own; a plane
        # constructed standalone gets a private one) — the postings
        # reproduce the historical `_bill` op for op
        self.ledger = ledger if ledger is not None else PowerLedger(
            n_sites, signals=signals, traces=traces)
        self.requests = generate_requests(profile, n_sites, days, seed=seed)
        self._ptr = 0
        self._jitter_rng = np.random.default_rng([seed, _RNG_TAG, 10 ** 6])
        # batch formation / queues / replicas
        self._open: Dict[Tuple[int, str], RequestBatch] = {}
        self._batches: Dict[int, RequestBatch] = {}
        self._next_bid = 0
        self._close_heap: List[Tuple[float, int]] = []
        self._queues: List[deque] = [deque() for _ in range(n_sites)]
        self._queued_reqs = np.zeros(n_sites, dtype=np.int64)
        self._pending_service_s = np.zeros(n_sites)
        self.replicas = np.array(
            [profile.replicas_at(s) for s in range(n_sites)], dtype=np.int64)
        self.busy = np.zeros(n_sites, dtype=np.int64)
        # WAN flows
        self._flows: Dict[int, ServeFlow] = {}
        self._next_fid = 0
        self._flow_heap: List[Tuple[float, int, int]] = []
        # in-service batches
        self._svc_heap: List[Tuple[float, int]] = []
        # counters / accounting
        self.arrived = 0
        self.served = 0
        self.dropped = 0
        self.shed = 0  # router-initiated proactive sheds (not overflow)
        self.slo_violations = 0
        self._timing: Optional[Dict[str, float]] = None
        self.latencies: List[float] = []
        self.queue_samples: List[int] = []
        self.site_served = np.zeros(n_sites, dtype=np.int64)
        self.site_routed = np.zeros(n_sites, dtype=np.int64)
        # Little's-law area integral: ∫ N_in_system dt
        self._in_system = 0
        self._area_t = 0.0
        self.area_request_s = 0.0

    # -- wiring --------------------------------------------------------------
    def bind(self, state_fn: Callable[[float], object]) -> None:
        """Attach the routing-state factory (the simulator's light,
        noise-free snapshot builder)."""
        self._state_fn = state_fn

    # -- event interface -----------------------------------------------------
    def next_event_s(self) -> float:
        """Earliest pending serving event (inf when idle)."""
        INF = float("inf")
        t = (self.requests[self._ptr].t_arrival_s
             if self._ptr < len(self.requests) else INF)
        while self._close_heap:
            tc, bid = self._close_heap[0]
            b = self._batches.get(bid)
            if b is not None and b.site < 0:
                t = min(t, tc)
                break
            heapq.heappop(self._close_heap)
        while self._flow_heap:
            tf, fid, ver = self._flow_heap[0]
            f = self._flows.get(fid)
            if f is not None and f.ver == ver:
                t = min(t, tf)
                break
            heapq.heappop(self._flow_heap)
        if self._svc_heap:
            t = min(t, self._svc_heap[0][0])
        return t

    def pending(self) -> bool:
        """Whether any request remains unprocessed (future arrivals or
        requests still in the system)."""
        return self._ptr < len(self.requests) or self._in_system > 0

    def enable_timing(self) -> Dict[str, float]:
        """Turn on the per-event-class wall breakdown (arrivals /
        batch-close / flow / service / router) and return the live
        accumulator dict — read it after the run."""
        if self._timing is None:
            self._timing = {"arrivals_s": 0.0, "batch_close_s": 0.0,
                            "flow_s": 0.0, "service_s": 0.0,
                            "router_s": 0.0}
        return self._timing

    def process(self, t: float, eps: float = 1e-6) -> bool:
        """Handle every serving event due at ``t``; returns True when the
        WAN flow set changed (caller must re-split shared rates)."""
        flows_dirty = False
        tm = self._timing
        if tm is not None:
            _t0 = time.perf_counter()
        # 1) arrivals -> batch formation (max-batch closes route now)
        while (self._ptr < len(self.requests)
               and self.requests[self._ptr].t_arrival_s <= t + eps):
            r = self.requests[self._ptr]
            self._ptr += 1
            self.arrived += 1
            self._bump_area(t)
            self._in_system += 1
            key = (r.origin, r.cls.name)
            b = self._open.get(key)
            if b is None:
                b = RequestBatch(self._next_bid, r.origin, r.cls, [r], t)
                self._next_bid += 1
                self._batches[b.bid] = b
                self._open[key] = b
                heapq.heappush(self._close_heap,
                               (t + self.profile.batch_timeout_s, b.bid))
            else:
                b.requests.append(r)
            if len(b.requests) >= self.profile.max_batch:
                self._open.pop(key, None)
                flows_dirty |= self._dispatch(b, t)
        if tm is not None:
            _t1 = time.perf_counter()
            tm["arrivals_s"] += _t1 - _t0
            _t0 = _t1
        # 2) batch-close timeouts
        while self._close_heap and self._close_heap[0][0] <= t + eps:
            _, bid = heapq.heappop(self._close_heap)
            b = self._batches.get(bid)
            if b is None or b.site >= 0:
                continue  # already dispatched at max size
            self._open.pop((b.origin, b.cls.name), None)
            flows_dirty |= self._dispatch(b, t)
        if tm is not None:
            _t1 = time.perf_counter()
            tm["batch_close_s"] += _t1 - _t0
            _t0 = _t1
        # 3) WAN flow landings: the routed batch reaches its queue
        while self._flow_heap and self._flow_heap[0][0] <= t + eps:
            _, fid, ver = heapq.heappop(self._flow_heap)
            f = self._flows.get(fid)
            if f is None or f.ver != ver:
                continue
            self._flush_flow(f, t)
            self._flows.pop(fid, None)
            flows_dirty = True
            self._enqueue(f.batch, f.dst, t)
        if tm is not None:
            _t1 = time.perf_counter()
            tm["flow_s"] += _t1 - _t0
            _t0 = _t1
        # 4) service completions
        while self._svc_heap and self._svc_heap[0][0] <= t + eps:
            _, bid = heapq.heappop(self._svc_heap)
            b = self._batches.pop(bid)
            self._complete_service(b, t)
        self._start_services(t)
        if tm is not None:
            tm["service_s"] += time.perf_counter() - _t0
        if self.profile.validate:
            self.audit()
        return flows_dirty

    # -- WAN flow interface (shared split with migrations) -------------------
    def flow_pairs(self) -> List[Tuple[int, int]]:
        """In-flight request flows as (src, dst) pairs, insertion-ordered
        (appended after migration pairs in the engine's shared split)."""
        return [(f.src, f.dst) for f in self._flows.values()]

    def rerate(self, t: float, rates: Sequence[float]) -> None:
        """Apply freshly split rates (aligned with :meth:`flow_pairs`):
        flush bits at the old rate, set the new one, requeue landings."""
        for f, r in zip(self._flows.values(), rates):
            self._flush_flow(f, t)
            f.rate_bps = float(r)
            f.ver += 1
            if f.rate_bps > 0.0:
                heapq.heappush(
                    self._flow_heap,
                    (t + f.remaining_bits / f.rate_bps, f.fid, f.ver))
            # rate 0 (browned out): lands when a re-rate revives the link

    def _flush_flow(self, f: ServeFlow, t: float) -> None:
        span = t - f.anchor_s
        if span > 0.0:
            f.remaining_bits = max(0.0, f.remaining_bits - f.rate_bps * span)
        f.anchor_s = t

    # -- internals -----------------------------------------------------------
    def _dispatch(self, batch: RequestBatch, t: float) -> bool:
        """Route a closed batch; returns True when a WAN flow started."""
        site = batch.origin
        if self._state_fn is not None:
            tm = self._timing
            if tm is not None:
                _t0 = time.perf_counter()
            try:
                site = int(self.router.route(batch, self._state_fn(t)))
            except Exception:
                site = batch.origin
            if tm is not None:
                tm["router_s"] += time.perf_counter() - _t0
        if site == SHED:
            self._shed(batch, t)
            return False
        if not 0 <= site < self.n_sites:
            site = batch.origin
        if site != batch.origin and not self.topo.reachable(batch.origin,
                                                            site):
            site = batch.origin
        batch.site = site
        self.site_routed[site] += len(batch.requests)
        if site == batch.origin:
            self._enqueue(batch, site, t)
            return False
        f = ServeFlow(self._next_fid, batch, batch.origin, site,
                      batch.wan_bits, anchor_s=t)
        self._next_fid += 1
        self._flows[f.fid] = f
        return True  # caller re-splits; rerate() queues the landing

    def _enqueue(self, batch: RequestBatch, site: int, t: float) -> None:
        q = self._queues[site]
        if len(q) >= self.profile.max_queue_batches:
            self._drop(batch, t)
            return
        q.append(batch)
        self._queued_reqs[site] += len(batch.requests)
        self._pending_service_s[site] += batch.nominal_service_s
        self.queue_samples.append(int(self._queued_reqs[site]))

    def _drop(self, batch: RequestBatch, t: float) -> None:
        n = len(batch.requests)
        self.dropped += n
        self._bump_area(t)
        self._in_system -= n
        self._batches.pop(batch.bid, None)

    def _shed(self, batch: RequestBatch, t: float) -> None:
        """Router-initiated proactive shed (carbon-slo ahead of forecast
        faults): the batch leaves the system unserved, counted apart
        from queue-overflow drops."""
        n = len(batch.requests)
        self.shed += n
        self._bump_area(t)
        self._in_system -= n
        self._batches.pop(batch.bid, None)

    def _start_services(self, t: float) -> None:
        for s in range(self.n_sites):
            q = self._queues[s]
            while q and self.busy[s] < self.replicas[s]:
                b = q.popleft()
                self._queued_reqs[s] -= len(b.requests)
                self._pending_service_s[s] -= b.nominal_service_s
                self.busy[s] += 1
                jitter = float(np.exp(self._jitter_rng.normal(
                    0.0, self.profile.jitter_frac)))
                b.service_s = b.nominal_service_s * jitter
                b.t_service_start_s = t
                heapq.heappush(self._svc_heap, (t + b.service_s, b.bid))

    def _complete_service(self, b: RequestBatch, t: float) -> None:
        s = b.site
        self.busy[s] -= 1
        n = len(b.requests)
        self.served += n
        self.site_served[s] += n
        self._bump_area(t)
        self._in_system -= n
        for r in b.requests:
            lat = t - r.t_arrival_s
            self.latencies.append(lat)
            if t > r.deadline_s:
                self.slo_violations += 1
        self._bill(s, b.t_service_start_s, t)

    # -- fault interface (core/faults.py replica-crash spans) ----------------
    def crash_replica(self, site: int, t: float) -> bool:
        """A replica-crash span opens at ``site``: capacity drops to zero
        until :meth:`repair_replica`.  In-service batches are interrupted
        (the energy already drawn is billed, the work is lost) and
        re-routed through the router like a fresh dispatch; queued
        batches re-drain the same way.  Requests never leave the system
        (``audit`` conservation holds across arbitrary crash sequences) —
        a batch the router sends back to the dead site simply waits in
        its queue for the repair.  Returns True when the WAN flow set
        changed (re-routes that cross the WAN)."""
        s = int(site)
        self.replicas[s] = 0
        flows_dirty = False
        interrupted: List[RequestBatch] = []
        keep: List[Tuple[float, int]] = []
        for td, bid in self._svc_heap:
            b = self._batches.get(bid)
            if b is not None and b.site == s:
                interrupted.append(b)
            else:
                keep.append((td, bid))
        if interrupted:
            heapq.heapify(keep)
            self._svc_heap = keep
        for b in interrupted:
            self.busy[s] -= 1
            self._bill(s, b.t_service_start_s, t)
            b.t_service_start_s = -1.0
            b.service_s = 0.0
            flows_dirty |= self._dispatch(b, t)
        q = self._queues[s]
        if q:
            drained = list(q)
            q.clear()
            for b in drained:
                self._queued_reqs[s] -= len(b.requests)
                self._pending_service_s[s] -= b.nominal_service_s
                flows_dirty |= self._dispatch(b, t)
        self._start_services(t)
        if self.profile.validate:
            self.audit()
        return flows_dirty

    def repair_replica(self, site: int, t: float) -> bool:
        """The crash span closes: capacity returns and whatever queued at
        the dead site during the span starts draining.  Never changes the
        WAN flow set (returns False)."""
        s = int(site)
        self.replicas[s] = self.profile.replicas_at(s)
        self._start_services(t)
        if self.profile.validate:
            self.audit()
        return False

    def _bill(self, site: int, t0: float, t1: float) -> None:
        """Bill the service span's energy: renewable overlap free, the
        grid remainder in kWh + gCO2 (posted through the shared
        PowerLedger — same exact signal integrals as the training
        accounting, separate accumulators, so training digits never
        move)."""
        self.ledger.post_serve(site, self.profile.p_serve_kw, t0, t1)

    # serve accounting lives in the ledger; these read-through views
    # keep the plane's historical attribute surface
    @property
    def serve_grid_kwh(self) -> float:
        return self.ledger.serve_grid_kwh

    @property
    def serve_renewable_kwh(self) -> float:
        return self.ledger.serve_renewable_kwh

    @property
    def request_gco2(self) -> float:
        return self.ledger.request_gco2

    @property
    def site_request_gco2(self) -> np.ndarray:
        return self.ledger.site_request_gco2

    def _bump_area(self, t: float) -> None:
        self.area_request_s += self._in_system * (t - self._area_t)
        self._area_t = t

    # -- views / invariants / stats ------------------------------------------
    def view(self) -> ServingView:
        """Immutable router-facing per-site summary (copies — the plane
        mutates its arrays in place)."""
        est = np.where(
            self.replicas > 0,
            self._pending_service_s / np.maximum(self.replicas, 1),
            float("inf"))
        return ServingView(
            replicas=self.replicas.copy(),
            busy_replicas=self.busy.copy(),
            queue_batches=np.array([len(q) for q in self._queues],
                                   dtype=np.int64),
            queue_requests=self._queued_reqs.copy(),
            est_wait_s=est,
            max_queue_batches=self.profile.max_queue_batches,
            p_serve_kw=self.profile.p_serve_kw,
        )

    @property
    def in_flight(self) -> int:
        """Requests in the system right now (open batches + WAN flows +
        queued + in service)."""
        return self._in_system

    def audit(self) -> None:
        """Conservation invariants (raise AssertionError on violation):
        arrived == served + dropped + shed + in-system, and the in-system
        count decomposes exactly into open/flying/queued/in-service
        requests."""
        assert self.arrived == (self.served + self.dropped + self.shed
                                + self._in_system), (
            self.arrived, self.served, self.dropped, self.shed,
            self._in_system)
        open_n = sum(len(b.requests) for b in self._open.values())
        fly_n = sum(len(f.batch.requests) for f in self._flows.values())
        q_n = int(self._queued_reqs.sum())
        svc_n = sum(len(self._batches[bid].requests)
                    for _, bid in self._svc_heap if bid in self._batches
                    and self._batches[bid].t_service_start_s >= 0.0)
        assert self._in_system == open_n + fly_n + q_n + svc_n, (
            self._in_system, open_n, fly_n, q_n, svc_n)

    def latency_percentiles(self) -> Tuple[float, float, float]:
        if not self.latencies:
            return (0.0, 0.0, 0.0)
        arr = np.asarray(self.latencies)
        p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
        return float(p50), float(p95), float(p99)

    def queue_depth_p95(self) -> float:
        if not self.queue_samples:
            return 0.0
        return float(np.percentile(np.asarray(self.queue_samples), 95.0))


__all__ = [
    "DEFAULT_MODEL_CLASSES", "CarbonSloRouter", "GreenFirstRouter",
    "ModelClass", "NearestRouter", "Request", "RequestBatch",
    "RequestEvents", "Router", "SHED", "ServeFlow", "ServingPlane",
    "ServingProfile", "ServingView", "available_routers",
    "generate_request_events", "generate_requests", "make_router",
    "register_router",
]
