"""Chunked vectorized serving fast path: the port's copy of
``repro/core/serving_kernels.py``, the serving plane's default engine.

Numpy host code, as in the JAX package: the "router kernels" below are
scalar mirrors of the routers, not device kernels.

The per-event scalar plane in :mod:`repro_torch.core.serving` pays three taxes
per request: one engine iteration (a 12-way ``min()`` over event
sources) per arrival/close/service event, one full
:class:`~repro_torch.core.state.ClusterState` construction per batch dispatch
(``ClusterSimulator._serving_state``), and per-request ``Request``
object traffic.  At the paper's "millions of users" rates those taxes
dominate the whole simulation.  This module removes all three while
keeping every observable **bit-identical**:

* **pre-materialized arrival arrays** —
  :func:`repro_torch.core.serving.generate_request_events` yields the sorted
  columnar ``(t, origin, cls, deadline)`` stream (same draws as the
  scalar ``generate_requests``); the plane scans plain python lists of
  it instead of allocating a ``Request`` per row;
* **span processing** — :meth:`ChunkedServingPlane.process_span`
  advances the plane through *every* serving event strictly before the
  next orchestrator-relevant event in one call, so the engine performs
  one iteration per span instead of one per request; within a span,
  runs of pure arrivals (and isolated batch-close / service events) are
  handled by inlined light paths that skip the generic event mirror;
* **router kernels** — scalar-router mirrors that read the plane's live
  arrays, the epoch-cached :meth:`TraceStack.point` /
  :meth:`ForecastHorizon.carbon_grid` views and a precomputed
  reachability matrix directly, instead of building a ``ClusterState``
  per batch.  The carbon-slo kernel scores its candidate site axis in
  one :meth:`ForecastHorizon.grid_carbon_g_rows` call (the documented
  elementwise mirror of ``grid_carbon_g``).  The scalar routers stay
  registered untouched — they are the parity oracles.

Exactness invariants (enforced by the parity suites in
``tests/test_serving_fastpath.py`` and ``tests/test_torch_serving_fastpath.py``):

* the jitter stream draws ``normal(0, σ, size=k)`` blocks, bit-identical
  to k sequential scalar draws, and applies ``np.exp`` per element on
  the indexed ``float64`` scalar (same libm path as the scalar plane);
* queue/batch float accounting uses python floats whose add/sub/mul
  sequence mirrors the scalar plane's numpy-scalar ops exactly (IEEE
  double either way);
* service starts happen in ascending site order within an event (the
  scalar ``_start_services`` scan), so the jitter stream is consumed in
  the identical order; the inlined light paths only fire when an event
  is strictly clear (by the engine's ``EPS``) of every other event
  source, so coalescing behaviour matches the scalar ``process``;
* a dispatch that opens a WAN flow ends the span immediately — the
  engine re-splits ``shared_rates`` over migrations + serve flows
  exactly as the per-event path does.

Billing still posts per service span through the shared
:class:`~repro_torch.core.ledger.PowerLedger` (identical call sequence), so
energy/carbon digits match to the bit.
"""
from __future__ import annotations

import bisect
import heapq
import math
import time
from collections import deque
from itertools import repeat
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ledger import PowerLedger
from repro_torch.core.serving import (
    SHED, CarbonSloRouter, GreenFirstRouter, NearestRouter, Router,
    ServingProfile, ServingView, _RNG_TAG, generate_request_events,
)
from repro_torch.core.signals import GridSignals
from repro_torch.core.traces import stack_traces

INF = float("inf")

#: `_dispatch` outcome codes (beyond an enqueued site id >= 0)
_FLOW = -1  # a WAN flow started: the caller must re-split shared rates
_GONE = -2  # dropped or shed: the batch left the system


class _Batch:
    """Chunked-plane batch: request *indices* into the arrival arrays
    instead of Request objects (latency/SLO resolve from the arrays at
    completion time)."""

    __slots__ = ("bid", "origin", "ci", "idx", "opened_s", "site",
                 "t_service_start_s", "service_s", "nominal")

    def __init__(self, bid: int, origin: int, ci: int, idx: List[int],
                 opened_s: float):
        self.bid = bid
        self.origin = origin
        self.ci = ci
        self.idx = idx
        self.opened_s = opened_s
        self.site = -1
        self.t_service_start_s = -1.0
        self.service_s = 0.0
        self.nominal = 0.0  # set at dispatch (len is frozen from there)


class _Flow:
    """In-flight routed batch on the WAN — same lazy-heap protocol as
    the scalar :class:`~repro_torch.core.serving.ServeFlow`."""

    __slots__ = ("fid", "batch", "src", "dst", "remaining_bits",
                 "rate_bps", "anchor_s", "ver")

    def __init__(self, fid: int, batch: _Batch, src: int, dst: int,
                 bits: float, anchor_s: float):
        self.fid = fid
        self.batch = batch
        self.src = src
        self.dst = dst
        self.remaining_bits = bits
        self.rate_bps = 0.0
        self.anchor_s = anchor_s
        self.ver = 0


# ---------------------------------------------------------------------------
# Router kernels — scalar-router mirrors over plane-local state
# ---------------------------------------------------------------------------


class _Kernel:
    """Base: candidate enumeration + lazy post-admission transfer
    estimates, mirroring ``Router._candidates`` / ``Router._xfer_s``
    over the plane's live arrays (no ClusterState)."""

    def __init__(self, plane: "ChunkedServingPlane"):
        self.plane = plane

    def _cands(self, batch: _Batch) -> List[int]:
        p = self.plane
        origin = batch.origin
        reach = p._reach[origin]
        max_q = p._max_q
        queues = p._queues
        out = [origin]
        for s in range(p.n_sites):
            if s == origin or len(queues[s]) >= max_q:
                continue
            if not reach[s]:
                continue
            out.append(s)
        return out

    def route(self, batch: _Batch, t: float) -> int:  # pragma: no cover
        raise NotImplementedError


class NearestKernel(_Kernel):
    """Mirror of :class:`~repro_torch.core.serving.NearestRouter`."""

    def route(self, batch: _Batch, t: float) -> int:
        p = self.plane
        origin = batch.origin
        if len(p._queues[origin]) < p._max_q:
            return origin
        bits = p._cls_bits[batch.ci] * len(batch.idx)
        flows: Optional[list] = None
        best, best_key = origin, (INF, origin)
        for s in self._cands(batch):
            if s == origin:
                xfer = 0.0
            else:
                if flows is None:
                    flows = p._all_flow_pairs()
                rate = p.topo.post_admission_rate(origin, s, flows, t)
                xfer = bits / rate if rate > 0.0 else INF
            delay = xfer + p._est_wait(s)
            key = (delay, s)
            if key < best_key:
                best, best_key = s, key
        return best


class GreenFirstKernel(_Kernel):
    """Mirror of :class:`~repro_torch.core.serving.GreenFirstRouter` reading
    the epoch-cached trace stack directly."""

    def __init__(self, plane: "ChunkedServingPlane", lookahead_s: float,
                 min_gbps: float):
        super().__init__(plane)
        self.lookahead_s = float(lookahead_s)
        self.min_gbps = float(min_gbps)

    def route(self, batch: _Batch, t: float) -> int:
        p = self.plane
        origin = batch.origin
        green, window, nxt = p._stack.point(t)
        cands = self._cands(batch)
        if self.min_gbps > 0.0:
            bits_floor = self.min_gbps * 1e9
            flows = p._all_flow_pairs()
            cands = [s for s in cands if s == origin
                     or p.topo.post_admission_rate(origin, s, flows, t)
                     >= bits_floor]
        free_green = [s for s in cands if green[s]]
        if free_green:
            return max(free_green, key=lambda s: (
                float(window[s]), -p._est_wait(s), -s))
        soon = [s for s in cands
                if t < float(nxt[s]) <= t + self.lookahead_s]
        if soon:
            return min(soon, key=lambda s: (
                float(nxt[s]), p._est_wait(s), s))
        carbon = p._carbon(t)
        return min(cands, key=lambda s: (
            p._est_wait(s), bool(not green[s]), float(carbon[s]), s))


class CarbonSloKernel(_Kernel):
    """Mirror of :class:`~repro_torch.core.serving.CarbonSloRouter`, scoring
    the surviving candidate axis in one ``grid_carbon_g_rows`` call
    (the elementwise mirror of the scalar per-site query), fault vetoes
    and proactive shed included."""

    def __init__(self, plane: "ChunkedServingPlane", slo_margin: float,
                 proactive_shed: bool):
        super().__init__(plane)
        self.slo_margin = float(slo_margin)
        self.proactive_shed = bool(proactive_shed)

    def route(self, batch: _Batch, t: float) -> int:
        p = self.plane
        fc = p._forecast
        origin = batch.origin
        adl = p._adl
        deadline = min(adl[i] for i in batch.idx)
        budget = t + self.slo_margin * max(deadline - t, 0.0)
        svc = batch.nominal
        bits = p._cls_bits[batch.ci] * len(batch.idx)
        rep = fc.site_repair_grid(t) if fc is not None else None
        nf = fc.next_fault_start_grid(t) if rep is not None else None
        flows: Optional[list] = None
        cand_s: List[int] = []
        cand_start: List[float] = []
        for s in self._cands(batch):
            if s == origin:
                xfer = 0.0
            else:
                if flows is None:
                    flows = p._all_flow_pairs()
                rate = p.topo.post_admission_rate(origin, s, flows, t)
                xfer = bits / rate if rate > 0.0 else INF
                if xfer == INF:
                    continue
                if rep is not None and (rep[s] > 0.0 or rep[origin] > 0.0):
                    continue  # endpoint blacked out right now
                if fc is not None and fc.next_outage_start_s(
                        origin, s, t) < t + xfer:
                    continue
                if nf is not None and nf[origin, s] < t + xfer:
                    continue  # hard fault forecast to cut the link
            cand_s.append(s)
            cand_start.append(t + xfer + p._est_wait(s))
        best, best_key = origin, None
        if cand_s:
            # ``grid_carbon_g_rows`` is the documented elementwise mirror
            # of ``grid_carbon_g`` but carries fixed numpy broadcast
            # overhead (~0.2 ms) that only amortizes over wide candidate
            # axes; below the threshold the scalar integral per candidate
            # is ~5x cheaper and trivially bit-identical (same function
            # the oracle router calls)
            if fc is None:
                grams: Sequence[float] = [0.0] * len(cand_s)
            elif len(cand_s) >= 16:
                starts = np.asarray(cand_start, dtype=np.float64)
                grams = fc.grid_carbon_g_rows(
                    np.asarray(cand_s, dtype=np.int64), starts,
                    starts + svc, p._p_kw)
            else:
                grams = [fc.grid_carbon_g(s, st, st + svc, p._p_kw)
                         for s, st in zip(cand_s, cand_start)]
            for k, s in enumerate(cand_s):
                est_start = cand_start[k]
                est_done = est_start + svc
                key = (not (est_done <= budget), float(grams[k]),
                       est_done, s)
                if best_key is None or key < best_key:
                    best, best_key = s, key
        if (self.proactive_shed and rep is not None
                and best_key is not None and best_key[0]):
            return SHED
        return best


def make_kernel(router: Router,
                plane: "ChunkedServingPlane") -> Optional[_Kernel]:
    """The kernel mirror for ``router``, or None when the router has no
    mirror (custom routers fall back to the per-event scalar plane)."""
    if type(router) is NearestRouter:
        return NearestKernel(plane)
    if type(router) is GreenFirstRouter:
        return GreenFirstKernel(plane, router.lookahead_s, router.min_gbps)
    if type(router) is CarbonSloRouter:
        return CarbonSloKernel(plane, router.slo_margin,
                               router.proactive_shed)
    return None


def supports_router(router: Router) -> bool:
    """Whether the chunked plane has a bit-exact kernel for ``router``
    (exact built-in types only — subclasses may override ``route``)."""
    return type(router) in (NearestRouter, GreenFirstRouter,
                            CarbonSloRouter)


# ---------------------------------------------------------------------------
# The chunked plane
# ---------------------------------------------------------------------------


class ChunkedServingPlane:
    """Drop-in :class:`~repro_torch.core.serving.ServingPlane` replacement
    exposing the same engine protocol (``next_event_s`` / ``process`` /
    ``pending`` / ``flow_pairs`` / ``rerate`` / ``crash_replica`` /
    ``repair_replica`` / counters) plus :meth:`process_span`, the
    span-advance entry point the engine's fast path calls.

    The simulator wires run context post-construction via
    :meth:`bind_context` (forecast horizon + live migration pairs);
    until then the plane routes everything to the origin, mirroring a
    scalar plane with no ``state_fn`` bound.
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
        ledger: Optional[PowerLedger] = None,
    ):
        self.profile = profile
        self.router = router  # config source; the kernel mirrors it
        self.n_sites = n_sites
        self.topo = topo
        self.traces = traces
        self.signals = signals
        self.ledger = ledger if ledger is not None else PowerLedger(
            n_sites, signals=signals, traces=traces)
        kern = make_kernel(router, self)
        if kern is None:
            raise ValueError(
                f"no chunked kernel for router {router.name!r}; use the "
                "per-event plane (serving_engine='event')")
        self._kernel = kern
        self._bound = False  # bind_context enables routing (like bind())
        self._forecast = None
        self._mig_pairs_fn: Callable[[], List[Tuple[int, int]]] = list
        self._stack = stack_traces(traces)
        self._reach = [
            [s == o or bool(topo.reachable(o, s)) for s in range(n_sites)]
            for o in range(n_sites)]
        self._zero_carbon = np.zeros(n_sites)
        # columnar arrivals (+ python-list mirrors for the hot scan)
        self.events = generate_request_events(profile, n_sites, days,
                                              seed=seed)
        self._at: List[float] = self.events.t_s.tolist()
        self._ao: List[int] = self.events.origin.tolist()
        self._ac: List[int] = self.events.cls_idx.tolist()
        self._adl: List[float] = self.events.deadline_s.tolist()
        self._n_arr = len(self._at)
        self._ptr = 0
        # per-class scalars
        classes = profile.model_classes
        self._cls_batch_s = [float(c.batch_s) for c in classes]
        self._cls_per_req_s = [float(c.per_req_s) for c in classes]
        self._cls_bits = [8.0 * float(c.req_bytes) for c in classes]
        self._max_batch = int(profile.max_batch)
        self._timeout = float(profile.batch_timeout_s)
        self._max_q = int(profile.max_queue_batches)
        self._p_kw = float(profile.p_serve_kw)
        # jitter: block-drawn (bit-identical to sequential scalar draws)
        self._jrng = np.random.default_rng([seed, _RNG_TAG, 10 ** 6])
        self._jit_buf: Optional[List[float]] = None
        self._jit_i = 0
        self._sigma = float(profile.jitter_frac)
        # free-flow merge support (origin-only routing regime)
        self._ncls = len(classes)
        self._ff_router = type(kern) is NearestKernel
        self._ffs: Optional[list] = None
        self._ff_oc: Optional[List[Tuple[int, int]]] = None
        # batch formation / queues / replicas (python-native hot state)
        self._open: Dict[Tuple[int, int], _Batch] = {}
        self._batches: Dict[int, _Batch] = {}
        self._next_bid = 0
        self._close_heap: List[Tuple[float, int]] = []
        self._queues: List[deque] = [deque() for _ in range(n_sites)]
        self._qreqs: List[int] = [0] * n_sites
        self._pend: List[float] = [0.0] * n_sites
        self._repl: List[int] = [profile.replicas_at(s)
                                 for s in range(n_sites)]
        self._busy: List[int] = [0] * n_sites
        # WAN flows
        self._flows: Dict[int, _Flow] = {}
        self._next_fid = 0
        self._flow_heap: List[Tuple[float, int, int]] = []
        self._svc_heap: List[Tuple[float, int]] = []
        # counters / accounting
        self.arrived = 0
        self.served = 0
        self.dropped = 0
        self.shed = 0
        self.slo_violations = 0
        self.latencies: List[float] = []
        self.queue_samples: List[int] = []
        self._site_served: List[int] = [0] * n_sites
        self._site_routed: List[int] = [0] * n_sites
        self._in_system = 0
        self._area_t = 0.0
        self.area_request_s = 0.0
        self._timing: Optional[Dict[str, float]] = None
        # deferred service billing: merged spans buffer their bills and
        # the ledger drains them (via the registered sync hook) before
        # any other posting or audit, so the global add order onto the
        # shared accumulators is exactly the per-event order
        self._bill_site: List[int] = []
        self._bill_t0: List[float] = []
        self._bill_t1: List[float] = []
        self.ledger._serve_sync = self._flush_bills

    # -- wiring --------------------------------------------------------------
    def bind_context(self, *, forecast=None,
                     mig_pairs_fn: Optional[Callable[
                         [], List[Tuple[int, int]]]] = None) -> None:
        """Attach run context: the forecast horizon (carbon / outage /
        fault grids for the kernels) and a live in-flight-migration
        pair provider (post-admission estimates share the WAN split
        with checkpoint transfers).  Enables routing."""
        self._forecast = forecast
        if mig_pairs_fn is not None:
            self._mig_pairs_fn = mig_pairs_fn
        self._bound = True

    def enable_timing(self) -> Dict[str, float]:
        """Turn on the per-event-class wall breakdown (same keys as the
        scalar plane) and return the live accumulator dict."""
        if self._timing is None:
            self._timing = {"arrivals_s": 0.0, "batch_close_s": 0.0,
                            "flow_s": 0.0, "service_s": 0.0,
                            "router_s": 0.0, "chunk_s": 0.0}
        return self._timing

    # -- kernel-facing helpers -----------------------------------------------
    def _est_wait(self, s: int) -> float:
        r = self._repl[s]
        return self._pend[s] / r if r > 0 else INF

    def _carbon(self, t: float) -> np.ndarray:
        fc = self._forecast
        return fc.carbon_grid(t) if fc is not None else self._zero_carbon

    def _all_flow_pairs(self) -> List[Tuple[int, int]]:
        """Migration pairs + serve-flow pairs, the exact flow set the
        scalar ``_serving_state`` snapshot would carry."""
        pairs = list(self._mig_pairs_fn())
        for f in self._flows.values():
            pairs.append((f.src, f.dst))
        return pairs

    # -- event interface -----------------------------------------------------
    def _heap_min(self) -> float:
        """Earliest valid close/flow/service event (lazy invalidation,
        mirror of the scalar ``next_event_s`` heap peeks)."""
        m = INF
        ch = self._close_heap
        while ch:
            tc, bid = ch[0]
            b = self._batches.get(bid)
            if b is not None and b.site < 0:
                m = tc
                break
            heapq.heappop(ch)
        fh = self._flow_heap
        while fh:
            tf, fid, ver = fh[0]
            f = self._flows.get(fid)
            if f is not None and f.ver == ver:
                if tf < m:
                    m = tf
                break
            heapq.heappop(fh)
        sh = self._svc_heap
        if sh and sh[0][0] < m:
            m = sh[0][0]
        return m

    def next_event_s(self) -> float:
        t = self._at[self._ptr] if self._ptr < self._n_arr else INF
        hm = self._heap_min()
        return hm if hm < t else t

    def pending(self) -> bool:
        return self._ptr < self._n_arr or self._in_system > 0

    def process(self, t: float, eps: float = 1e-6) -> bool:
        """Generic event mirror of the scalar ``process`` (arrivals →
        closes → flow landings → service completions → starts).  The
        engine calls this on the slow path (serving events coalescing
        with engine events); :meth:`process_span` calls it for events
        not strictly clear of each other."""
        flows_dirty = False
        tm = self._timing
        if tm is not None:
            _t0 = time.perf_counter()
        # 1) arrivals -> batch formation (max-batch closes route now)
        at = self._at
        while self._ptr < self._n_arr and at[self._ptr] <= t + eps:
            i = self._ptr
            self._ptr += 1
            self.arrived += 1
            self._bump_area(t)
            self._in_system += 1
            o = self._ao[i]
            key = (o, self._ac[i])
            b = self._open.get(key)
            if b is None:
                b = _Batch(self._next_bid, o, key[1], [i], t)
                self._next_bid += 1
                self._batches[b.bid] = b
                self._open[key] = b
                heapq.heappush(self._close_heap,
                               (t + self._timeout, b.bid))
            else:
                b.idx.append(i)
            if len(b.idx) >= self._max_batch:
                self._open.pop(key, None)
                flows_dirty |= self._dispatch(b, t) == _FLOW
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
            self._open.pop((b.origin, b.ci), None)
            flows_dirty |= self._dispatch(b, t) == _FLOW
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

    def process_span(self, limit: float, t_end: float,
                     eps: float = 1e-6) -> Tuple[int, float, bool]:
        """Advance through every serving event with ``t < limit`` (and
        ``t <= t_end``), stopping early when a dispatch opens a WAN
        flow.  Returns ``(n_events, t_last, flows_dirty)`` where
        ``n_events`` counts distinct event times (engine iterations the
        per-event path would have spent) and ``t_last`` is the time of
        the last processed event.

        The caller (the engine) passes ``limit = t_other - EPS`` where
        ``t_other`` is its earliest non-serving event, so any serving
        event that could coalesce with an engine event is left for the
        engine's normal per-event path — coalescing semantics are
        untouched.
        """
        n_ev = 0
        t_last = 0.0
        at = self._at
        n_arr = self._n_arr
        validate = self.profile.validate
        tm = self._timing
        # free-flow merge: when routing is origin-only (nearest kernel,
        # or unbound) and no WAN flow is in flight, the whole chunk
        # collapses to a deterministic arrivals/closes/completions merge
        try_ff = ((self._ff_router or not self._bound) and not validate)
        while True:
            if try_ff and not self._flows:
                if self._flow_heap:
                    self._flow_heap.clear()  # flows empty: all dead
                if tm is not None:
                    _tf = time.perf_counter()
                nf, tl = self._ff_merge(limit, t_end, eps)
                if tm is not None:
                    tm["chunk_s"] += time.perf_counter() - _tf
                if nf:
                    n_ev += nf
                    t_last = tl
                else:
                    try_ff = False  # zero progress: stop thrashing
            hmin = self._heap_min()
            ptr = self._ptr
            # -- inlined arrival runs: pure arrivals strictly clear (by
            # eps) of every heap event take the light path
            if ptr < n_arr:
                ta = at[ptr]
                if ta + eps < hmin and ta < limit and ta <= t_end:
                    if tm is not None:
                        _t0 = time.perf_counter()
                    r = self._arrival_run(hmin, limit, t_end, eps)
                    n_run, t_last2, dirty = r
                    if tm is not None:
                        tm["arrivals_s"] += time.perf_counter() - _t0
                    if n_run:
                        n_ev += n_run
                        t_last = t_last2
                        if validate:
                            self.audit()
                        if dirty:
                            return n_ev, t_last, True
                        continue
            # -- next event (arrival exhausted the light path: it ties
            # with a heap event, or a heap event comes first)
            ptr = self._ptr
            tn = at[ptr] if ptr < n_arr else INF
            if hmin < tn:
                tn = hmin
            if tn >= limit or tn > t_end:
                return n_ev, t_last, False
            # -- inlined isolated close / service completions
            code = self._try_inline_event(tn, eps)
            if code >= 0:
                n_ev += 1
                t_last = tn
                if validate:
                    self.audit()
                if code == 1:
                    return n_ev, t_last, True
                continue
            # -- generic mirror for coalescing events
            n_ev += 1
            t_last = tn
            if self.process(tn, eps):
                return n_ev, t_last, True

    def _arrival_run(self, hmin: float, limit: float, t_end: float,
                     eps: float) -> Tuple[int, float, bool]:
        """Consume consecutive arrival events while each is strictly
        clear of every heap event.  Returns (events, t_last, dirty);
        maintains ``hmin`` across close/service pushes it causes."""
        at, ao, ac = self._at, self._ao, self._ac
        n_arr = self._n_arr
        openb = self._open
        timeout = self._timeout
        max_batch = self._max_batch
        n_ev = 0
        t_last = 0.0
        ptr = self._ptr
        while ptr < n_arr:
            ta = at[ptr]
            if not (ta + eps < hmin and ta < limit and ta <= t_end):
                break
            # one event time: consume every arrival within eps of it
            # (all are clear of heap events since ta + eps < hmin)
            touched: Optional[List[int]] = None
            dirty = False
            while ptr < n_arr and at[ptr] <= ta + eps:
                i = ptr
                ptr += 1
                self.arrived += 1
                # _bump_area(ta): after the first bump the gap is 0
                self.area_request_s += self._in_system * (ta - self._area_t)
                self._area_t = ta
                self._in_system += 1
                o = ao[i]
                key = (o, ac[i])
                b = openb.get(key)
                if b is None:
                    b = _Batch(self._next_bid, o, key[1], [i], ta)
                    self._next_bid += 1
                    self._batches[b.bid] = b
                    openb[key] = b
                    tc = ta + timeout
                    heapq.heappush(self._close_heap, (tc, b.bid))
                    if tc < hmin:
                        hmin = tc
                else:
                    b.idx.append(i)
                if len(b.idx) >= max_batch:
                    openb.pop(key, None)
                    r = self._dispatch(b, ta)
                    if r == _FLOW:
                        dirty = True
                    elif r >= 0:
                        if touched is None:
                            touched = [r]
                        elif r not in touched:
                            touched.append(r)
            self._ptr = ptr
            n_ev += 1
            t_last = ta
            if touched is not None:
                # ascending site order = the scalar _start_services scan
                for s in sorted(touched):
                    td = self._start_site(s, ta)
                    if td < hmin:
                        hmin = td
            if dirty:
                return n_ev, t_last, True
        self._ptr = ptr
        return n_ev, t_last, False

    def _try_inline_event(self, tn: float, eps: float) -> int:
        """Handle an isolated batch-close or service completion at
        ``tn`` without the generic mirror.  Returns -1 when the event
        is not isolated (caller must use :meth:`process`), 0 when
        handled, 1 when handled and the WAN flow set changed."""
        ta = self._at[self._ptr] if self._ptr < self._n_arr else INF
        if ta <= tn + eps:
            return -1
        ch = self._close_heap
        fh = self._flow_heap
        sh = self._svc_heap
        tc = ch[0][0] if ch else INF  # tops are valid (heap_min cleaned)
        tf = fh[0][0] if fh else INF
        ts = sh[0][0] if sh else INF
        if tf <= tn + eps:
            return -1  # flow landings stay on the generic path (rare)
        if tc == tn:
            # isolated close: no second close / svc within eps
            if ts <= tn + eps:
                return -1
            _, bid = heapq.heappop(ch)
            b = self._batches.get(bid)
            if b is not None and b.site < 0:
                if ch and ch[0][0] <= tn + eps:
                    # another close (possibly stale) ties: replay both
                    # through the generic path for exact coalescing
                    heapq.heappush(ch, (tn, bid))
                    return -1
                tm = self._timing
                if tm is not None:
                    _t0 = time.perf_counter()
                self._open.pop((b.origin, b.ci), None)
                r = self._dispatch(b, tn)
                if r >= 0:
                    self._start_site(r, tn)
                if tm is not None:
                    tm["batch_close_s"] += time.perf_counter() - _t0
                return 1 if r == _FLOW else 0
            # stale top (unreachable: _heap_min validated it) — popping
            # it was harmless; let the generic path resolve the time
            return -1
        if ts == tn and tc > tn + eps:
            # isolated service completion: no second svc within eps
            if len(sh) > 1:
                # peek the runner-up without a full sort: heap children
                second = min(sh[1][0], sh[2][0]) if len(sh) > 2 else sh[1][0]
                if second <= tn + eps:
                    return -1
            tm = self._timing
            if tm is not None:
                _t0 = time.perf_counter()
            _, bid = heapq.heappop(sh)
            b = self._batches.pop(bid)
            self._complete_service(b, tn)
            self._start_site(b.site, tn)
            if tm is not None:
                tm["service_s"] += time.perf_counter() - _t0
            return 0
        return -1

    # -- free-flow merge (origin-only routing regime) ------------------------
    def _ff_build_streams(self) -> list:
        """Per-(origin, class) arrival sub-streams plus their *global
        batch-unit partition*.  With origin-only routing a batch opens
        at its stream's first pending arrival, absorbs arrivals until
        ``batch_timeout_s`` later (or ``max_batch`` members), and the
        next batch opens at the following arrival — so the partition of
        each stream into batch units is a pure function of the arrival
        arrays, fixed for the whole run no matter which path (merge or
        per-event replay) processes any given span.  Computing it once
        turns per-span segmentation into a bisect plus precomputed
        slices.

        Each stream entry is ``(gix, gts, ust, uend, ut0, utc, ufill,
        utfl)``: global indices, times, unit start/end positions, unit
        open/close times, max-batch fill flags and fill-arrival times
        (+inf when the unit does not fill)."""
        ev = self.events
        ncls = self._ncls
        timeout = self._timeout
        mb = self._max_batch
        key = ev.origin.astype(np.int64) * ncls + ev.cls_idx
        order = np.argsort(key, kind="stable")
        ks = key[order]
        bounds = np.searchsorted(ks, np.arange(self.n_sites * ncls + 1))
        t_sorted = ev.t_s[order]
        streams = []
        for k in range(self.n_sites * ncls):
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            gix = order[lo:hi].tolist()
            tnp = t_sorted[lo:hi]
            ns = hi - lo
            if ns == 0:
                streams.append((gix, [], [], [], [], [], [], [], [],
                                [], []))
                continue
            nxt = np.searchsorted(tnp, tnp + timeout)
            nxt_l = nxt.tolist()
            ust = []
            i = 0
            while i < ns:
                ust.append(i)
                j = nxt_l[i]
                if j - i >= mb:
                    i += mb  # fill: next batch opens at the next arrival
                elif j > i:
                    i = j
                else:
                    i += 1  # timeout <= 0: degenerate, merge aborts anyway
            ua = np.asarray(ust, dtype=np.int64)
            ut0 = tnp[ua]
            nxtu = nxt[ua]
            ufill = (nxtu - ua) >= mb
            uend = np.where(ufill, ua + mb, nxtu)
            utfl = np.where(
                ufill, tnp[np.minimum(ua + mb - 1, ns - 1)], INF)
            ci = k % ncls
            unom = (self._cls_batch_s[ci]
                    + self._cls_per_req_s[ci] * (uend - ua))
            uend_l = uend.tolist()
            ut0_l = ut0.tolist()
            utc_l = (ut0 + timeout).tolist()
            unom_l = unom.tolist()
            # per-unit close records, C-built: the merge's segmentation
            # slices these directly instead of walking units in python
            urecs = list(zip(utc_l, repeat(k), repeat(k // ncls),
                             repeat(ci), ust, uend_l, unom_l, ut0_l))
            streams.append((gix, tnp.tolist(), ust, uend_l,
                            ut0_l, utc_l,
                            ufill.tolist(), utfl.tolist(),
                            unom_l, np.nonzero(ufill)[0].tolist(),
                            urecs))
        self._ffs = streams
        self._ff_oc = [(k // ncls, k % ncls)
                       for k in range(self.n_sites * ncls)]
        return streams

    def _ff_merge(self, limit: float, t_end: float,
                  eps: float) -> Tuple[int, float]:
        """Advance through the chunk's arrivals / batch closes / service
        completions as one three-way time merge, with no per-event heap
        or dispatch machinery.  Valid only while every dispatch resolves
        to the batch origin — i.e. the nearest kernel with a non-full
        origin queue, or an unbound plane.  Any situation outside that
        regime (a full origin queue under the nearest kernel, a
        max-batch fill, or two events within ``eps`` of each other,
        which the scalar path would coalesce into one tick) stops the
        merge *before* the first affected event; the caller's per-event
        paths replay it with exact scalar semantics.

        Batch membership is precomputed per (origin, class) stream:
        with origin-only routing a batch opens at its stream's first
        pending arrival and closes ``batch_timeout_s`` later, so the
        member set is a pure function of the arrival arrays.  Jitter
        draws happen at service starts in event order (the scalar
        order), billing is buffered in completion order and flushed
        through :meth:`PowerLedger.post_serve_block`, and the ∫N dt
        area integral advances event-by-event with the scalar's exact
        add sequence.  Returns ``(n_events, t_last)``.
        """
        # -- entry invariant: queued work implies every replica is busy
        # (guaranteed by the scalar protocol; checked defensively)
        qs = self._queues
        busy = self._busy
        repl = self._repl
        for s in range(self.n_sites):
            if qs[s] and busy[s] < repl[s]:
                return 0, 0.0
        stop = limit if limit <= t_end else math.nextafter(t_end, INF)
        at, adl = self._at, self._adl
        n_arr = self._n_arr
        ap = self._ptr
        streams = self._ffs
        if streams is None:
            streams = self._ff_build_streams()
        ncls = self._ncls
        max_batch = self._max_batch
        bl = bisect.bisect_left
        oc = self._ff_oc
        openb = self._open
        # -- segmentation over the precomputed global unit partition:
        # locate each stream's first pending unit, collect the closes
        # that land in-span (unit close times are monotone per stream —
        # close = open + timeout — so the walk stops at the first one
        # beyond the cutoff) and the earliest max-batch fill, which the
        # merge cannot dispatch and therefore bounds the span.
        abort_at = INF
        imp: Dict[int, Tuple[_Batch, int]] = {}
        nstr = len(streams)
        p0s = [-1] * nstr
        recs: List[tuple] = []
        for k in range(nstr):
            g = streams[k]
            gix = g[0]
            ust = g[2]
            if not ust:
                continue
            i0 = bl(gix, ap)
            ob = openb.get(oc[k])
            if ob is not None:
                pu = bl(ust, i0) - 1
                if pu < 0 or g[4][pu] != ob.opened_s:
                    return 0, 0.0  # partition drift: replay per-event
                imp[k] = (ob, i0)
            else:
                ns = len(gix)
                if i0 >= ns or g[1][i0] >= stop:
                    continue
                pu = bl(ust, i0 + 1) - 1
                if pu < 0 or ust[pu] != i0:
                    return 0, 0.0  # partition drift: replay per-event
            p0s[k] = pu
            # in-span closes are a contiguous unit range [pu, pe),
            # truncated at the first max-batch fill unit (the walk the
            # scalar would do checks fill *before* the cutoff, so a
            # fill unit reached at pe still bounds the span)
            pe = bl(g[5], stop, pu)
            fpos = g[9]
            if fpos:
                fj = bl(fpos, pu)
                if fj < len(fpos):
                    fp = fpos[fj]
                    if fp <= pe:
                        tf = g[7][fp]
                        if tf < abort_at:
                            abort_at = tf
                        pe = fp
            if pe > pu:
                recs.extend(g[10][pu:pe])
        # closes are chronological once merged across streams; within a
        # span dispatch order equals batch-open order (close = open +
        # constant timeout), so new bids are assigned sequentially at
        # dispatch — exactly the scalar's open-order numbering
        base_bid = self._next_bid
        nbid = base_bid
        recs.sort()
        rec_tc = [r[0] for r in recs]
        n_rec = len(recs)
        # -- pending service completions (pre-chunk in-flight included)
        dones = []
        for td, bid in self._svc_heap:
            bb = self._batches[bid]
            dones.append((td, bid, bb.site, bb.idx,
                          bb.t_service_start_s, bb))
        heapq.heapify(dones)
        self._svc_heap = []
        if abort_at < stop:
            stop = abort_at
        # -- hot locals
        qreqs = self._qreqs
        pend = self._pend
        routed = self._site_routed
        servedl = self._site_served
        lats = self.latencies
        qsamp = self.queue_samples
        cbs = self._cls_batch_s
        cps = self._cls_per_req_s
        max_q = self._max_q
        full_q_aborts = self._bound  # nearest scans remotes when full
        jrng = self._jrng
        sigma = self._sigma
        jl = self._jit_buf
        ji = self._jit_i
        if jl is None:
            # eager first fill: identical rng consumption to the lazy
            # fill `_next_jitter` would do at the first draw
            jl = self._jit_buf = np.exp(
                jrng.normal(0.0, sigma, 4096)).tolist()
            ji = 0
        batches = self._batches
        openb = self._open
        heappush = heapq.heappush
        heappop = heapq.heappop
        bill_site: List[int] = []
        bill_t0: List[float] = []
        bill_t1: List[float] = []
        served = self.served
        dropped = self.dropped
        viol = 0
        in_sys = self._in_system
        area = self.area_request_s
        area_t = self._area_t
        ap0 = ap
        nd = 0
        t_last = 0.0
        cp = 0
        B = stop
        aborted = False
        while True:
            ta = at[ap] if ap < n_arr else INF
            tcv = rec_tc[cp] if cp < n_rec else INF
            tdv = dones[0][0] if dones else INF
            if ta <= tcv and ta <= tdv:
                if ta >= stop:
                    break
                # -- run of consecutive arrivals: hoist the close/done
                # bound out of the per-event loop (scalar add order for
                # the area integral is preserved exactly)
                bound = tcv if tcv <= tdv else tdv
                lim = stop if stop <= bound else bound
                rs = ap
                while True:
                    nxt = at[ap + 1] if ap + 1 < n_arr else INF
                    nx = nxt if nxt < bound else bound
                    if nx - ta <= eps:
                        B = ta
                        aborted = True
                        break
                    area += in_sys * (ta - area_t)
                    area_t = ta
                    in_sys += 1
                    ap += 1
                    if nxt >= lim:
                        break
                    ta = nxt
                if ap > rs:
                    t_last = at[ap - 1]
                if aborted:
                    break
                continue
            if tcv <= tdv:
                te = tcv
                if te >= stop:
                    break
                nx = rec_tc[cp + 1] if cp + 1 < n_rec else INF
                if ta < nx:
                    nx = ta
                if tdv < nx:
                    nx = tdv
                if nx - te <= eps:
                    B = te
                    break
                rec = recs[cp]
                o = rec[2]
                q = qs[o]
                qn = len(q)
                if qn >= max_q and full_q_aborts:
                    B = te  # the nearest router would scan remote sites
                    break
                cp += 1
                k = rec[1]
                e_ = rec[5]
                impk = imp.pop(k, None) if imp else None
                if impk is not None:
                    ob, i_s = impk
                    mem = ob.idx + streams[k][0][i_s:e_]
                    bid = ob.bid
                    openb.pop(oc[k], None)
                else:
                    ob = None
                    mem = streams[k][0][rec[4]:e_]
                    bid = nbid
                    nbid += 1
                n = len(mem)
                nominal = rec[6]
                routed[o] += n
                if qn >= max_q:
                    dropped += n
                    area += in_sys * (te - area_t)
                    area_t = te
                    in_sys -= n
                    if ob is not None:
                        batches.pop(bid, None)
                    t_last = te
                    continue
                qsamp.append(qreqs[o] + n)
                if busy[o] < repl[o]:
                    # queue is empty here (entry invariant + merge
                    # dynamics), so this batch starts immediately
                    pend[o] += nominal
                    pend[o] -= nominal
                    busy[o] += 1
                    if ji >= 4096:
                        jl = self._jit_buf = np.exp(
                            jrng.normal(0.0, sigma, 4096)).tolist()
                        ji = 0
                    jit = jl[ji]
                    ji += 1
                    svc = nominal * jit
                    if ob is not None:
                        # survivors must look exactly as the per-event
                        # path would have left them
                        ob.idx = mem
                        ob.nominal = nominal
                        ob.site = o
                        ob.t_service_start_s = te
                        ob.service_s = svc
                    heappush(dones, (te + svc, bid, o, mem, te, ob,
                                     svc, rec[3], rec[7], nominal))
                else:
                    qreqs[o] += n
                    pend[o] += nominal
                    if ob is not None:
                        bb = ob
                        bb.idx = mem
                    else:
                        bb = _Batch(bid, o, rec[3], mem, rec[7])
                    bb.nominal = nominal
                    bb.site = o
                    # register like the per-event dispatch does: a
                    # queued batch must be reachable through
                    # ``_batches`` when ``_start_site`` later pushes
                    # its bid onto the service heap
                    batches[bid] = bb
                    q.append(bb)
                t_last = te
                continue
            te = tdv
            if te >= stop:
                break
            d = heappop(dones)
            nx = dones[0][0] if dones else INF
            if ta < nx:
                nx = ta
            if tcv < nx:
                nx = tcv
            if nx - te <= eps:
                heappush(dones, d)
                B = te
                break
            s = d[2]
            mem = d[3]
            busy[s] -= 1
            n = len(mem)
            served += n
            servedl[s] += n
            area += in_sys * (te - area_t)
            area_t = te
            in_sys -= n
            if n == 1:
                gi = mem[0]
                lats.append(te - at[gi])
                if te > adl[gi]:
                    viol += 1
            else:
                for gi in mem:
                    lats.append(te - at[gi])
                    if te > adl[gi]:
                        viol += 1
            bill_site.append(s)
            bill_t0.append(d[4])
            bill_t1.append(te)
            batches.pop(d[1], None)
            q = qs[s]
            if q:
                b2 = q.popleft()
                mem2 = b2.idx
                nom2 = b2.nominal
                qreqs[s] -= len(mem2)
                pend[s] -= nom2
                busy[s] += 1
                if ji >= 4096:
                    jl = self._jit_buf = np.exp(
                        jrng.normal(0.0, sigma, 4096)).tolist()
                    ji = 0
                jit = jl[ji]
                ji += 1
                svc = nom2 * jit
                b2.t_service_start_s = te
                b2.service_s = svc
                heappush(dones, (te + svc, b2.bid, b2.site, mem2,
                                 te, b2))
            nd += 1
            t_last = te
        # -- write back scalars
        n_ev = (ap - ap0) + cp + nd
        self._ptr = ap
        self._jit_i = ji
        self.arrived += ap - ap0
        self.served = served
        self.dropped = dropped
        self.slo_violations += viol
        self._in_system = in_sys
        self.area_request_s = area
        self._area_t = area_t
        # -- rebuild the service heap from unfinished work (lazily
        # materializing batch objects the merge never had to build)
        sh = self._svc_heap
        for d in dones:
            bid = d[1]
            bb = d[5]
            if bb is None:
                bb = _Batch(bid, d[2], d[7], d[3], d[8])
                bb.site = d[2]
                bb.nominal = d[9]
                bb.t_service_start_s = d[4]
                bb.service_s = d[6]
            batches[bid] = bb
            sh.append((d[0], bid))
        heapq.heapify(sh)
        # -- re-materialize batches left open at the boundary (at most
        # one per stream: unit intervals are disjoint in time).  New
        # boundary-open units take their bids *after* every in-span
        # dispatch — any unit opening after a dispatched one also
        # closes after it (close = open + constant timeout), so the
        # scalar's open-order numbering is dispatch bids first, then
        # boundary-open units by open time.
        cands = []
        for k in range(nstr):
            pu = p0s[k]
            if pu < 0:
                continue
            g = streams[k]
            ut0l = g[4]
            p = bl(ut0l, B, pu) - 1
            if p < pu:
                continue
            fill = g[6][p]
            if not fill and g[5][p] < B:
                continue  # dispatched in-merge; nothing is open
            ust = g[2]
            jcap = ust[p] + max_batch - 1 if fill else g[3][p]
            impk = imp.get(k)
            if impk is not None and p == pu:
                ob, i_s = impk
                jb = bl(g[1], B, i_s, jcap)
                if jb > i_s:
                    ob.idx.extend(g[0][i_s:jb])
                continue
            i_s = ust[p]
            jb = bl(g[1], B, i_s, jcap)
            if jb > i_s:
                cands.append((ut0l[p], k, p, jb))
        cands.sort()
        for t_open, k, p, jb in cands:
            g = streams[k]
            o, ci = oc[k]
            nb = _Batch(nbid, o, ci, g[0][g[2][p]:jb], t_open)
            nbid += 1
            batches[nb.bid] = nb
            openb[oc[k]] = nb
            heappush(self._close_heap, (g[5][p], nb.bid))
        self._next_bid = nbid
        if bill_site:
            self._bill_site.extend(bill_site)
            self._bill_t0.extend(bill_t0)
            self._bill_t1.extend(bill_t1)
        return n_ev, t_last

    def _flush_bills(self) -> None:
        """Drain deferred service bills through the ledger's block
        posting.  The buffers are detached before posting, so the
        reentrant sync call from a straddle's scalar fallback is a
        no-op instead of a loop."""
        if not self._bill_site:
            return
        bs, b0, b1 = self._bill_site, self._bill_t0, self._bill_t1
        self._bill_site = []
        self._bill_t0 = []
        self._bill_t1 = []
        self.ledger.post_serve_block(bs, self._p_kw, b0, b1)

    # -- WAN flow interface (shared split with migrations) -------------------
    def flow_pairs(self) -> List[Tuple[int, int]]:
        return [(f.src, f.dst) for f in self._flows.values()]

    def rerate(self, t: float, rates: Sequence[float]) -> None:
        for f, r in zip(self._flows.values(), rates):
            self._flush_flow(f, t)
            f.rate_bps = float(r)
            f.ver += 1
            if f.rate_bps > 0.0:
                heapq.heappush(
                    self._flow_heap,
                    (t + f.remaining_bits / f.rate_bps, f.fid, f.ver))

    def _flush_flow(self, f: _Flow, t: float) -> None:
        span = t - f.anchor_s
        if span > 0.0:
            f.remaining_bits = max(0.0, f.remaining_bits - f.rate_bps * span)
        f.anchor_s = t

    # -- internals -----------------------------------------------------------
    def _dispatch(self, b: _Batch, t: float) -> int:
        """Route a closed batch.  Returns the enqueued site id, or
        ``_FLOW`` when a WAN flow started, or ``_GONE`` when the batch
        left the system (overflow drop / proactive shed)."""
        b.nominal = (self._cls_batch_s[b.ci]
                     + self._cls_per_req_s[b.ci] * len(b.idx))
        site = b.origin
        if self._bound:
            tm = self._timing
            if tm is not None:
                _t0 = time.perf_counter()
            try:
                site = int(self._kernel.route(b, t))
            except Exception:
                site = b.origin
            if tm is not None:
                tm["router_s"] += time.perf_counter() - _t0
        if site == SHED:
            self._shed(b, t)
            return _GONE
        if not 0 <= site < self.n_sites:
            site = b.origin
        if site != b.origin and not self.topo.reachable(b.origin, site):
            site = b.origin
        b.site = site
        self._site_routed[site] += len(b.idx)
        if site == b.origin:
            return self._enqueue(b, site, t)
        f = _Flow(self._next_fid, b, b.origin, site,
                  self._cls_bits[b.ci] * len(b.idx), t)
        self._next_fid += 1
        self._flows[f.fid] = f
        return _FLOW  # caller re-splits; rerate() queues the landing

    def _enqueue(self, b: _Batch, site: int, t: float) -> int:
        q = self._queues[site]
        if len(q) >= self._max_q:
            self._drop(b, t)
            return _GONE
        q.append(b)
        self._qreqs[site] += len(b.idx)
        self._pend[site] += b.nominal
        self.queue_samples.append(self._qreqs[site])
        return site

    def _drop(self, b: _Batch, t: float) -> None:
        n = len(b.idx)
        self.dropped += n
        self._bump_area(t)
        self._in_system -= n
        self._batches.pop(b.bid, None)

    def _shed(self, b: _Batch, t: float) -> None:
        n = len(b.idx)
        self.shed += n
        self._bump_area(t)
        self._in_system -= n
        self._batches.pop(b.bid, None)

    def _next_jitter(self) -> float:
        """Next lognormal jitter multiplier.  The buffer holds
        ``np.exp`` of a ``normal(0, σ, size=4096)`` block as python
        floats — bit-identical to ``float(np.exp(draw))`` per scalar
        draw (block exp verified elementwise-equal on build)."""
        i = self._jit_i
        buf = self._jit_buf
        if buf is None or i >= len(buf):
            buf = self._jit_buf = np.exp(
                self._jrng.normal(0.0, self._sigma, 4096)).tolist()
            i = 0
        self._jit_i = i + 1
        return buf[i]

    def _start_site(self, s: int, t: float) -> float:
        """Start queued batches at ``s`` while replicas are free; jitter
        draws in queue order.  Returns the earliest pushed completion
        (INF when none started)."""
        q = self._queues[s]
        first = INF
        while q and self._busy[s] < self._repl[s]:
            b = q.popleft()
            self._qreqs[s] -= len(b.idx)
            self._pend[s] -= b.nominal
            self._busy[s] += 1
            jitter = self._next_jitter()
            b.service_s = b.nominal * jitter
            b.t_service_start_s = t
            td = t + b.service_s
            heapq.heappush(self._svc_heap, (td, b.bid))
            if td < first:
                first = td
        return first

    def _start_services(self, t: float) -> None:
        for s in range(self.n_sites):
            self._start_site(s, t)

    def _complete_service(self, b: _Batch, t: float) -> None:
        s = b.site
        self._busy[s] -= 1
        n = len(b.idx)
        self.served += n
        self._site_served[s] += n
        self._bump_area(t)
        self._in_system -= n
        at, adl = self._at, self._adl
        lats = self.latencies
        viol = 0
        for i in b.idx:
            lats.append(t - at[i])
            if t > adl[i]:
                viol += 1
        self.slo_violations += viol
        self.ledger.post_serve(s, self._p_kw, b.t_service_start_s, t)

    # -- fault interface (mirror of the scalar plane) ------------------------
    def crash_replica(self, site: int, t: float) -> bool:
        s = int(site)
        self._repl[s] = 0
        flows_dirty = False
        interrupted: List[_Batch] = []
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
            self._busy[s] -= 1
            self.ledger.post_serve(s, self._p_kw, b.t_service_start_s, t)
            b.t_service_start_s = -1.0
            b.service_s = 0.0
            flows_dirty |= self._dispatch(b, t) == _FLOW
        q = self._queues[s]
        if q:
            drained = list(q)
            q.clear()
            for b in drained:
                self._qreqs[s] -= len(b.idx)
                self._pend[s] -= b.nominal
                flows_dirty |= self._dispatch(b, t) == _FLOW
        self._start_services(t)
        if self.profile.validate:
            self.audit()
        return flows_dirty

    def repair_replica(self, site: int, t: float) -> bool:
        s = int(site)
        self._repl[s] = self.profile.replicas_at(s)
        self._start_services(t)
        if self.profile.validate:
            self.audit()
        return False

    # -- accounting views ----------------------------------------------------
    @property
    def serve_grid_kwh(self) -> float:
        self._flush_bills()
        return self.ledger.serve_grid_kwh

    @property
    def serve_renewable_kwh(self) -> float:
        self._flush_bills()
        return self.ledger.serve_renewable_kwh

    @property
    def request_gco2(self) -> float:
        self._flush_bills()
        return self.ledger.request_gco2

    @property
    def site_request_gco2(self) -> np.ndarray:
        self._flush_bills()
        return self.ledger.site_request_gco2

    @property
    def requests(self) -> np.ndarray:
        """Arrival-count shim matching ``ServingPlane.requests`` (the
        chunked plane keeps columnar events, not Request objects)."""
        return self.events.t_s

    @property
    def replicas(self) -> np.ndarray:
        return np.asarray(self._repl, dtype=np.int64)

    @property
    def busy(self) -> np.ndarray:
        return np.asarray(self._busy, dtype=np.int64)

    @property
    def site_served(self) -> np.ndarray:
        return np.asarray(self._site_served, dtype=np.int64)

    @property
    def site_routed(self) -> np.ndarray:
        return np.asarray(self._site_routed, dtype=np.int64)

    def _bump_area(self, t: float) -> None:
        self.area_request_s += self._in_system * (t - self._area_t)
        self._area_t = t

    @property
    def in_flight(self) -> int:
        return self._in_system

    def view(self) -> ServingView:
        repl = np.asarray(self._repl, dtype=np.int64)
        pend = np.asarray(self._pend, dtype=np.float64)
        est = np.where(repl > 0, pend / np.maximum(repl, 1), INF)
        return ServingView(
            replicas=repl,
            busy_replicas=np.asarray(self._busy, dtype=np.int64),
            queue_batches=np.array([len(q) for q in self._queues],
                                   dtype=np.int64),
            queue_requests=np.asarray(self._qreqs, dtype=np.int64),
            est_wait_s=est,
            max_queue_batches=self._max_q,
            p_serve_kw=self._p_kw,
        )

    def audit(self) -> None:
        """Same conservation invariants as the scalar plane: arrived ==
        served + dropped + shed + in-system, exactly decomposed."""
        assert self.arrived == (self.served + self.dropped + self.shed
                                + self._in_system), (
            self.arrived, self.served, self.dropped, self.shed,
            self._in_system)
        open_n = sum(len(b.idx) for b in self._open.values())
        fly_n = sum(len(f.batch.idx) for f in self._flows.values())
        q_n = sum(self._qreqs)
        svc_n = sum(len(self._batches[bid].idx)
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
    "CarbonSloKernel", "ChunkedServingPlane", "GreenFirstKernel",
    "NearestKernel", "make_kernel", "supports_router",
]
