"""ClusterState: the one snapshot type every control surface shares.

``ClusterSimulator`` (per orchestrator tick), the ``launch.dryrun`` plan
preview and the ``launch.serve`` green router all build their view of the
cluster through :meth:`ClusterState.build` instead of hand-rolling context
objects.  The snapshot is immutable; policies read it and return typed
:mod:`repro_torch.core.actions`.

The advertised bandwidth matrix is derived from the *same* per-NIC share
counts the simulator's transfer loop uses (``min(nic/src_flows,
nic/dst_flows)`` per link with the *current* in-flight flows), so the
policy's view agrees with what the transfer loop is granting right now —
the seed implementation halved rows/columns once per in-flight transfer,
under-advertising a doubly-loaded uplink as bw/4 when the transfer loop
actually grants bw/2. Note the advertisement is of current shares, not the
post-admission share a new transfer would dilute to (nic/(flows+1)); the
alpha safety margin in Algorithm 1 absorbs that optimism.  Callers that
cannot lean on alpha — admission checks in ``serve --green-route`` and
``dryrun --plan``, and the ``plan-ahead`` policy's arrival estimates —
use :meth:`ClusterState.post_admission_bps` instead, which includes the
new flow in the share counts.

The snapshot also carries ``state.forecast`` — a
:class:`~repro_torch.core.forecast.ForecastHorizon` with the per-site upcoming
renewable windows and per-link WAN outage forecasts — built by
:meth:`ClusterState.build` whenever the caller passes its traces (the
simulator reuses one prebuilt horizon across ticks).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import (
    Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union,
)

import numpy as np

from repro_torch.core import feasibility as fz
from repro_torch.core.forecast import DEFAULT_HORIZON_S, ForecastHorizon
from repro_torch.core.wan import WanTopology


@dataclass(slots=True)
class JobView:
    """Policy-visible job facts (checkpoint size is the *measured* bytes)."""

    jid: int
    site: int
    ckpt_bytes: float
    remaining_compute_s: float
    t_load_s: float = fz.T_LOAD_S
    state: str = "running"  # queued|running|paused
    eligible: bool = True  # migration cooldown has elapsed
    power_frac: float = 1.0  # current Throttle level
    # Defer hold: the job is not schedulable before this sim-time.  Policies
    # MUST consult it before re-issuing Defer — a held job re-deferred every
    # tick is pure action noise (one Defer per (job, window)).
    defer_until_s: float = -1e18

    def held(self, t: float) -> bool:
        """Whether a Defer hold is still active at sim-time ``t``."""
        return self.defer_until_s > t


# JobSoA state codes (order matters: queued < running < paused mirrors the
# snapshot's bucket walk; names map 1:1 onto JobView.state strings)
STATE_QUEUED, STATE_RUNNING, STATE_PAUSED = 0, 1, 2
_STATE_NAMES = ("queued", "running", "paused")
_STATE_CODES = {n: c for c, n in enumerate(_STATE_NAMES)}


@dataclass(frozen=True, eq=False)
class JobSoA:
    """Structure-of-arrays view of every live job, jid-sorted.

    The vectorized policy kernels read these columns directly; the
    ``JobView`` tuple is materialized from them lazily only when a scalar
    consumer (the parity oracles, tests, examples) touches ``state.jobs``.
    All arrays share length ``m`` (live job count).
    """

    jids: np.ndarray  # (m,) int64 (jid-sorted on the simulator path)
    site: np.ndarray  # (m,) int64
    ckpt_bytes: np.ndarray  # (m,) float64
    remaining_s: np.ndarray  # (m,) float64 remaining compute
    t_load_s: np.ndarray  # (m,) float64
    state: np.ndarray  # (m,) int8: STATE_QUEUED/RUNNING/PAUSED
    eligible: np.ndarray  # (m,) bool (migration cooldown elapsed)
    power_frac: np.ndarray  # (m,) float64
    defer_until_s: np.ndarray  # (m,) float64
    # per-state counts (zero-op emptiness checks for the policy kernels;
    # -1 = unknown, derive from `state`)
    n_queued: int = -1
    n_running: int = -1
    n_paused: int = -1

    def __len__(self) -> int:
        return len(self.jids)

    def count(self, code: int) -> int:
        n = (self.n_queued, self.n_running, self.n_paused)[code]
        if n < 0:
            n = int((self.state == code).sum())
        return n

    @classmethod
    def from_views(cls, views: Sequence["JobView"]) -> "JobSoA":
        """Column-ize ``views`` preserving their order (the scalar decide
        paths iterate ``state.jobs`` in snapshot order; parity between the
        vectorized and scalar kernels needs the same order here)."""
        return cls(
            jids=np.array([v.jid for v in views], dtype=np.int64),
            site=np.array([v.site for v in views], dtype=np.int64),
            ckpt_bytes=np.array([v.ckpt_bytes for v in views]),
            remaining_s=np.array([v.remaining_compute_s for v in views]),
            t_load_s=np.array([v.t_load_s for v in views]),
            state=np.array([_STATE_CODES[v.state] for v in views],
                           dtype=np.int8),
            eligible=np.array([v.eligible for v in views], dtype=bool),
            power_frac=np.array([v.power_frac for v in views]),
            defer_until_s=np.array([v.defer_until_s for v in views]),
        )

    def views(self) -> Tuple["JobView", ...]:
        return tuple(
            JobView(int(j), int(s), float(cb), float(r), float(tl),
                    state=_STATE_NAMES[st], eligible=bool(el),
                    power_frac=float(pf), defer_until_s=float(du))
            for j, s, cb, r, tl, st, el, pf, du in zip(
                self.jids, self.site, self.ckpt_bytes, self.remaining_s,
                self.t_load_s, self.state, self.eligible, self.power_frac,
                self.defer_until_s))


@dataclass(slots=True)
class SiteView:
    sid: int
    slots: int
    busy: int  # running jobs
    queued: int
    renewable_active: bool
    window_remaining_s: float  # forecast
    incoming: int = 0  # in-flight migrations committed to this site
    next_window_start_s: float = float("inf")  # start of the next window

    @property
    def load(self) -> float:
        return (self.busy + self.queued + self.incoming) / max(self.slots, 1)

    @property
    def free_slots(self) -> int:
        return max(0, self.slots - self.busy - self.incoming)


@dataclass(frozen=True, eq=False)
class ClusterState:
    """Immutable cluster snapshot handed to ``Policy.decide``.

    ``jobs`` holds every live (queued/running/paused) job; policies that only
    migrate should iterate :meth:`migratable`, which reproduces the classic
    "running jobs whose cooldown elapsed" view.

    Job facts live in one of two primary representations and the other is
    materialized lazily on first access: the array-of-structs ``JobView``
    tuple (:meth:`build`, the test/dryrun/serve path) or the
    structure-of-arrays :class:`JobSoA` (:meth:`build_soa`, the simulator's
    per-tick path — the vectorized policy kernels consume ``state.soa``
    without ever constructing per-job objects).  Vectorized numpy views
    over jobs and sites are likewise lazy and cached.
    """

    t: float
    bandwidth_bps: np.ndarray  # (n_sites, n_sites) advertised effective bw
    # the topology the matrix was derived from (None when an explicit
    # matrix or the legacy uniform nic_bps path was used)
    wan: Optional["WanTopology"] = None
    # the in-flight (src, dst) flow set the matrix was derived under —
    # what post_admission_bps dilutes against
    transfers: Tuple[Tuple[int, int], ...] = ()
    # the uniform NIC rate when the legacy nic_bps path built the matrix
    # (None on the wan / explicit-matrix paths)
    nic_bps: Optional[float] = None
    # lookahead forecast (upcoming windows + WAN outages); None when the
    # caller had no traces to forecast from
    forecast: Optional[ForecastHorizon] = None
    # exactly one of these is set by the constructors; the other derives
    jobs_aos: Optional[Tuple[JobView, ...]] = None
    jobs_soa: Optional[JobSoA] = None
    # SiteView tuple, or a zero-arg factory materialized lazily (the
    # simulator's fast path defers SiteView construction to the rare
    # scalar consumers)
    sites_in: Union[Tuple[SiteView, ...], Callable[[], Tuple[SiteView, ...]]] = ()
    # per-site serving-plane summary (replica pools, queue depths); None
    # when the run carries no serving plane.  String-annotated: no
    # runtime import of repro_torch.core.serving (it imports nothing from
    # state, but keeping state serving-free avoids a cycle if routers
    # ever grow state helpers).
    serving: Optional["ServingView"] = None  # noqa: F821
    # the run's per-site BatteryConfig (core/ledger.py), or None when
    # storage is off.  Untyped for the same no-cycle reason as serving;
    # battery-aware policies read it together with site_battery_soc.
    battery: Optional[object] = None

    @cached_property
    def sites(self) -> Tuple[SiteView, ...]:
        if callable(self.sites_in):
            return tuple(self.sites_in())
        return self.sites_in

    @cached_property
    def jobs(self) -> Tuple[JobView, ...]:
        """Live jobs as ``JobView`` objects, jid-sorted (materialized from
        the SoA columns when the snapshot was built via :meth:`build_soa`)."""
        if self.jobs_aos is not None:
            return self.jobs_aos
        return self.jobs_soa.views()

    @cached_property
    def soa(self) -> JobSoA:
        """Live jobs as jid-sorted :class:`JobSoA` columns (derived from
        the ``JobView`` tuple when the snapshot was built via
        :meth:`build`)."""
        if self.jobs_soa is not None:
            return self.jobs_soa
        return JobSoA.from_views(self.jobs_aos)

    def site(self, sid: int) -> SiteView:
        return self.sites[sid]

    def post_admission_bps(
        self, src: int, dst: int,
        flows: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> float:
        """The rate a NEW ``src -> dst`` transfer would be granted, with
        the new flow included in the share counts (``flows+1`` dilution).
        ``bandwidth_bps`` advertises *current* grants and is systematically
        optimistic for exactly this query; admission checks belong here.

        ``flows`` overrides the snapshot's in-flight set — callers that
        admit several transfers in one pass (the serve router, the
        dry-run plan validator, plan-ahead's per-tick migrations) thread
        their growing list through so each admission sees the dilution of
        the ones before it."""
        if flows is None:
            flows = self.transfers
        if self.wan is not None:
            return self.wan.post_admission_rate(src, dst, flows, self.t)
        # legacy uniform-NIC fallback: use the recorded NIC rate (the
        # matrix maximum underestimates it whenever every entry is
        # diluted by flows) and re-count with the new flow included.
        # Capped by the pair's own advertised entry so an explicit
        # NON-uniform matrix (tests/replay path) never advertises the
        # fabric's fastest link for a slower pair — post-admission can
        # only be at or below the current grant.
        bw = np.asarray(self.bandwidth_bps)
        nic = (self.nic_bps if self.nic_bps is not None
               else float(bw.max()))
        src_n, dst_n = nic_share_counts(flows)
        return min(float(bw[src, dst]),
                   nic / (src_n.get(src, 0) + 1),
                   nic / (dst_n.get(dst, 0) + 1))

    @property
    def n_sites(self) -> int:
        return self.bandwidth_bps.shape[0]

    def migratable(self) -> List[JobView]:
        """Running jobs past their migration cooldown, in jid order."""
        return [j for j in self.jobs if j.state == "running" and j.eligible]

    def running(self) -> List[JobView]:
        return [j for j in self.jobs if j.state == "running"]

    def queued(self) -> List[JobView]:
        return [j for j in self.jobs if j.state == "queued"]

    def paused(self) -> List[JobView]:
        return [j for j in self.jobs if j.state == "paused"]

    # ---- vectorized views (lazy, cached) ----------------------------------
    @cached_property
    def job_sites(self) -> np.ndarray:
        return self.soa.site

    @cached_property
    def job_ckpt_bytes(self) -> np.ndarray:
        return self.soa.ckpt_bytes

    @cached_property
    def job_remaining_s(self) -> np.ndarray:
        return self.soa.remaining_s

    # (the site_* views are seeded directly by ClusterState.build_soa when
    # the caller already holds the arrays — cached_property is a non-data
    # descriptor, so a pre-set instance __dict__ entry wins)
    @cached_property
    def site_window_s(self) -> np.ndarray:
        return np.array([s.window_remaining_s for s in self.sites], dtype=np.float64)

    @cached_property
    def site_renewable(self) -> np.ndarray:
        return np.array([s.renewable_active for s in self.sites], dtype=bool)

    @cached_property
    def site_load(self) -> np.ndarray:
        return np.array([s.load for s in self.sites], dtype=np.float64)

    @cached_property
    def site_free_slots(self) -> np.ndarray:
        return np.array([s.free_slots for s in self.sites], dtype=np.int64)

    @cached_property
    def site_next_window_s(self) -> np.ndarray:
        return np.array([s.next_window_start_s for s in self.sites],
                        dtype=np.float64)

    @cached_property
    def site_slots(self) -> np.ndarray:
        return np.array([s.slots for s in self.sites], dtype=np.int64)

    @cached_property
    def site_busy(self) -> np.ndarray:
        return np.array([s.busy for s in self.sites], dtype=np.int64)

    @cached_property
    def site_bq_load(self) -> np.ndarray:
        """(busy + queued) / max(slots, 1) per site — the reservation-free
        destination-load term of the Algorithm-1 benefit."""
        return np.array(
            [(s.busy + s.queued) / max(s.slots, 1) for s in self.sites],
            dtype=np.float64)

    @cached_property
    def site_bq_raw(self) -> np.ndarray:
        """busy + queued per site (ints) — the un-normalized numerator of
        :attr:`site_bq_load`, for reservation-aware re-scoring (the
        same-tick slot reservations add to this count)."""
        return np.array([s.busy + s.queued for s in self.sites],
                        dtype=np.int64)

    @cached_property
    def site_battery_soc(self) -> np.ndarray:
        """(n_sites,) battery state of charge in kWh at snapshot time
        (zeros when the run carries no storage).  Seeded from the
        simulator's PowerLedger via ``site_arrays``; the default here
        covers snapshots built outside a storage-enabled run."""
        return np.zeros(self.n_sites)

    # ---- fault views (core/faults.py) --------------------------------------
    @cached_property
    def site_up(self) -> np.ndarray:
        """(n_sites,) bool — False while a site is blacked out (all slots
        down, NICs dark).  Seeded from the simulator's FaultPlan via
        ``site_arrays`` only when a fault regime is active; the all-up
        default covers every fault-free run at zero cost."""
        return np.ones(self.n_sites, dtype=bool)

    @cached_property
    def link_up(self) -> np.ndarray:
        """(n_sites, n_sites) bool — False while the src→dst path is down
        to a hard link failure or an endpoint blackout (distinct from the
        *scheduled* brownout calendar, which only degrades capacity).
        Seeded like :attr:`site_up`; all-up default otherwise."""
        return np.ones((self.n_sites, self.n_sites), dtype=bool)

    # ---- grid-signal views (from the forecast's signal stacks) -------------
    @cached_property
    def site_carbon(self) -> np.ndarray:
        """(n_sites,) current carbon intensity (gCO2/kWh); zeros when the
        run carries no signals.  Read-only (epoch-cached stack view)."""
        fc = self.forecast
        if fc is None:
            return np.zeros(self.n_sites)
        return fc.carbon_grid(self.t)

    @cached_property
    def site_price(self) -> np.ndarray:
        """(n_sites,) current grid price ($/kWh); zeros w/o signals."""
        fc = self.forecast
        if fc is None:
            return np.zeros(self.n_sites)
        return fc.price_grid(self.t)

    @cached_property
    def site_curtail_frac(self) -> np.ndarray:
        """(n_sites,) active demand-response power cap (1.0 = no request)."""
        fc = self.forecast
        if fc is None:
            return np.ones(self.n_sites)
        return fc.curtail_frac_grid(self.t)

    @cached_property
    def job_carbon(self) -> np.ndarray:
        """(m,) current carbon intensity at each live job's site — the
        per-job signal column the vectorized decide kernels score against."""
        return self.site_carbon[self.soa.site]

    # ---- the one constructor ----------------------------------------------
    @classmethod
    def build(
        cls,
        t: float,
        jobs: Iterable[JobView],
        sites: Sequence[SiteView],
        *,
        wan: Optional["WanTopology"] = None,
        nic_bps: Optional[float] = None,
        transfers: Sequence[Tuple[int, int]] = (),
        bandwidth_bps: Optional[np.ndarray] = None,
        traces: Optional[Sequence] = None,
        forecast: Optional[ForecastHorizon] = None,
        signals=None,
        forecast_sigma_s: float = 0.0,
        forecast_seed: int = 0,
        forecast_horizon_s: float = DEFAULT_HORIZON_S,
        serving=None,
        battery=None,
    ) -> "ClusterState":
        """Assemble a snapshot.

        Pass a :class:`~repro_torch.core.wan.WanTopology` plus the in-flight
        ``transfers`` as ``(src, dst)`` pairs and the advertised matrix is
        its per-resource fair share under the current flow set; or the
        legacy uniform per-site NIC rate ``nic_bps`` (same share model,
        uncapped links); or an explicit ``bandwidth_bps`` matrix (tests,
        replay).

        The forecast horizon: pass a prebuilt ``forecast`` (the simulator
        builds one per run and reuses it across ticks — window noise is
        hash-deterministic, so rebuilding would give the identical
        object), or the site ``traces`` and one is built here with the
        ``forecast_*`` knobs (the dry-run planner and serve router path).
        With neither, ``state.forecast`` is None and plan-ahead consumers
        degrade to reactive behaviour.
        """
        sites = tuple(sites)
        transfers = tuple(transfers)
        if bandwidth_bps is None:
            if wan is not None:
                bandwidth_bps = wan.advertised_matrix(t, transfers)
            elif nic_bps is not None:
                bandwidth_bps = advertised_bandwidth(len(sites), nic_bps, transfers)
            else:
                raise ValueError(
                    "need wan, nic_bps (with transfers) or bandwidth_bps")
        if forecast is None and traces is not None:
            forecast = ForecastHorizon.build(
                traces, wan=wan, signals=signals,
                horizon_s=forecast_horizon_s,
                sigma_s=forecast_sigma_s, seed=forecast_seed)
        return cls(t=t, jobs_aos=tuple(jobs), sites_in=sites,
                   bandwidth_bps=np.asarray(bandwidth_bps, dtype=np.float64),
                   wan=wan, transfers=transfers, forecast=forecast,
                   nic_bps=nic_bps, serving=serving, battery=battery)

    @classmethod
    def build_soa(
        cls,
        t: float,
        soa: JobSoA,
        sites: Union[Sequence[SiteView], Callable[[], Sequence[SiteView]]],
        *,
        n_sites: Optional[int] = None,
        wan: Optional["WanTopology"] = None,
        nic_bps: Optional[float] = None,
        transfers: Sequence[Tuple[int, int]] = (),
        bandwidth_bps: Optional[np.ndarray] = None,
        forecast: Optional[ForecastHorizon] = None,
        site_arrays: Optional[Dict[str, np.ndarray]] = None,
        serving=None,
        battery=None,
    ) -> "ClusterState":
        """Assemble a snapshot from :class:`JobSoA` columns (the simulator's
        per-tick fast path — no per-job or per-site objects are
        constructed unless a scalar consumer later touches ``state.jobs``
        / ``state.sites``).  ``sites`` may be a zero-arg factory (then
        pass ``n_sites``); bandwidth sources as in :meth:`build`.
        ``site_arrays`` pre-seeds the cached ``site_*`` vector views
        (keys = property names) for callers that already hold them as
        arrays."""
        transfers = tuple(transfers)
        if callable(sites):
            sites_in = sites
            if n_sites is None:
                raise ValueError("a sites factory needs explicit n_sites")
        else:
            sites_in = tuple(sites)
            n_sites = len(sites_in)
        if bandwidth_bps is None:
            if wan is not None:
                bandwidth_bps = wan.advertised_matrix(t, transfers)
            elif nic_bps is not None:
                bandwidth_bps = advertised_bandwidth(
                    n_sites, nic_bps, transfers)
            else:
                raise ValueError(
                    "need wan, nic_bps (with transfers) or bandwidth_bps")
        st = cls(t=t, jobs_soa=soa, sites_in=sites_in,
                 bandwidth_bps=np.asarray(bandwidth_bps, dtype=np.float64),
                 wan=wan, transfers=transfers, forecast=forecast,
                 nic_bps=nic_bps, serving=serving, battery=battery)
        if site_arrays:
            st.__dict__.update(site_arrays)
        return st


def site_views_from_traces(
    traces, t: float, *, slots: int, busy: Optional[Sequence[int]] = None,
    queued: Optional[Sequence[int]] = None,
) -> List[SiteView]:
    """SiteViews for a point-in-time look at a set of traces (no noise, no
    in-flight state) — the assembly shared by the dry-run planner and the
    serve router. The simulator builds richer views itself (forecast noise,
    incoming transfers)."""
    views = []
    for s, tr in enumerate(traces):
        nw = tr.next_window(t)
        views.append(SiteView(
            sid=s,
            slots=slots,
            busy=busy[s] if busy is not None else 0,
            queued=queued[s] if queued is not None else 0,
            renewable_active=tr.active(t),
            window_remaining_s=tr.remaining(t),
            next_window_start_s=nw.start_s if nw else float("inf"),
        ))
    return views


def nic_share_counts(
    transfers: Sequence[Tuple[int, int]],
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Flows per source / destination NIC — the transfer loop's share model."""
    src: Dict[int, int] = {}
    dst: Dict[int, int] = {}
    for s, d in transfers:
        src[s] = src.get(s, 0) + 1
        dst[d] = dst.get(d, 0) + 1
    return src, dst


def advertised_bandwidth(
    n_sites: int, nic_bps: float, transfers: Sequence[Tuple[int, int]] = ()
) -> np.ndarray:
    """Effective (src, dst) bandwidth matrix under per-NIC fair sharing:
    ``min(nic/flows(src), nic/flows(dst))`` with idle NICs at full rate."""
    bw = np.full((n_sites, n_sites), nic_bps, dtype=np.float64)
    if transfers:
        src, dst = nic_share_counts(transfers)
        for s, k in src.items():
            bw[s, :] = np.minimum(bw[s, :], nic_bps / k)
        for d, k in dst.items():
            bw[:, d] = np.minimum(bw[:, d], nic_bps / k)
    return bw


__all__ = [
    "ClusterState", "JobSoA", "JobView", "SiteView", "advertised_bandwidth",
    "nic_share_counts", "site_views_from_traces",
    "STATE_PAUSED", "STATE_QUEUED", "STATE_RUNNING",
]
