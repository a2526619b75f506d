"""Per-link WAN topology subsystem (paper §V/§VII; cf. Heron's green
modular-DC routing and XWind's cross-site renewable-farm router).

The seed modeled the WAN as one uniform NIC rate with fabric-wide hourly
brownouts.  :class:`WanTopology` generalizes that to

  * per-site NIC rates, asymmetric per direction (``nic_out_bps`` egress,
    ``nic_in_bps`` ingress),
  * a per-link ``(src, dst)`` capacity matrix (``np.inf`` = NIC-limited,
    ``0`` = no link / partitioned),
  * an hourly brownout calendar scoped to the whole fabric (the legacy
    flaky-WAN regime, bit-identical calendar for a given seed) or to
    individual links,

behind two query surfaces shared by every consumer (the simulator transfer
loop, ``ClusterState.build``'s advertised-bandwidth matrix, the
``launch.dryrun --plan`` planner and the ``launch.serve --green-route``
router):

  * :meth:`shared_rates` — the per-flow effective rate under fair sharing,
  * :meth:`advertised_matrix` — the policy-facing ``(n, n)`` bandwidth
    matrix under the *current* flow set.

Sharing models (``WanTopology(sharing=...)``, both used consistently by
the transfer loop and the advertised matrix):

  * ``"conservative"`` (default) — every flow traverses three resources
    (source NIC, destination NIC, the (src, dst) link) and is granted the
    minimum equal split ``cap(r) / flows(r)`` over them.  Each resource
    hands out at most its capacity, and on a uniform topology (equal
    NICs, uncapped links) the grant reduces *exactly* to the seed's
    ``min(nic / src_flows, nic / dst_flows)``.  This is the first round
    of max-min fair sharing: residual capacity that full water-filling
    would redistribute to unbottlenecked flows is left unclaimed.
  * ``"waterfill"`` — full max-min water-filling: raise every flow's rate
    in lockstep, freeze the flows crossing each resource as it saturates,
    redistribute the residual among the rest, repeat.  Per-flow rates
    dominate (are >=) the conservative split and still never oversubscribe
    any resource.  Exact-reduction caveat: waterfill coincides with the
    conservative split whenever every flow is frozen in the first round
    (e.g. all flows sharing one source or one destination NIC on a
    uniform fabric); with *several* disjoint bottlenecks a flow whose
    peers are frozen elsewhere inherits their residual, so waterfill is
    strictly greater — that residual is exactly what the conservative
    model leaves unclaimed.

:class:`WanProfile` is the scenario-composable *spec* (plain floats and
tuples, frozen); ``WanProfile.build_topology(n_sites, days, seed)``
materializes the arrays + brownout calendar.  See
:mod:`repro_torch.core.scenarios` for registry entries (``hub-spoke-wan``,
``asymmetric-uplink``, ``partitioned-wan``).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HOUR = 3600.0


# ---------------------------------------------------------------------------
# Scenario-facing spec
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WanProfile:
    """WAN spec a :class:`~repro_torch.core.scenarios.Scenario` composes.

    Uniform fields (the seed model): ``gbps`` per-site NIC rate, plus the
    flaky-link regime — each hour, with probability ``hourly_degrade_prob``,
    capacity drops to ``degraded_gbps`` for that hour.

    Topology fields (all optional; ``None`` keeps the uniform model):

      nic_gbps       per-site egress NIC rates, one entry per site
      nic_in_gbps    per-site ingress NIC rates (defaults to egress —
                     set both for asymmetric uplink/downlink)
      link_gbps      full (src, dst) per-link capacity matrix; ``None`` /
                     ``inf`` entries mean NIC-limited, ``0`` means no link
      brownout_scope ``"fabric"`` (whole WAN degrades at once — legacy) or
                     ``"per-link"`` (each link draws its own calendar)
      sharing        ``"conservative"`` (single-round split, legacy) or
                     ``"waterfill"`` (full max-min water-filling)
      multi_hop      allow one-relay paths: a ``src -> dst`` transfer may
                     traverse ``src -> h -> dst`` when that path's base
                     capacity strictly beats the direct link (hub-and-
                     spoke fabrics: spoke->spoke rides the hub)
    """

    gbps: float = 10.0
    hourly_degrade_prob: float = 0.0
    degraded_gbps: float = 1.0
    nic_gbps: Optional[Tuple[float, ...]] = None
    nic_in_gbps: Optional[Tuple[float, ...]] = None
    link_gbps: Optional[Tuple[Tuple[Optional[float], ...], ...]] = None
    brownout_scope: str = "fabric"
    sharing: str = "conservative"
    multi_hop: bool = False

    @property
    def is_uniform(self) -> bool:
        return (self.nic_gbps is None and self.nic_in_gbps is None
                and self.link_gbps is None)

    def build_topology(self, n_sites: int, days: int, seed: int) -> "WanTopology":
        """Materialize the runtime :class:`WanTopology` (arrays + calendar).

        The fabric-scope brownout calendar reproduces the seed's flaky-WAN
        stream bit-for-bit: ``default_rng(seed + 31).random(days*48 + 1) <
        prob``.
        """
        def per_site(vals, what):
            arr = np.asarray(vals, dtype=np.float64) * 1e9
            if arr.shape != (n_sites,):
                raise ValueError(
                    f"{what} must have one entry per site ({n_sites}), "
                    f"got shape {arr.shape}")
            return arr

        if self.nic_gbps is not None:
            nic_out = per_site(self.nic_gbps, "nic_gbps")
        else:
            nic_out = np.full(n_sites, self.gbps * 1e9, dtype=np.float64)
        if self.nic_in_gbps is not None:
            nic_in = per_site(self.nic_in_gbps, "nic_in_gbps")
        else:
            nic_in = nic_out.copy()

        link = np.full((n_sites, n_sites), np.inf, dtype=np.float64)
        if self.link_gbps is not None:
            rows = self.link_gbps
            if len(rows) != n_sites or any(len(r) != n_sites for r in rows):
                raise ValueError(
                    f"link_gbps must be a {n_sites}x{n_sites} matrix")
            for s, row in enumerate(rows):
                for d, cap in enumerate(row):
                    if cap is not None:
                        link[s, d] = float(cap) * 1e9

        mask = None
        if self.hourly_degrade_prob > 0.0:
            n_hours = int(days * 24 * 2) + 1  # seed calendar length (2x slack)
            rng = np.random.default_rng(seed + 31)
            if self.brownout_scope == "fabric":
                mask = rng.random(n_hours) < self.hourly_degrade_prob
            elif self.brownout_scope == "per-link":
                mask = rng.random((n_hours, n_sites, n_sites)) < self.hourly_degrade_prob
                mask[:, np.arange(n_sites), np.arange(n_sites)] = False
            else:
                raise ValueError(
                    f"brownout_scope must be 'fabric' or 'per-link', "
                    f"got {self.brownout_scope!r}")
        return WanTopology(nic_out, nic_in, link, mask,
                           self.degraded_bps, self.sharing, self.multi_hop)

    @property
    def degraded_bps(self) -> float:
        return self.degraded_gbps * 1e9


# ---------------------------------------------------------------------------
# Runtime topology
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class WanTopology:
    """Materialized WAN: per-site NIC rate arrays, per-link capacity matrix
    and an optional hourly brownout calendar.  All rates in bits/s."""

    nic_out_bps: np.ndarray  # (n,) egress NIC per site
    nic_in_bps: np.ndarray  # (n,) ingress NIC per site
    link_bps: np.ndarray  # (n, n); inf = NIC-limited, 0 = no link
    brownout_mask: Optional[np.ndarray] = None  # (n_hours,) or (n_hours, n, n)
    degraded_bps: float = 0.0
    sharing: str = "conservative"  # or "waterfill" (full max-min)
    multi_hop: bool = False  # allow one-relay src->h->dst paths

    def __post_init__(self):
        n = len(self.nic_out_bps)
        if self.nic_in_bps.shape != (n,) or self.link_bps.shape != (n, n):
            raise ValueError("inconsistent WanTopology array shapes")
        if self.sharing not in ("conservative", "waterfill"):
            raise ValueError(
                f"sharing must be 'conservative' or 'waterfill', "
                f"got {self.sharing!r}")

    # -- basic facts ---------------------------------------------------------
    @property
    def n_sites(self) -> int:
        return len(self.nic_out_bps)

    @classmethod
    def uniform(cls, n_sites: int, nic_bps: float) -> "WanTopology":
        """The seed model: one symmetric NIC rate, uncapped links."""
        nic = np.full(n_sites, float(nic_bps))
        return cls(nic, nic.copy(), np.full((n_sites, n_sites), np.inf))

    @property
    def is_uniform(self) -> bool:
        return bool(
            np.isinf(self.link_bps).all()
            and (self.nic_out_bps == self.nic_out_bps[0]).all()
            and (self.nic_in_bps == self.nic_out_bps[0]).all()
        )

    # -- brownout calendar ---------------------------------------------------
    def _hour(self, t: float) -> int:
        return min(int(t // HOUR), len(self.brownout_mask) - 1)

    def _state_key(self, t: float):
        """Hashable id of the link state at ``t`` (fabric: one bool; per-
        link: the hour index) — the cache key for derived capacity arrays."""
        m = self.brownout_mask
        if m is None:
            return None
        h = self._hour(t)
        return bool(m[h]) if m.ndim == 1 else h

    @cached_property
    def _resource_cache(self) -> dict:
        return {}

    def resources_at(self, t: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(nic_out, nic_in, link) capacities at sim-time ``t`` with the
        brownout calendar applied.  Fabric scope degrades every resource
        (shared-backbone brownout — reduces to the seed's degraded NIC
        rate); per-link scope degrades only the affected links.  Cached per
        link state; treat the returned arrays as read-only."""
        key = self._state_key(t)
        cached = self._resource_cache.get(key)
        if cached is not None:
            return cached
        out, in_, link = self.nic_out_bps, self.nic_in_bps, self.link_bps
        m = self.brownout_mask
        if m is not None:
            if m.ndim == 1:  # fabric scope
                if key:
                    d = self.degraded_bps
                    out, in_, link = (np.minimum(out, d), np.minimum(in_, d),
                                      np.minimum(link, d))
            else:
                bad = m[self._hour(t)]
                if bad.any():
                    link = np.where(bad, np.minimum(link, self.degraded_bps),
                                    link)
        res = (out, in_, link)
        self._resource_cache[key] = res
        return res

    @cached_property
    def _brownout_edges(self) -> List[float]:
        """Times at which the brownout state changes (hour boundaries)."""
        m = self.brownout_mask
        if m is None:
            return []
        return [h * HOUR for h in range(1, len(m))
                if np.any(m[h] != m[h - 1])]

    def next_transition(self, t: float) -> float:
        """Next sim-time the link state changes (inf if never) — an event
        source for the next-event engine."""
        edges = self._brownout_edges
        i = bisect.bisect_right(edges, t)
        return edges[i] if i < len(edges) else float("inf")

    def nic_bps_at(self, t: float) -> float:
        """Fabric NIC rate at ``t`` for (near-)uniform topologies — the
        legacy ``ClusterSimulator._nic_bps`` scalar."""
        return float(self.resources_at(t)[0].max())

    # -- multi-hop relay table -----------------------------------------------
    @cached_property
    def relay(self) -> Optional[np.ndarray]:
        """(n, n) relay table for ``multi_hop`` fabrics: ``relay[s, d]`` is
        the relay site ``h`` when the one-hop path ``s -> h -> d`` has
        strictly more *base* capacity (min over all six traversed
        resources) than the direct link, else ``-1`` (direct).  Chosen
        from base (structural) capacities so the routing is deterministic
        across brownouts; among equal-capacity relays the lowest ``h``
        wins.  ``None`` when multi-hop is off — every query then takes
        the single-leg fast path unchanged."""
        if not self.multi_hop:
            return None
        n = self.n_sites
        out, in_, link = self.nic_out_bps, self.nic_in_bps, self.link_bps
        rel = np.full((n, n), -1, dtype=np.int64)
        for s in range(n):
            for d in range(n):
                if s == d:
                    continue
                best = min(out[s], in_[d], link[s, d])
                for h in range(n):
                    if h == s or h == d:
                        continue
                    cap = min(out[s], in_[h], link[s, h],
                              out[h], in_[d], link[h, d])
                    if cap > best:
                        best = cap
                        rel[s, d] = h
        return rel

    def _path(self, src: int, dst: int) -> Tuple[Tuple[int, int], ...]:
        """The legs a ``src -> dst`` flow traverses: ``((src, dst),)``
        direct, or ``((src, h), (h, dst))`` through the relay."""
        r = self.relay
        if r is None:
            return ((src, dst),)
        h = int(r[src, dst])
        if h < 0:
            return ((src, dst),)
        return ((src, h), (h, dst))

    # -- capacity / sharing --------------------------------------------------
    def capacity(self, src: int, dst: int, t: float) -> float:
        """Uncontended point-to-point capacity src -> dst at time t (over
        the relay path on multi-hop fabrics)."""
        out, in_, link = self.resources_at(t)
        return float(min(
            min(out[a], in_[b], link[a, b])
            for a, b in self._path(src, dst)))

    def reachable(self, src: int, dst: int) -> bool:
        """Whether src -> dst has any *structural* capacity (base NICs and
        link, brownouts ignored — a browned-out link recovers, a 0-capacity
        link never does).  Migrations to unreachable sites are invalid.
        On multi-hop fabrics a zero direct link with a live relay path is
        reachable."""
        if min(self.nic_out_bps[src], self.nic_in_bps[dst],
               self.link_bps[src, dst]) > 0.0:
            return True
        r = self.relay
        return r is not None and r[src, dst] >= 0

    @cached_property
    def _capacity_cache(self) -> dict:
        return {}

    def capacity_matrix(self, t: float) -> np.ndarray:
        """Uncontended (src, dst) capacity matrix at time t (cached per
        link state; treat as read-only)."""
        key = self._state_key(t)
        cached = self._capacity_cache.get(key)
        if cached is not None:
            return cached
        out, in_, link = self.resources_at(t)
        cap = np.minimum(np.minimum(out[:, None], in_[None, :]), link)
        r = self.relay
        if r is not None:
            for s, d in zip(*np.nonzero(r >= 0)):
                h = int(r[s, d])
                cap[s, d] = min(out[s], in_[h], link[s, h],
                                out[h], in_[d], link[h, d])
        self._capacity_cache[key] = cap
        return cap

    def shared_rates(
        self, flows: Sequence[Tuple[int, int]], t: float = 0.0
    ) -> np.ndarray:
        """Effective bps granted to each flow (aligned with ``flows``),
        under the topology's ``sharing`` model.

        ``"conservative"``: each flow gets the minimum equal split over the
        three resources it traverses — ``min(out[s]/flows(out_s),
        in[d]/flows(in_d), link[s,d]/flows(link_sd))``.  Never
        oversubscribes any resource; reduces exactly to
        ``min(nic/src_flows, nic/dst_flows)`` on uniform topologies.

        ``"waterfill"``: full max-min (see :meth:`_waterfill_rates`) —
        per-flow rates dominate the conservative split.

        On multi-hop fabrics a relayed flow traverses *both* legs'
        resources (six in total) and its grant is the minimum split over
        all of them — relayed traffic and direct hub traffic contend for
        the same hub NICs, so no resource is ever oversubscribed."""
        if not len(flows):
            return np.zeros(0)
        out, in_, link = self.resources_at(t)
        if self.sharing == "waterfill":
            return self._waterfill_rates(flows, out, in_, link)
        if self.relay is not None:
            paths = [self._path(s, d) for s, d in flows]
            n_src: Dict[int, int] = {}
            n_dst: Dict[int, int] = {}
            n_link: Dict[Tuple[int, int], int] = {}
            for path in paths:
                for a, b in path:
                    n_src[a] = n_src.get(a, 0) + 1
                    n_dst[b] = n_dst.get(b, 0) + 1
                    n_link[(a, b)] = n_link.get((a, b), 0) + 1
            return np.array([
                min(min(out[a] / n_src[a], in_[b] / n_dst[b],
                        link[a, b] / n_link[(a, b)]) for a, b in path)
                for path in paths
            ])
        n_src = {}
        n_dst = {}
        n_link = {}
        for s, d in flows:
            n_src[s] = n_src.get(s, 0) + 1
            n_dst[d] = n_dst.get(d, 0) + 1
            n_link[(s, d)] = n_link.get((s, d), 0) + 1
        return np.array([
            min(out[s] / n_src[s], in_[d] / n_dst[d],
                link[s, d] / n_link[(s, d)])
            for s, d in flows
        ])

    @staticmethod
    def _waterfill_table(
        paths: Sequence[Tuple[Tuple[int, int], ...]],
        out: np.ndarray, in_: np.ndarray, link: np.ndarray,
    ) -> Tuple[List[float], List[List[int]], Dict[Tuple, int]]:
        """Resource table for :meth:`_waterfill_solve`: capacities + member
        flow indices per (src NIC, dst NIC, link) resource, over each
        flow's leg path (one leg direct, two through a relay;
        infinite-capacity links are omitted — they can never bind)."""
        caps: List[float] = []
        members: List[List[int]] = []
        index: Dict[Tuple, int] = {}

        def add(key: Tuple, cap: float, i: int) -> None:
            k = index.get(key)
            if k is None:
                k = len(caps)
                index[key] = k
                caps.append(float(cap))
                members.append([])
            members[k].append(i)

        for i, path in enumerate(paths):
            for a, b in path:
                add(("o", a), out[a], i)
                add(("i", b), in_[b], i)
                if np.isfinite(link[a, b]):
                    add(("l", a, b), link[a, b], i)
        return caps, members, index

    def _waterfill_rates(
        self,
        flows: Sequence[Tuple[int, int]],
        out: np.ndarray, in_: np.ndarray, link: np.ndarray,
    ) -> np.ndarray:
        paths = [self._path(s, d) for s, d in flows]
        caps, members, _ = self._waterfill_table(paths, out, in_, link)
        return self._waterfill_solve(len(flows), caps, members)

    @staticmethod
    def _waterfill_solve(
        m: int, caps: List[float], members: List[List[int]],
    ) -> np.ndarray:
        """Max-min fair water-filling over the (src NIC, dst NIC, link)
        resource hypergraph.

        Iterate: raise every unfrozen flow's rate in lockstep by the
        smallest per-resource headroom-per-unfrozen-flow increment,
        freeze the flows crossing each resource that saturates, and
        redistribute the residual among the rest until every flow is
        frozen.  Flows through a zero-capacity resource freeze at 0 in the
        first round.

        A round that moves no finite resource's ``alloc`` and freezes no
        flow would repeat forever (a subnormal capacity, whose increment
        per flow rounds to 0 or is lost beside ``alloc``): such a round
        freezes the flows of the resources that set its increment, which
        are full to the last bit.  Every other round is the reference's,
        so wherever its loop ends the rates are its own, bit for bit."""
        rate = np.zeros(m)
        frozen = np.zeros(m, dtype=bool)
        alloc = np.zeros(len(caps))
        while not frozen.all():
            best = float("inf")
            n_active = [0] * len(caps)
            incs = {}
            for k, mem in enumerate(members):
                n_act = sum(1 for i in mem if not frozen[i])
                n_active[k] = n_act
                if n_act and np.isfinite(caps[k]):
                    inc = max(0.0, caps[k] - alloc[k]) / n_act
                    incs[k] = inc
                    if inc < best:
                        best = inc
            if not np.isfinite(best):  # only inf-capacity resources left
                break  # unreachable with finite NICs; safety net
            rate[~frozen] += best
            before, n_frozen = alloc.copy(), int(frozen.sum())
            for k, mem in enumerate(members):
                if not n_active[k]:
                    continue
                alloc[k] += best * n_active[k]
                if np.isfinite(caps[k]) and alloc[k] >= caps[k] * (1 - 1e-12):
                    for i in mem:
                        frozen[i] = True
            if int(frozen.sum()) == n_frozen and all(alloc[k] == before[k] for k in incs):
                for k, inc in incs.items():
                    if inc == best:
                        frozen[members[k]] = True
        return rate

    def advertised_matrix(
        self, t: float = 0.0, flows: Sequence[Tuple[int, int]] = ()
    ) -> np.ndarray:
        """Policy-facing (src, dst) bandwidth matrix under the *current*
        flow set — what a transfer on that pair is being granted right now
        (idle resources advertise full capacity).  The same share model as
        :meth:`shared_rates`, so the snapshot always agrees with the
        transfer loop.

        Under ``sharing="waterfill"`` pairs carrying flows advertise their
        water-filled grant (all flows on one pair are symmetric, hence
        equal); idle pairs advertise the rate a *new* flow on that pair
        would be granted (post-admission water-fill) — under max-min the
        "current grant on an idle pair" is undefined, and the
        post-admission rate is the honest, strictly-less-optimistic
        number."""
        if not len(flows):
            return self.capacity_matrix(t)
        out, in_, link = self.resources_at(t)
        if self.sharing == "waterfill":
            m = len(flows)
            paths = [self._path(s, d) for s, d in flows]
            caps, members, index = self._waterfill_table(paths, out, in_, link)
            rates = self._waterfill_solve(m, caps, members)
            adv = np.array(self.capacity_matrix(t), copy=True)
            loaded = {}
            for (s, d), r in zip(flows, rates):
                loaded[(s, d)] = float(r)
            for s in range(self.n_sites):
                for d in range(self.n_sites):
                    if s == d:
                        continue
                    if (s, d) in loaded:
                        adv[s, d] = loaded[(s, d)]
                    elif adv[s, d] > 0.0:
                        # post-admission solve for the idle pair: reuse the
                        # base resource table, appending only the candidate
                        # flow's own leg resources (no per-pair rebuild)
                        caps2 = list(caps)
                        members2 = [list(mem) for mem in members]
                        for a, b in self._path(s, d):
                            for key, cap in ((("o", a), out[a]),
                                             (("i", b), in_[b]),
                                             (("l", a, b), link[a, b])):
                                if key[0] == "l" and not np.isfinite(cap):
                                    continue
                                k = index.get(key)
                                if k is None:
                                    caps2.append(float(cap))
                                    members2.append([m])
                                else:
                                    members2[k].append(m)
                        adv[s, d] = self._waterfill_solve(
                            m + 1, caps2, members2)[-1]
            return adv
        n = self.n_sites
        if self.relay is not None:
            # leg-aware current-grant matrix: count every flow on every
            # resource its path traverses, then advertise each pair the
            # min split over its own path (idle resources = full rate)
            n_src: Dict[int, int] = {}
            n_dst: Dict[int, int] = {}
            n_link: Dict[Tuple[int, int], int] = {}
            for s, d in flows:
                for a, b in self._path(s, d):
                    n_src[a] = n_src.get(a, 0) + 1
                    n_dst[b] = n_dst.get(b, 0) + 1
                    n_link[(a, b)] = n_link.get((a, b), 0) + 1
            adv = np.array(self.capacity_matrix(t), copy=True)
            for s in range(n):
                for d in range(n):
                    if s == d:
                        continue
                    adv[s, d] = min(
                        min(out[a] / max(n_src.get(a, 1), 1),
                            in_[b] / max(n_dst.get(b, 1), 1),
                            link[a, b] / max(n_link.get((a, b), 1), 1))
                        for a, b in self._path(s, d))
            return adv
        src_n = np.ones(n)
        dst_n = np.ones(n)
        link_n = np.ones((n, n))
        for s, d in flows:
            src_n[s] += 1.0
            dst_n[d] += 1.0
            link_n[s, d] += 1.0
        # counts start at 1 (idle = full rate), so subtract the extra 1
        # wherever a flow was actually counted
        src_n[src_n > 1] -= 1.0
        dst_n[dst_n > 1] -= 1.0
        link_n[link_n > 1] -= 1.0
        return np.minimum(
            np.minimum((out / src_n)[:, None], (in_ / dst_n)[None, :]),
            link / link_n,
        )

    def post_admission_rate(
        self, src: int, dst: int,
        flows: Sequence[Tuple[int, int]] = (), t: float = 0.0,
    ) -> float:
        """The rate a NEW ``src -> dst`` transfer would actually be granted
        given the in-flight ``flows`` — the new flow itself dilutes every
        resource it traverses (the ``(flows+1)`` share the advertised
        matrix deliberately omits).  This is the number admission checks
        should use: the advertised matrix is the *current* grant and is
        systematically optimistic for a would-be transfer."""
        return float(self.shared_rates(list(flows) + [(src, dst)], t)[-1])


# ---------------------------------------------------------------------------
# Link-matrix builders for common fabrics
# ---------------------------------------------------------------------------


def hub_spoke_links(
    n_sites: int, hub: int = 0, spoke_gbps: float = 1.0
) -> Tuple[Tuple[Optional[float], ...], ...]:
    """Hub-and-spoke link matrix: hub-adjacent links NIC-limited (None),
    direct spoke-to-spoke links capped at ``spoke_gbps``."""
    rows = []
    for s in range(n_sites):
        row = []
        for d in range(n_sites):
            row.append(None if (s == hub or d == hub or s == d) else spoke_gbps)
        rows.append(tuple(row))
    return tuple(rows)


def partitioned_links(
    groups: Sequence[Sequence[int]], inter_gbps: float = 0.25
) -> Tuple[Tuple[Optional[float], ...], ...]:
    """Partitioned fabric: NIC-limited links inside each group, thin
    ``inter_gbps`` links between groups (0 = fully partitioned)."""
    n = sum(len(g) for g in groups)
    part = {}
    for gi, g in enumerate(groups):
        for s in g:
            part[s] = gi
    if sorted(part) != list(range(n)):
        raise ValueError("groups must partition range(n_sites)")
    rows = []
    for s in range(n):
        rows.append(tuple(
            None if part[s] == part[d] else inter_gbps for d in range(n)))
    return tuple(rows)


__all__ = [
    "WanProfile", "WanTopology", "hub_spoke_links", "partitioned_links",
]
