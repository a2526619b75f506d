"""Migration policies, including the paper's feasibility-aware scheduler
(Algorithm 1), behind a typed event-driven control API.

Contract: ``Policy.decide(state: ClusterState) -> list[Action]`` evaluated
at every orchestrator tick (Δt).  The :class:`~repro_torch.core.state.ClusterState`
snapshot carries live jobs (with *measured* checkpoint sizes), per-site
renewable forecasts, the advertised WAN bandwidth matrix (per-NIC fair
share), and site load; actions are the typed verbs of
:mod:`repro_torch.core.actions` (``Migrate``/``Defer``/``Pause``/``Resume``/
``Throttle``).

Policies live in a registry: decorate a class with
``@register_policy("name", aliases=(...), config=SomePolicyConfig)`` and it
becomes constructible via ``make_policy(name, config=..., **overrides)`` and
usable from ``run_policy_comparison``, benchmarks and examples.  Structured
``PolicyConfig`` dataclasses carry per-policy knobs (e.g. stochastic
feasibility ``eps``/``forecast_sigma_s``) through every entry point.

Built-ins:

  static            never migrates (Table VI row 1)
  energy-only       chases renewable windows, no feasibility filter (row 2)
  feasibility-aware Algorithm 1: hard feasibility filter, then utility
                    maximization within the feasible set (row 3)
  oracle            feasibility-aware with σ=0 forecasts (Table VIII row 4)
  grid-throttle     beyond-paper demand response: Throttle jobs on grid
                    power, restore full power inside renewable windows
  defer-to-window   beyond-paper: Defer queued jobs at dark sites until the
                    site's next forecast window start
  plan-ahead        beyond-paper: multi-step plans over ``state.forecast``
                    — Algorithm 1 hardened against forecast link outages,
                    Pause-for-window sequences, pre-emptive evacuation
                    ahead of uplink brownouts, horizon-bounded Defer
  receding-horizon  beyond-paper: signal-aware multi-window plan search —
                    every tick, stay/park(k)/migrate(d) branches scored in
                    forecast gCO2 (grid-signal stacks), demand-response
                    throttling through carbon peaks and curtail requests
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core import feasibility as fz
from repro_torch.core import policy_kernels as pk
from repro_torch.core.actions import Action, Defer, Migrate, Pause, Resume, Throttle
from repro_torch.core.policy_kernels import _norm_ppf_cached
from repro_torch.core.state import (
    STATE_PAUSED, STATE_QUEUED, STATE_RUNNING, ClusterState, JobSoA, JobView,
    SiteView,
)
from repro_torch.device import DeviceLike, resolve

# Backwards-looking alias: the pre-redesign name for the snapshot type.
OrchestratorContext = ClusterState


# ---------------------------------------------------------------------------
# Policy configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicyConfig:
    """Base for structured per-policy parameters (empty for static/energy)."""


@dataclass(frozen=True)
class FeasibilityConfig(PolicyConfig):
    """Algorithm 1 knobs (§V.B, §VI.H)."""

    alpha: float = fz.ALPHA
    gamma: float = 1.0  # renewable weight (benefit term)
    beta: float = 1.0  # congestion weight
    queue_penalty_s: float = 7200.0  # expected wait per unit load
    min_benefit_s: float = 1500.0  # hysteresis: don't move for marginal wins
    eps: float = 0.0  # >0 enables stochastic feasibility (§VI.H)
    forecast_sigma_s: float = 0.0
    fault_aware: bool = True  # mask blacked-out sites / dead links


@dataclass(frozen=True)
class ThrottleConfig(PolicyConfig):
    power_frac: float = 0.5  # demand-response level on grid power


@dataclass(frozen=True)
class DeferConfig(PolicyConfig):
    max_wait_s: float = 4 * 3600.0  # never hold a queued job longer than this


@dataclass(frozen=True)
class RecedingHorizonConfig(PolicyConfig):
    """Knobs for the signal-aware receding-horizon planner."""

    alpha: float = fz.ALPHA
    plan_windows: int = 4  # K: how many future windows a plan search tries
    delay_cost_g_per_s: float = 0.01  # gCO2-equivalent per second of delay
    min_benefit_g: float = 60.0  # hysteresis: act only for real gram wins
    min_park_compute_s: float = 1800.0  # don't park nearly-done jobs
    max_park_s: float = 12 * 3600.0  # Pause-plan lookahead bound
    max_wait_s: float = 6 * 3600.0  # Defer bound for queued jobs
    arrival_margin_s: float = 1800.0  # forecast-noise margin on arrivals
    peak_threshold_g: float = 430.0  # Throttle grid compute above this
    dr_power_frac: float = 0.3  # throttle level during peaks / DR spans
    price_weight_g_per_usd: float = 0.0  # >0 folds $ into the objective
    battery_aware: bool = False  # credit stored kWh against dark spans
    fault_aware: bool = True  # mask blacked-out sites / dead links


@dataclass(frozen=True)
class PlanAheadConfig(PolicyConfig):
    """Knobs for the forecast-driven planner (Algorithm 1 + lookahead)."""

    alpha: float = fz.ALPHA
    gamma: float = 1.0
    beta: float = 1.0
    queue_penalty_s: float = 7200.0
    min_benefit_s: float = 1500.0
    max_wait_s: float = 4 * 3600.0  # Defer bound (as defer-to-window)
    pause_horizon_s: float = 4 * 3600.0  # Pause-for-window lookahead
    min_pause_compute_s: float = 1800.0  # don't park nearly-done jobs
    arrival_margin_s: float = 1800.0  # forecast-noise margin on arrivals
    fault_aware: bool = True  # mask blacked-out sites / dead links


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type["Policy"]] = {}
_ALIASES: Dict[str, str] = {}
_CONFIGS: Dict[str, Type[PolicyConfig]] = {}


def register_policy(name: str, *, aliases: Tuple[str, ...] = (),
                    config: Type[PolicyConfig] = PolicyConfig):
    """Class decorator: add a Policy to the registry under ``name``
    (stored normalized — lowercase, dashes — so lookups always hit)."""

    key = _norm(name)

    def deco(cls: Type["Policy"]) -> Type["Policy"]:
        cls.name = key
        _REGISTRY[key] = cls
        _CONFIGS[key] = config
        for a in aliases:
            _ALIASES[_norm(a)] = key
        return cls

    return deco


def _norm(name: str) -> str:
    return name.lower().replace("_", "-")


def available_policies() -> List[str]:
    return sorted(_REGISTRY)


def policy_config_cls(name: str) -> Type[PolicyConfig]:
    return _CONFIGS[_resolve(name)]


def _resolve(name: str) -> str:
    key = _norm(name)
    key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown policy {name!r}; available: {', '.join(available_policies())}"
        )
    return key


def make_policy(name: str, config: Optional[PolicyConfig] = None, *,
                device: DeviceLike = None, **kw) -> "Policy":
    """Instantiate a registered policy.

    ``config`` is a :class:`PolicyConfig` matching the policy (its fields are
    splatted into the constructor); ``**kw`` overrides individual fields.
    ``device`` is where a policy that scores with the K4 decide kernel
    (``scores_on_device``) runs it — ``None`` is the card; the other
    policies run on the host and ignore it.
    """
    key = _resolve(name)
    if config is not None:
        kw = {**dataclasses.asdict(config), **kw}
    cls = _REGISTRY[key]
    if cls.scores_on_device:
        kw["device"] = device
    return cls(**kw)


# ---------------------------------------------------------------------------
# Algorithm 1 building blocks (shared by feasibility-aware and plan-ahead)
# ---------------------------------------------------------------------------


def algorithm1_grid(state: ClusterState, candidates: List[JobView], *,
                    alpha: float, eps: float = 0.0,
                    forecast_sigma_s: float = 0.0, bw_grid=None):
    """Stage 1, vectorized: one feasibility evaluation over the whole
    (candidate × destination) grid per tick.  ``bw_grid`` overrides the
    snapshot's advertised rows (plan-ahead hardens them against forecast
    outages first); ``eps`` > 0 with ``forecast_sigma_s`` > 0 swaps the
    deterministic time gate for the stochastic one (§VI.H).  Returns
    ``(ok_grid, t_transfer_grid)``."""
    import numpy as np

    sizes = np.array([j.ckpt_bytes for j in candidates])[:, None]
    t_loads = np.array([j.t_load_s for j in candidates])[:, None]
    if bw_grid is None:
        bw_grid = np.asarray(state.bandwidth_bps)[
            np.array([j.site for j in candidates], dtype=np.int64), :
        ]  # (n_candidates, n_sites)
    windows = state.site_window_s[None, :]
    v = fz.evaluate(sizes, bw_grid, windows, alpha=alpha, t_load_s=t_loads)
    if eps > 0.0 and forecast_sigma_s > 0.0:
        ok_grid = (
            np.asarray(
                fz.stochastic_feasible(
                    sizes, bw_grid, windows, forecast_sigma_s,
                    eps=eps, alpha=alpha, t_load_s=t_loads,
                )
            )
            & np.asarray(v.energy_ok)
            & (np.asarray(v.workload_class) != 2)
        )
    else:
        ok_grid = np.asarray(v.feasible)
    return ok_grid, np.asarray(v.t_transfer_s)


def best_destination(state: ClusterState, job: JobView, ok_row,
                     t_transfer_row, reserved: Dict[int, int], *,
                     gamma: float, beta: float, queue_penalty_s: float,
                     min_benefit_s: float) -> Optional[int]:
    """Stage 2: utility maximization inside the feasible set.

        benefit(d) = γ · expected grid-seconds avoided
                     − β · queue penalty · (load(d) − load(s))

    ``reserved`` tracks same-tick slot commitments so concurrent decisions
    do not herd.  Returns the argmax destination sid (ties by transfer
    time) or None when nothing beats ``max(t_cost, min_benefit_s)``."""
    cur = state.site(job.site)
    best: Optional[Tuple[float, float, int]] = None  # (-benefit, t_transfer, sid)
    for dest in state.sites:
        if dest.sid == job.site:
            continue
        if not ok_row[dest.sid]:
            continue
        window = dest.window_remaining_s
        t_transfer = float(t_transfer_row[dest.sid])
        t_cost = t_transfer + job.t_load_s + fz.T_DOWNTIME_S
        cur_green_s = cur.window_remaining_s if cur.renewable_active else 0.0
        dest_green_s = min(window, job.remaining_compute_s)
        grid_seconds_avoided = max(
            0.0, dest_green_s - min(cur_green_s, job.remaining_compute_s))
        dest_load = (dest.busy + dest.queued
                     + reserved[dest.sid]) / max(dest.slots, 1)
        # symmetric congestion term: moving toward a less-loaded site is
        # itself a benefit (contention-aware placement, §V.D.2)
        benefit = (
            gamma * grid_seconds_avoided
            - beta * queue_penalty_s * (dest_load - cur.load)
        )
        if dest.free_slots - reserved[dest.sid] <= 0:
            benefit -= queue_penalty_s  # would have to queue
        if benefit <= max(t_cost, min_benefit_s):
            continue
        key = (-benefit, t_transfer, dest.sid)
        if best is None or key < best:
            best = key
    return best[2] if best is not None else None


# ---------------------------------------------------------------------------
# Vectorized kernels (SoA fast path; the scalar functions above are the
# parity oracles — tests/test_vectorized.py asserts identical Action lists)
# ---------------------------------------------------------------------------

def feasibility_grid_arrays(
    sizes, t_loads, bw_grid, windows, *, alpha: float, eps: float = 0.0,
    forecast_sigma_s: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Algorithm 1 stage 1 as one lean numpy pass over SoA columns.

    ``sizes``/``t_loads`` are ``(k, 1)``, ``bw_grid`` ``(k, n)``,
    ``windows`` ``(n,)`` or ``(1, n)``.  Bit-identical to
    :func:`algorithm1_grid` (which routes through ``fz.evaluate`` and its
    NamedTuple) but without the per-call dispatch and intermediate
    verdicts.  Returns ``(ok_grid, t_transfer_grid)``.
    """
    with np.errstate(divide="ignore"):
        t_transfer = 8.0 * sizes / bw_grid
    t_cost = t_transfer + t_loads + fz.T_DOWNTIME_S
    energy_ok = (fz.P_SYS_KW / fz.P_NODE_KW) * t_transfer < windows
    not_c = t_transfer < fz.CLASS_B_MAX_S
    if eps > 0.0 and forecast_sigma_s > 0.0:
        # stochastic gate (§VI.H): deterministic check against the lower
        # eps-quantile of the window (fz.stochastic_feasible, numpy path)
        window_lo = windows + _norm_ppf_cached(eps) * forecast_sigma_s
        time_ok = t_cost < alpha * np.maximum(window_lo, 0.0)
    else:
        time_ok = t_cost < alpha * windows
    return time_ok & energy_ok & not_c, t_transfer


def benefit_grid_arrays(
    state: ClusterState, cand: np.ndarray, t_transfer_grid: np.ndarray, *,
    gamma: float, beta: float, queue_penalty_s: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stage 2's benefit, for every (candidate, destination) pair at once,
    with zero same-tick reservations (the common case — reservations only
    exist after a migration was already committed this tick, and those rare
    follow-up rows fall back to the scalar :func:`best_destination`).
    Arithmetic mirrors the scalar path op for op.  Returns
    ``(benefit_grid, t_cost_grid)``."""
    soa = state.soa
    W = state.site_window_s
    s_i = soa.site[cand]
    rem = soa.remaining_s[cand][:, None]
    t_cost = t_transfer_grid + soa.t_load_s[cand][:, None] + fz.T_DOWNTIME_S
    cur_green = np.where(state.site_renewable[s_i], W[s_i], 0.0)[:, None]
    dest_green = np.minimum(W[None, :], rem)
    avoided = np.maximum(0.0, dest_green - np.minimum(cur_green, rem))
    benefit = (gamma * avoided
               - (beta * queue_penalty_s)
               * (state.site_bq_load[None, :] - state.site_load[s_i][:, None]))
    benefit = np.where(state.site_free_slots[None, :] <= 0,
                       benefit - queue_penalty_s, benefit)
    return benefit, t_cost


def pick_best_grid(
    benefit: np.ndarray, t_transfer_grid: np.ndarray, valid: np.ndarray,
) -> np.ndarray:
    """Per-row argbest destination under the scalar tie-break key
    ``(-benefit, t_transfer, sid)`` — max benefit, ties by transfer time,
    then lowest site id.  Returns ``(k,)`` destination sids, ``-1`` where
    no destination is valid."""
    b = np.where(valid, benefit, -np.inf)
    mb = b.max(axis=1)
    tie = valid & (b == mb[:, None])
    tt = np.where(tie, t_transfer_grid, np.inf)
    tie = tie & (tt == tt.min(axis=1)[:, None])
    return np.where(np.isfinite(mb), tie.argmax(axis=1), -1)


_ARANGE: Dict[int, np.ndarray] = {}


def _arange(n: int) -> np.ndarray:
    got = _ARANGE.get(n)
    if got is None:
        got = _ARANGE[n] = np.arange(n)
    return got


def _row_view(soa: JobSoA, i: int) -> JobView:
    """Materialize one JobView row (the reserved-aware scalar fallback
    hands it to :func:`best_destination`)."""
    from repro_torch.core.state import _STATE_NAMES

    return JobView(int(soa.jids[i]), int(soa.site[i]),
                   float(soa.ckpt_bytes[i]), float(soa.remaining_s[i]),
                   float(soa.t_load_s[i]), state=_STATE_NAMES[soa.state[i]],
                   eligible=bool(soa.eligible[i]),
                   power_frac=float(soa.power_frac[i]),
                   defer_until_s=float(soa.defer_until_s[i]))


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


class Policy:
    name = "base"

    def decide(self, state: ClusterState) -> List[Action]:
        raise NotImplementedError

    def decide_batch(self, states: Sequence[ClusterState]) -> List[List[Action]]:
        """Decide for many independent cells at once (the batched sweep
        runner's entry point).  The default just loops :meth:`decide`;
        grid policies override it to score every cell's candidate rows in
        one fused :mod:`repro_torch.core.policy_kernels` pass.  Policies must
        be stateless w.r.t. ``self`` (all built-ins are): the runner
        calls one instance for every cell of a config-identical group."""
        return [self.decide(s) for s in states]

    # Comparison harnesses use this instead of string-matching on the name.
    wants_oracle_forecast = False
    # True for the policies that score migrations with the K4 decide
    # kernel; they carry a ``device`` field (see ``make_policy``).
    scores_on_device = False


@register_policy("static")
class StaticPolicy(Policy):
    """Fixed placement, no inter-site coordination (§VII.E baseline 1)."""

    def decide(self, state: ClusterState) -> List[Action]:
        return []


@register_policy("energy-only", aliases=("energyonly",))
class EnergyOnlyPolicy(Policy):
    """Migrate whenever renewable energy is available elsewhere, without
    feasibility constraints (§VII.E baseline 2). Herds onto the greenest
    site; initiates transfers that cannot finish inside windows."""

    def decide(self, state: ClusterState) -> List[Action]:
        """Vectorized: candidates are running+eligible jobs at dark sites;
        since a candidate's own site is never green, the per-job green list
        of the scalar oracle is one shared site set."""
        soa = state.soa
        if soa.count(STATE_RUNNING) == 0:
            return []
        renew = state.site_renewable
        cand = ((soa.state == STATE_RUNNING) & soa.eligible
                & ~renew[soa.site]).nonzero()[0]
        if not len(cand):
            return []
        # spread over whatever is green right now (hash placement), with
        # only a stale capacity check and NO feasibility filter (§VII.E:
        # 'lacks awareness of transfer-time or energy-cost limits'):
        # transfers near window end, Class C checkpoints and transient
        # over-subscription all happen.
        greens = np.flatnonzero(
            renew & (state.site_slots - state.site_busy > 0))
        if not len(greens):
            return []
        jids = soa.jids[cand]
        dests = greens[jids % len(greens)]
        return [Migrate(int(j), int(d)) for j, d in zip(jids, dests)]

    def decide_scalar(self, state: ClusterState) -> List[Action]:
        """Per-job reference implementation (parity oracle)."""
        out: List[Action] = []
        for job in state.migratable():
            cur = state.site(job.site)
            if cur.renewable_active:
                continue  # already green
            greens = [
                s for s in state.sites
                if s.renewable_active and s.sid != job.site
                and (s.slots - s.busy) > 0  # STALE capacity: ignores in-flight
            ]
            if not greens:
                continue
            dest = greens[job.jid % len(greens)]
            out.append(Migrate(job.jid, dest.sid))
        return out


@register_policy("feasibility-aware", aliases=("feasibility", "ours"),
                 config=FeasibilityConfig)
@dataclass
class FeasibilityAwarePolicy(Policy):
    """Paper Algorithm 1 (§V.B).

    Stage 1 — strict feasibility filter per (job, destination):
        T_cost = T_transfer + T_load + 0.4 s
        reject if T_cost > α · window(d)            (time)
        reject if T_breakeven > window(d)           (energy)
        reject if class(w) == C                     (§VI.D)
    Stage 2 — optimization inside the feasible set:
        benefit(d) = expected grid-seconds avoided − queue penalty
        migrate to argmax benefit iff benefit > T_cost, ties by T_transfer.
    """

    alpha: float = fz.ALPHA
    gamma: float = 1.0
    beta: float = 1.0
    queue_penalty_s: float = 7200.0
    min_benefit_s: float = 1500.0
    eps: float = 0.0
    forecast_sigma_s: float = 0.0
    fault_aware: bool = True
    device: DeviceLike = None  # where K4 runs; None is the card

    scores_on_device = True

    def __post_init__(self):
        self.device = resolve(self.device)

    def _params(self) -> pk.ScoreParams:
        return pk.ScoreParams(
            alpha=self.alpha, gamma=self.gamma, beta=self.beta,
            queue_penalty_s=self.queue_penalty_s,
            min_benefit_s=self.min_benefit_s, eps=self.eps,
            forecast_sigma_s=self.forecast_sigma_s)

    def _prep(self, state: ClusterState) -> Optional[np.ndarray]:
        """Candidate rows for one cell, or ``None`` when the tick is
        trivially migration-free (all-dark, nothing running)."""
        soa = state.soa
        # a migration must pass the energy gate T_BE < window (T_BE >= 0),
        # so no positive window anywhere means no feasible destination
        if not state.site_window_s.max() > 0.0:
            return None
        cand = ((soa.state == STATE_RUNNING) & soa.eligible).nonzero()[0]
        return cand if len(cand) else None

    def _fault_bw(self, state: ClusterState,
                  s_i: np.ndarray) -> Optional[np.ndarray]:
        """Bandwidth rows with fault-dead links zeroed, or ``None`` when
        no masking applies (fault-blind config, or no fault views seeded
        on the snapshot) — callers then use the advertised rows, keeping
        every fault-free digit byte-identical.  ``link_up`` composes
        endpoint blackouts with hard link failures, so a zeroed column
        also masks a blacked-out destination site (which otherwise
        advertises free slots and a live window — the trap a fault-blind
        policy walks into)."""
        if not self.fault_aware:
            return None
        lu = state.__dict__.get("link_up")
        if lu is None:
            return None
        return np.where(lu[s_i, :],
                        np.asarray(state.bandwidth_bps)[s_i, :], 0.0)

    def _commit(self, state: ClusterState, cand: np.ndarray,
                dest0: np.ndarray, ok: Optional[np.ndarray],
                tt: Optional[np.ndarray],
                bw_grid: Optional[np.ndarray] = None) -> List[Action]:
        """Turn argbest destinations into Actions under same-tick slot
        reservations, without leaving numpy.  Each commit to site ``d``
        bumps the reservation count and re-scores ONLY column ``d`` (a
        reserved column's benefit only drops, so every other row's
        argbest is provably unchanged); the later rows that pointed at
        ``d`` are then re-picked as one small grid.  The kernel path
        hands in ``ok=tt=None`` and the numpy grids are materialized
        lazily on the first commit (rare).  Emits exactly the Action
        list of the scalar reservation walk in :meth:`decide_scalar`."""
        if not (dest0 >= 0).any():  # the common tick: nothing moves
            return []
        soa = state.soa
        jids = soa.jids
        out: List[Action] = []
        dest = np.asarray(dest0).astype(np.int64, copy=True)
        res: Optional[np.ndarray] = None  # built on first commit
        k = len(cand)
        # re-picks only ever shrink the committed set (columns only get
        # worse), so the rows worth visiting are fixed up front
        for r in np.flatnonzero(dest >= 0):
            d = int(dest[r])
            if d < 0:  # re-picked away by an earlier reservation
                continue
            out.append(Migrate(int(jids[cand[r]]), d))
            if res is None:
                # first commit this tick: materialize the grids the
                # reservation-aware column updates need
                if ok is None:
                    if bw_grid is None:
                        bw_grid = state.bandwidth_bps[soa.site[cand], :]
                    ok, tt = feasibility_grid_arrays(
                        soa.ckpt_bytes[cand][:, None],
                        soa.t_load_s[cand][:, None],
                        bw_grid,
                        state.site_window_s[None, :], alpha=self.alpha,
                        eps=self.eps,
                        forecast_sigma_s=self.forecast_sigma_s)
                benefit, t_cost = benefit_grid_arrays(
                    state, cand, tt, gamma=self.gamma, beta=self.beta,
                    queue_penalty_s=self.queue_penalty_s)
                W = state.site_window_s
                s_i = soa.site[cand]
                rem = soa.remaining_s[cand]
                cur_green = np.where(state.site_renewable[s_i], W[s_i], 0.0)
                load_src = state.site_load[s_i]
                bq_raw = state.site_bq_raw
                res = np.zeros(len(W), dtype=np.int64)
            res[d] += 1
            # column d under the new reservation count, with the exact
            # scalar float-op order of best_destination
            dest_load = (int(bq_raw[d]) + int(res[d])) / max(
                int(state.site_slots[d]), 1)
            avoided = np.maximum(
                0.0, np.minimum(W[d], rem) - np.minimum(cur_green, rem))
            col = (self.gamma * avoided
                   - self.beta * self.queue_penalty_s
                   * (dest_load - load_src))
            if int(state.site_free_slots[d]) - int(res[d]) <= 0:
                col = col - self.queue_penalty_s  # would have to queue
            benefit[:, d] = col
            if r + 1 < k:
                stale = np.flatnonzero(dest[r + 1:] == d) + (r + 1)
                if len(stale):
                    valid = (ok[stale]
                             & (s_i[stale, None] != _arange(len(W))[None, :])
                             & (benefit[stale] > np.maximum(
                                 t_cost[stale], self.min_benefit_s)))
                    dest[stale] = pick_best_grid(
                        benefit[stale], tt[stale], valid)
        return out

    def decide(self, state: ClusterState) -> List[Action]:
        """Vectorized Algorithm 1: one whole-grid pass over the SoA
        columns by the K4 decide kernel on ``self.device``; rows decided
        after a same-tick reservation (rare) are re-picked on the host.
        Emits exactly the Action list of :meth:`decide_scalar`."""
        cand = self._prep(state)
        if cand is None:
            return []
        bw = self._fault_bw(state, state.soa.site[cand])
        dest0 = pk.score_rows([pk.rows_from_state(state, cand, bw)],
                              self._params(), self.device)[0]
        return self._commit(state, cand, dest0, None, None, bw)

    def decide_batch(self, states: Sequence[ClusterState]) -> List[List[Action]]:
        """All cells' candidate rows scored in ONE fused kernel pass
        (bit-identical to per-cell :meth:`decide` — see
        :mod:`repro_torch.core.policy_kernels` on padding lanes)."""
        cands = [self._prep(s) for s in states]
        live = [i for i, c in enumerate(cands) if c is not None]
        bws = [self._fault_bw(states[i], states[i].soa.site[cands[i]])
               for i in live]
        if any(b is not None for b in bws):
            # batch_from_states takes bw_grids all-or-nothing: fill the
            # unmasked cells with their advertised rows (element-identical)
            bws = [b if b is not None
                   else np.asarray(states[i].bandwidth_bps)[
                       states[i].soa.site[cands[i]], :]
                   for i, b in zip(live, bws)]
        else:
            bws = None
        dests = iter(pk.score_states([states[i] for i in live],
                                     [cands[i] for i in live],
                                     self._params(), bws, self.device))
        bw_by_cell = dict(zip(live, bws)) if bws is not None else {}
        out: List[List[Action]] = []
        for i, (s, c) in enumerate(zip(states, cands)):
            d0 = None if c is None else next(dests)
            out.append([] if d0 is None
                       else self._commit(s, c, d0, None, None,
                                         bw_by_cell.get(i)))
        return out

    def decide_scalar(self, state: ClusterState) -> List[Action]:
        """The per-job reference implementation (parity oracle for
        :meth:`decide`)."""
        candidates = state.migratable()
        if not candidates:
            return []
        bw = self._fault_bw(
            state, np.array([j.site for j in candidates], dtype=np.int64))
        ok_grid, t_transfer_grid = algorithm1_grid(
            state, candidates, alpha=self.alpha, eps=self.eps,
            forecast_sigma_s=self.forecast_sigma_s, bw_grid=bw)
        out: List[Action] = []
        # Track slot reservations within this tick so we do not herd.
        reserved: Dict[int, int] = {s.sid: 0 for s in state.sites}
        for i, job in enumerate(candidates):
            dest = best_destination(
                state, job, ok_grid[i], t_transfer_grid[i], reserved,
                gamma=self.gamma, beta=self.beta,
                queue_penalty_s=self.queue_penalty_s,
                min_benefit_s=self.min_benefit_s)
            if dest is not None:
                out.append(Migrate(job.jid, dest))
                reserved[dest] += 1
        return out


@register_policy("oracle", config=FeasibilityConfig)
@dataclass
class OraclePolicy(FeasibilityAwarePolicy):
    """Feasibility-aware under perfect (σ=0) forecasts (Table VIII row 4).
    The zero-noise forecaster is selected by the harness via
    ``wants_oracle_forecast``."""

    wants_oracle_forecast = True


@register_policy("grid-throttle", config=ThrottleConfig)
@dataclass
class GridThrottlePolicy(Policy):
    """Beyond-paper demand response: run at reduced power whenever a site is
    on grid electricity, full power inside renewable windows.  Exercises the
    ``Throttle`` action; never migrates."""

    power_frac: float = 0.5

    def decide(self, state: ClusterState) -> List[Action]:
        soa = state.soa
        if soa.count(STATE_RUNNING) == 0:
            return []
        want = np.where(state.site_renewable[soa.site], 1.0, self.power_frac)
        mask = ((soa.state == STATE_RUNNING)
                & (np.abs(soa.power_frac - want) > 1e-9))
        return [Throttle(int(j), float(w))
                for j, w in zip(soa.jids[mask], want[mask])]

    def decide_scalar(self, state: ClusterState) -> List[Action]:
        """Per-job reference implementation (parity oracle)."""
        out: List[Action] = []
        for job in state.running():
            green = state.site(job.site).renewable_active
            want = 1.0 if green else self.power_frac
            if abs(job.power_frac - want) > 1e-9:
                out.append(Throttle(job.jid, want))
        return out


@register_policy("plan-ahead", aliases=("planahead",), config=PlanAheadConfig)
@dataclass
class PlanAheadPolicy(Policy):
    """Forecast-driven planner: Algorithm 1's filter evaluated against the
    *forecast* fabric, plus multi-step Pause/Resume and Defer plans over
    the window horizon (``state.forecast``).

    Four stages per tick:

    1. **Migrate** — Algorithm 1 (hard feasibility filter + utility
       maximization), with the bandwidth grid hardened against forecast
       link outages: a transfer that would still be in flight when an
       outage begins on its link is planned at the outage's degraded
       capacity, not today's matrix.  Every chosen migration must also
       pass an *arrival* check at the post-admission ``(flows+1)`` rate —
       the transfer must land ``arrival_margin_s`` inside the destination
       window and before any forecast outage on its link, so planned
       moves do not become failed migrations.  Jobs at green sites are
       pre-emptively evacuated only when the forecast says their uplink
       browns out before the window ends and their checkpoint could no
       longer drain afterwards.
    2. **Pause** — running jobs burning grid power at dark sites are
       parked when the forecast promises a window within
       ``pause_horizon_s`` (the Pause-for-window sequence).
    3. **Resume** — paused jobs restart when their site turns green, or
       when the window they were waiting for evaporates from the
       forecast (no stranding).
    4. **Defer** — queued jobs at dark sites are held until the forecast
       window start (bounded by ``max_wait_s``), one Defer per
       (job, window) via ``JobView.defer_until_s``.

    Degrades gracefully to reactive feasibility-aware + defer behaviour
    when ``state.forecast`` is None.
    """

    alpha: float = fz.ALPHA
    gamma: float = 1.0
    beta: float = 1.0
    queue_penalty_s: float = 7200.0
    min_benefit_s: float = 1500.0
    max_wait_s: float = 4 * 3600.0
    pause_horizon_s: float = 4 * 3600.0
    min_pause_compute_s: float = 1800.0
    arrival_margin_s: float = 1800.0
    fault_aware: bool = True
    device: DeviceLike = None  # where K4 runs; None is the card

    scores_on_device = True

    def __post_init__(self):
        self.device = resolve(self.device)

    def _params(self) -> pk.ScoreParams:
        return pk.ScoreParams(
            alpha=self.alpha, gamma=self.gamma, beta=self.beta,
            queue_penalty_s=self.queue_penalty_s,
            min_benefit_s=self.min_benefit_s)

    # ---- stage 1 (vectorized): migration -----------------------------------
    def _mig_prep(self, state: ClusterState) -> Optional[tuple]:
        """Candidate selection, evacuation pre-skip and outage hardening
        for one cell: ``(cand, s_i, bw_grid)``, or ``None`` when
        the tick is trivially migration-free."""
        t = state.t
        fc = state.forecast
        soa = state.soa
        W = state.site_window_s
        # a migration must pass the energy gate T_BE < window (T_BE >= 0),
        # so no positive window anywhere means no feasible destination
        if not W.max() > 0.0 or soa.count(STATE_RUNNING) == 0:
            return None
        cand = ((soa.state == STATE_RUNNING) & soa.eligible).nonzero()[0]
        if not len(cand):
            return None
        # pre-skip (pre-emptive-evacuation scan, vectorized): green
        # candidates stay put unless the forecast says their uplink browns
        # out before the current window ends; the grids below only score
        # the survivors
        s_i = soa.site[cand]
        green = state.site_renewable[s_i]
        if fc is None:
            keep = ~green
        else:
            uplink = fc.next_uplink_outage_grid(t)
            keep = ~(green & ((soa.remaining_s[cand] <= W[s_i])
                              | (uplink[s_i] > t + W[s_i])))
        if not keep.all():
            cand = cand[keep]
            if not len(cand):
                return None
            s_i = s_i[keep]
        sizes = soa.ckpt_bytes[cand][:, None]
        bw_grid = state.bandwidth_bps[s_i, :]  # fancy indexing: a copy
        # forecast hardening: plan any transfer that would cross the first
        # forecast outage on its link at the outage's degraded capacity
        if fc is not None:
            o_start, _, o_cap = fc.next_outage_grid(t)
            os_rows = o_start[s_i, :]
            with np.errstate(divide="ignore"):
                tt0 = 8.0 * sizes / bw_grid
            cross = (os_rows < t + tt0) & (bw_grid > 0.0)
            bw_grid = np.where(cross, np.minimum(bw_grid, o_cap[s_i, :]),
                               bw_grid)
        # fault masking: links the fault views mark dead (hard failure or
        # a blacked-out endpoint) carry zero plan rate — the destination
        # becomes infeasible exactly like a zero-capacity brownout
        if self.fault_aware:
            lu = state.__dict__.get("link_up")
            if lu is not None:
                bw_grid = np.where(lu[s_i, :], bw_grid, 0.0)
        return cand, s_i, bw_grid

    def _migrations(self, state: ClusterState, planned: set) -> List[Action]:
        """Whole-grid stage 1: outage hardening, feasibility, evacuation
        scan and destination scoring as single grid passes over the SoA
        (the K4 decide kernel on ``self.device``); only committed
        migrations (rare) run scalar follow-up work (post-admission
        arrival check, reservation-aware re-scoring)."""
        prep = self._mig_prep(state)
        if prep is None:
            return []
        cand, s_i, bw_grid = prep
        dest0 = pk.score_rows([pk.rows_from_state(state, cand, bw_grid)],
                              self._params(), self.device)[0]
        return self._mig_commit(state, planned, cand, s_i, bw_grid,
                                dest0, None, None)

    def _mig_commit(self, state: ClusterState, planned: set,
                    cand: np.ndarray, s_i: np.ndarray, bw_grid: np.ndarray,
                    dest0: np.ndarray, ok: Optional[np.ndarray],
                    tt: Optional[np.ndarray]) -> List[Action]:
        """Argbest destinations -> Actions: post-admission arrival checks
        plus same-tick slot reservations (first commit switches remaining
        rows to the reservation-aware scalar stage 2; the kernel path
        hands in ``ok=tt=None`` and the numpy grids — against the SAME
        outage-hardened ``bw_grid`` — are recomputed lazily then).

        Until the first commit every row is judged against the tick's
        *initial* ``flows``, so the arrival checks are independent and
        run as one vector pass over the ``dest0 >= 0`` rows (the slow
        part of fleet-scale decide used to be this loop walking every
        candidate in Python just to skip the ``dest0 < 0`` majority);
        the per-row gates are op-for-op the scalar oracle's, so the
        first passing row — and hence the whole Action list — is
        unchanged."""
        if not (dest0 >= 0).any():  # the common tick: nothing moves
            return []
        t = state.t
        fc = state.forecast
        soa = state.soa
        W = state.site_window_s
        start_after = (fc.next_outage_start_after_grid(t)
                       if fc is not None else None)
        # fold forecast fault starts into the arrival gate: a transfer
        # must land before the first thing — brownout OR blackout/link
        # failure — that would kill its plan rate
        if start_after is not None and self.fault_aware:
            fg = fc.next_fault_start_grid(t)
            if fg is not None:
                start_after = np.minimum(start_after, fg)

        out: List[Action] = []
        flows = list(state.transfers)

        # ---- vectorized pre-commit pass over the argbest rows
        sel = np.nonzero(dest0 >= 0)[0]
        d_sel = dest0[sel].astype(np.int64)
        s_sel = s_i[sel].astype(np.int64)
        rates = np.array([
            state.post_admission_bps(int(s), int(d), flows)
            for s, d in zip(s_sel, d_sel)])
        pos = rates > 0.0
        t_arr = t + 8.0 * soa.ckpt_bytes[cand[sel]] / np.where(pos, rates,
                                                               1.0)
        good = pos & ~(t_arr + self.arrival_margin_s > t + W[d_sel])
        if start_after is not None:
            good &= ~(start_after[s_sel, d_sel] < t_arr)
        if not good.any():  # every argbest row failed its arrival check
            return []
        first_q = int(np.nonzero(good)[0][0])
        k0 = int(sel[first_q])  # cand-index of the first commit
        i0 = int(cand[k0])
        dest_sid = int(d_sel[first_q])
        src = int(s_sel[first_q])
        jid = int(soa.jids[i0])
        out.append(Migrate(jid, dest_sid))
        flows.append((src, dest_sid))
        reserved: Dict[int, int] = {s.sid: 0 for s in state.sites}
        reserved[dest_sid] += 1
        planned.add(jid)

        # ---- reservation-aware scalar stage 2 for the remaining rows
        # (the commit above invalidated the vector pass's flow snapshot)
        for k in range(k0 + 1, len(cand)):
            i = cand[k]
            if ok is None:
                ok, tt = feasibility_grid_arrays(
                    soa.ckpt_bytes[cand][:, None],
                    soa.t_load_s[cand][:, None], bw_grid, W[None, :],
                    alpha=self.alpha)
            dest_sid = best_destination(
                state, _row_view(soa, i), ok[k], tt[k], reserved,
                gamma=self.gamma, beta=self.beta,
                queue_penalty_s=self.queue_penalty_s,
                min_benefit_s=self.min_benefit_s)
            if dest_sid is None:
                continue
            src = int(s_i[k])
            # arrival check at the post-admission rate — counting both the
            # in-flight transfers and the migrations committed earlier this
            # tick (see the scalar oracle for the full rationale)
            rate = state.post_admission_bps(src, dest_sid, flows)
            if rate <= 0.0:
                continue
            t_arrive = t + 8.0 * float(soa.ckpt_bytes[i]) / rate
            if t_arrive + self.arrival_margin_s > t + W[dest_sid]:
                continue
            if fc is not None and start_after[src, dest_sid] < t_arrive:
                continue
            jid = int(soa.jids[i])
            out.append(Migrate(jid, dest_sid))
            flows.append((src, dest_sid))
            reserved[dest_sid] += 1
            planned.add(jid)
        return out

    # ---- stage 1 (scalar oracle) -------------------------------------------
    def _migrations_scalar(self, state: ClusterState, planned: set) -> List[Action]:
        t = state.t
        fc = state.forecast
        candidates = state.migratable()
        if not candidates:
            return []
        n_sites = state.n_sites
        cand_sites = np.array([j.site for j in candidates], dtype=np.int64)
        bw_grid = np.array(np.asarray(state.bandwidth_bps)[cand_sites, :],
                           copy=True)
        # forecast hardening: plan any transfer that would cross the first
        # forecast outage on its link at the outage's degraded capacity
        outage_at = {}
        if fc is not None:
            for s in set(int(x) for x in cand_sites):
                for d in range(n_sites):
                    if d != s:
                        outage_at[(s, d)] = fc.next_outage(s, d, t)
            for i, job in enumerate(candidates):
                for d in range(n_sites):
                    o = outage_at.get((job.site, d))
                    bw = bw_grid[i, d]
                    if o is None or bw <= 0.0:
                        continue
                    t_transfer = 8.0 * job.ckpt_bytes / bw
                    if o.start_s < t + t_transfer:  # would cross the outage
                        bw_grid[i, d] = min(bw, o.capacity_bps)
        # fault masking (scalar twin of _mig_prep's): dead links score 0
        if self.fault_aware:
            lu = state.__dict__.get("link_up")
            if lu is not None:
                bw_grid = np.where(lu[cand_sites, :], bw_grid, 0.0)
        ok_grid, t_transfer_grid = algorithm1_grid(
            state, candidates, alpha=self.alpha, bw_grid=bw_grid)

        out: List[Action] = []
        flows = list(state.transfers)
        reserved: Dict[int, int] = {s.sid: 0 for s in state.sites}
        for i, job in enumerate(candidates):
            cur = state.site(job.site)
            if cur.renewable_active:
                if job.remaining_compute_s <= cur.window_remaining_s:
                    continue  # finishes green where it is
                # pre-emptive evacuation: only when the uplink is forecast
                # to brown out before this window ends — afterwards the
                # checkpoint could no longer drain at plan rate
                if fc is None:
                    continue
                uplink_out = fc.next_uplink_outage_start_s(job.site, t)
                if uplink_out > t + cur.window_remaining_s:
                    continue  # fabric stays clean: migrate reactively later
            dest_sid = best_destination(
                state, job, ok_grid[i], t_transfer_grid[i], reserved,
                gamma=self.gamma, beta=self.beta,
                queue_penalty_s=self.queue_penalty_s,
                min_benefit_s=self.min_benefit_s)
            if dest_sid is None:
                continue
            # arrival check at the post-admission rate — counting both the
            # in-flight transfers and the migrations committed earlier this
            # tick: the transfer must land inside the destination window
            # with margin, and before any forecast outage on its link
            # (otherwise the rate estimate is fiction and the move becomes
            # a failed migration)
            rate = state.post_admission_bps(job.site, dest_sid, flows)
            if rate <= 0.0:
                continue
            t_transfer = 8.0 * job.ckpt_bytes / rate
            t_arrive = t + t_transfer
            dest_window_end = t + state.site(dest_sid).window_remaining_s
            if t_arrive + self.arrival_margin_s > dest_window_end:
                continue
            if fc is not None:
                # only a FUTURE outage start the transfer would cross
                # invalidates the rate estimate — an outage already in
                # progress is baked into the (degraded) capacities behind
                # `rate`, but it must not mask a back-to-back successor
                nxt = fc.next_outage_start_after(job.site, dest_sid, t)
                if self.fault_aware:
                    nxt = min(nxt, fc.next_fault_start_after(
                        job.site, dest_sid, t))
                if nxt < t_arrive:
                    continue
            out.append(Migrate(job.jid, dest_sid))
            flows.append((job.site, dest_sid))
            reserved[dest_sid] += 1
            planned.add(job.jid)
        return out

    def decide(self, state: ClusterState) -> List[Action]:
        """Vectorized four-stage plan (emits exactly the Action list of
        :meth:`decide_scalar`): stage 1 via :meth:`_migrations`, stages
        2–4 as SoA masks against per-site forecast grids instead of
        per-job scalar horizon queries."""
        planned: set = set()
        out: List[Action] = list(self._migrations(state, planned))
        return self._stages234(state, planned, out)

    def decide_batch(self, states: Sequence[ClusterState]) -> List[List[Action]]:
        """Stage 1 of every cell scored in ONE fused kernel pass; the
        (cheap, already-vectorized) stages 2–4 run per cell."""
        preps = [self._mig_prep(s) for s in states]
        live = [i for i, p in enumerate(preps) if p is not None]
        dests = iter(pk.score_states(
            [states[i] for i in live], [preps[i][0] for i in live],
            self._params(), bw_grids=[preps[i][2] for i in live],
            device=self.device))
        out: List[List[Action]] = []
        for s, p in zip(states, preps):
            planned: set = set()
            migs: List[Action] = []
            if p is not None:
                cand, s_i, bw_grid = p
                d0 = next(dests)
                if d0 is not None:
                    migs = self._mig_commit(s, planned, cand, s_i,
                                            bw_grid, d0, None, None)
            out.append(self._stages234(s, planned, migs))
        return out

    def _stages234(self, state: ClusterState, planned: set,
                   out: List[Action]) -> List[Action]:
        t = state.t
        fc = state.forecast
        soa = state.soa

        st = soa.state
        n_running = soa.count(STATE_RUNNING)
        n_queued = soa.count(STATE_QUEUED)
        green_j = (state.site_renewable[soa.site]
                   if n_running or n_queued else None)
        nws = (fc.next_window_start_grid(t)
               if fc is not None and (n_running or n_queued) else None)

        # ---- stage 2: Pause-for-window (running jobs on grid power)
        if fc is not None and n_running:
            start_j = nws[soa.site]
            pause = ((st == STATE_RUNNING) & ~green_j
                     & (soa.remaining_s >= self.min_pause_compute_s)
                     & (start_j > t) & (start_j <= t + self.pause_horizon_s))
            for k in pause.nonzero()[0]:
                jid = int(soa.jids[k])
                if jid not in planned:
                    out.append(Pause(jid))

        # ---- stage 3: Resume at the (forecast) window start
        if soa.count(STATE_PAUSED):
            paused = (st == STATE_PAUSED).nonzero()[0]
            if fc is None:
                resume = np.ones(len(paused), dtype=bool)
            else:
                # resume when the site turned green, or the window we
                # parked for moved out of reach (no stranding)
                cn = fc.window_open_or_next_start_grid(t)
                resume = (state.site_renewable[soa.site[paused]]
                          | (cn[soa.site[paused]] > t + self.pause_horizon_s))
            for k in paused[resume]:
                out.append(Resume(int(soa.jids[k])))

        # ---- stage 4: Defer queued jobs across the dark span
        if n_queued:
            start_s = nws if fc is not None else state.site_next_window_s
            start_j = start_s[soa.site]
            defer = ((st == STATE_QUEUED) & ~(soa.defer_until_s > t)
                     & ~green_j & (start_j > t)
                     & (start_j <= t + self.max_wait_s))
            for k in defer.nonzero()[0]:
                out.append(Defer(int(soa.jids[k]), float(start_j[k])))
        return out

    def decide_scalar(self, state: ClusterState) -> List[Action]:
        """The per-job reference implementation (parity oracle for
        :meth:`decide`)."""
        t = state.t
        fc = state.forecast
        planned: set = set()
        out: List[Action] = list(self._migrations_scalar(state, planned))

        # ---- stage 2: Pause-for-window (running jobs on grid power)
        if fc is not None:
            for job in state.running():
                if job.jid in planned:
                    continue
                site = state.site(job.site)
                if site.renewable_active:
                    continue
                if job.remaining_compute_s < self.min_pause_compute_s:
                    continue
                start = fc.next_window_start_s(job.site, t)
                if t < start <= t + self.pause_horizon_s:
                    out.append(Pause(job.jid))

        # ---- stage 3: Resume at the (forecast) window start
        for job in state.paused():
            site = state.site(job.site)
            if site.renewable_active:
                out.append(Resume(job.jid))
                continue
            if fc is None:
                out.append(Resume(job.jid))
                continue
            w = fc.next_window(job.site, t)
            if w is None or w.start_s > t + self.pause_horizon_s:
                # the window we parked for moved out of reach — stop waiting
                out.append(Resume(job.jid))

        # ---- stage 4: Defer queued jobs across the dark span
        for job in state.queued():
            if job.held(t):
                continue  # one Defer per (job, window)
            site = state.site(job.site)
            if site.renewable_active:
                continue
            start = (fc.next_window_start_s(job.site, t) if fc is not None
                     else site.next_window_start_s)
            if t < start <= t + self.max_wait_s:
                out.append(Defer(job.jid, start))
        return out


@register_policy("receding-horizon", aliases=("receding", "rh"),
                 config=RecedingHorizonConfig)
@dataclass
class RecedingHorizonPolicy(Policy):
    """Signal-aware receding-horizon planner: every tick, a small
    enumerated *multi-window plan search* per job, scored in forecast
    gCO2 (``state.forecast`` signal stacks) instead of grid-seconds —
    the replacement for plan-ahead's greedy per-tick choice the ROADMAP
    called for.

    For each grid-powered running job the planner enumerates branches:

      * **stay** — run to completion in place; cost = forecast gCO2 of
        the grid portion of ``[t, t + rem]``;
      * **park(k)** — Pause now, resume at the k-th forecast window
        (k < ``plan_windows``, start within ``max_park_s``); cost = gCO2
        of running from the window start plus ``delay_cost_g_per_s`` per
        second of completion delay;
      * **migrate(d)** — Algorithm-1-feasible destinations only, with
        plan-ahead's post-admission arrival check; cost = transfer-leg
        carbon at the source plus the run cost at ``d`` from arrival
        plus the delay penalty.

    The cheapest branch wins (ties keep the earlier-enumerated branch:
    stay, then parks by window order, then destinations by sid) and only
    a ``min_benefit_g`` improvement over *stay* triggers an action —
    re-planned from scratch every tick against the sliding forecast
    (receding horizon), so a plan that stops paying is abandoned, not
    followed.  Paused jobs re-run the same search (Resume when *stay*
    wins or the site turned green — no stranding); queued jobs at dark
    sites Defer to the cheapest of the next ``plan_windows`` windows
    (which may skip a short dirty-tail window for a cleaner later one).
    Finally, running jobs on grid power are Throttled to
    ``dr_power_frac`` while the local carbon signal tops
    ``peak_threshold_g`` — or to the requested cap during an active
    demand-response curtail request — and restored to full power
    otherwise: power and speed scale together, so throttling never
    changes a job's total energy, it *shifts* the draw out of exactly
    the hours the carbon accounting prices highest.

    Degrades gracefully: without signals the cost helpers weight grid
    time at a constant 1 (a grid-seconds minimizer); without a forecast
    it only resumes stranded paused jobs.
    """

    alpha: float = fz.ALPHA
    plan_windows: int = 4
    delay_cost_g_per_s: float = 0.01
    min_benefit_g: float = 60.0
    min_park_compute_s: float = 1800.0
    max_park_s: float = 12 * 3600.0
    max_wait_s: float = 6 * 3600.0
    arrival_margin_s: float = 1800.0
    peak_threshold_g: float = 430.0
    dr_power_frac: float = 0.3
    price_weight_g_per_usd: float = 0.0
    battery_aware: bool = False
    fault_aware: bool = True

    # ---- shared branch-cost helpers (both decide paths call exactly
    # these, so cost floats are identical by construction) -------------------
    def _battery_ctx(self, state: ClusterState):
        """``(per-site SoC kWh, BatteryConfig)`` when battery-aware
        planning is on and the cluster reports storage; ``(None, None)``
        otherwise — the None path threads through every cost helper
        without a single extra float op, so battery-off decisions stay
        bit-identical to the pre-battery planner."""
        if not self.battery_aware or state.battery is None:
            return None, None
        return state.site_battery_soc, state.battery

    def _run_cost_g(self, fc, site: int, t0: float, rem: float,
                    soc=None, batt=None) -> float:
        """gCO2-equivalent of running ``rem`` compute-seconds at ``site``
        from ``t0`` (forecast windows cover their overlap for free;
        with battery context, stored kWh discount the dark portion)."""
        g = fc.grid_carbon_g(site, t0, t0 + rem, fz.P_NODE_KW)
        if self.price_weight_g_per_usd > 0.0:
            g += self.price_weight_g_per_usd * fc.grid_price_usd(
                site, t0, t0 + rem, fz.P_NODE_KW)
        if soc is not None:
            g -= fc.battery_cover_g(site, t0, t0 + rem, fz.P_NODE_KW,
                                    float(soc[site]), batt)
        return g

    def _park_branches(self, fc, site: int, rem: float, t: float,
                       bound_s: float, soc=None, batt=None):
        """``(cost, window_start)`` for waiting at ``site`` for each of
        the next ``plan_windows`` forecast windows starting within
        ``bound_s`` (reveal-gated at the forecast horizon), start-sorted."""
        out = []
        limit = t + min(bound_s, fc.horizon_s)
        for w in fc.site_windows[site]:
            if w.start_s <= t:
                continue
            if w.start_s > limit:
                break
            cost = (self._run_cost_g(fc, site, w.start_s, rem, soc, batt)
                    + self.delay_cost_g_per_s * (w.start_s - t))
            out.append((cost, w.start_s))
            if len(out) >= self.plan_windows:
                break
        return out

    def _should_stay_parked(self, fc, site: int, rem: float,
                            t: float, soc=None, batt=None) -> bool:
        """Re-planned park decision for an already-paused job: keep
        waiting only while some park branch is still *strictly* cheaper
        than resuming now (no margin — the asymmetric hysteresis band
        that stops Pause/Resume flapping)."""
        if rem < self.min_park_compute_s:
            return False
        stay = self._run_cost_g(fc, site, t, rem, soc, batt)
        for cost, _start in self._park_branches(fc, site, rem, t,
                                                self.max_park_s, soc, batt):
            if cost < stay:
                return True
        return False

    def _want_power(self, green: bool, curtail_frac: float,
                    carbon_now: float) -> float:
        """Demand-response power target: full inside windows; the
        operator's cap during an active curtail request; throttled
        through local carbon peaks; full otherwise."""
        if green:
            return 1.0
        if curtail_frac < 1.0:
            return curtail_frac
        if carbon_now >= self.peak_threshold_g:
            return self.dr_power_frac
        return 1.0

    # ---- whole-grid branch-cost tensors (the vectorized plan
    # search).  Each helper mirrors its scalar twin op for op — masked
    # lanes evaluate on dummy arguments and are where-masked to inf, so
    # every live lane's float is bit-identical to the scalar call and
    # the branch argmin reproduces the scalar first-strictly-smaller
    # scan (numpy argmin keeps the first occurrence).  ----------------------
    def _run_cost_g_rows(self, fc, sites: np.ndarray, t0s: np.ndarray,
                         rems: np.ndarray, soc=None, batt=None) -> np.ndarray:
        """Elementwise :meth:`_run_cost_g` over broadcastable arrays."""
        g = fc.grid_carbon_g_rows(sites, t0s, t0s + rems, fz.P_NODE_KW)
        if self.price_weight_g_per_usd > 0.0:
            g = g + self.price_weight_g_per_usd * fc.grid_price_usd_rows(
                sites, t0s, t0s + rems, fz.P_NODE_KW)
        if soc is not None:
            g = g - fc.battery_cover_g_rows(
                sites, t0s, t0s + rems, fz.P_NODE_KW, soc[sites], batt)
        return g

    def _park_cost_rows(self, fc, sites: np.ndarray, rems: np.ndarray,
                        t: float, bound_s: float, soc=None, batt=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """All rows' :meth:`_park_branches` as ``(m, Kw)`` cost / start
        tensors (inf on lanes the scalar would not enumerate: windows
        already open, past the bound, or beyond ``plan_windows``)."""
        starts, _ = fc._window_mats
        ws = starts[sites]  # (m, Kw), +inf padded, start-sorted
        limit = t + min(bound_s, fc.horizon_s)
        elig = (ws > t) & (ws <= limit)
        take = elig & (np.cumsum(elig, axis=1) <= self.plan_windows)
        st = np.where(take, ws, t)
        cost = (self._run_cost_g_rows(fc, sites[:, None], st, rems[:, None],
                                      soc, batt)
                + self.delay_cost_g_per_s * (st - t))
        return (np.where(take, cost, np.inf),
                np.where(take, ws, np.inf))

    def _plan_grid(self, state: ClusterState, fc, cand: np.ndarray,
                   s_i: np.ndarray, ok: np.ndarray, flows: list,
                   reserved: Dict[int, int], soc=None,
                   batt=None) -> List[Action]:
        """Stage 1 as one ``(jobs × branches)`` cost tensor: columns are
        [parks in window order, migrates by sid] — the scalar
        enumeration order, so first-occurrence argmin ≡ the scalar
        strict-< scan.  The tensor assumes the tick's *initial*
        ``flows``/``reserved``; a committed migration invalidates that
        for later rows, so the remaining rows fall back to the scalar
        :meth:`_plan_one` (Pause commits mutate nothing and keep the
        grid valid)."""
        t = state.t
        soa = state.soa
        m = len(cand)
        n = state.n_sites
        rem = soa.remaining_s[cand]
        ckpt = soa.ckpt_bytes[cand]
        W = state.site_window_s
        free = state.site_free_slots
        t_row = np.full(m, t)
        stay = self._run_cost_g_rows(fc, s_i, t_row, rem, soc, batt)

        pcost, _ = self._park_cost_rows(fc, s_i, rem, t, self.max_park_s,
                                        soc, batt)
        pcost = np.where(rem[:, None] >= self.min_park_compute_s,
                         pcost, np.inf)
        kw = pcost.shape[1]

        # migrate branches: the scalar's sequential gates as one mask
        rate = np.empty((m, n))
        rate_rows: Dict[int, np.ndarray] = {}
        for r in range(m):
            src = int(s_i[r])
            row = rate_rows.get(src)
            if row is None:
                row = rate_rows[src] = np.array([
                    state.post_admission_bps(src, d, flows)
                    for d in range(n)])
            rate[r] = row
        feas = (ok & (np.arange(n)[None, :] != s_i[:, None])
                & (free[None, :] > 0) & (rate > 0.0))
        t_arr = t + 8.0 * ckpt[:, None] / np.where(feas, rate, 1.0)
        feas &= ~(t_arr + self.arrival_margin_s > t + W[None, :])
        nxt = fc.next_outage_start_after_grid(t)[s_i, :]
        if self.fault_aware:
            fg = fc.next_fault_start_grid(t)
            if fg is not None:
                nxt = np.minimum(nxt, fg[s_i, :])
        feas &= ~(nxt < t_arr)
        ta = np.where(feas, t_arr, t)
        s_rep = np.broadcast_to(s_i[:, None], (m, n))
        t_rep = np.broadcast_to(t_row[:, None], (m, n))
        transfer = fz.P_SYS_KW / 3600.0 * fc.carbon_integral_rows(
            s_rep, t_rep, ta)
        if self.price_weight_g_per_usd > 0.0:
            transfer = transfer + (self.price_weight_g_per_usd
                                   * fz.P_SYS_KW / 3600.0
                                   * fc.price_integral_rows(s_rep, t_rep, ta))
        d_rep = np.broadcast_to(np.arange(n)[None, :], (m, n))
        mcost = ((transfer + self._run_cost_g_rows(fc, d_rep, ta,
                                                   rem[:, None], soc, batt))
                 + self.delay_cost_g_per_s * (ta - t))
        mcost = np.where(feas, mcost, np.inf)

        costs = np.concatenate([pcost, mcost], axis=1)
        k = np.argmin(costs, axis=1)
        bc = costs[np.arange(m), k]
        act = bc < stay - self.min_benefit_g  # inf lanes never pass

        out: List[Action] = []
        fallback = False
        for r, i in enumerate(cand):
            jid = int(soa.jids[i])
            if fallback:
                a = self._plan_one(
                    state, fc, jid, int(s_i[r]), float(ckpt[r]),
                    float(rem[r]), ok[r], W, free, flows, reserved,
                    soc, batt)
                if a is not None:
                    out.append(a)
                continue
            if not act[r]:
                continue
            if k[r] < kw:
                out.append(Pause(jid))
            else:
                d = int(k[r] - kw)
                out.append(Migrate(jid, d))
                flows.append((int(s_i[r]), d))
                reserved[d] += 1
                fallback = True
        return out

    def _plan_one(self, state: ClusterState, fc, jid: int, site: int,
                  ckpt_bytes: float, rem: float, ok_row, window_s,
                  free_slots, flows, reserved, soc=None,
                  batt=None) -> Optional[Action]:
        """The per-candidate plan search (stage 1).  ``ok_row`` is the
        job's Algorithm-1 feasibility row; ``window_s``/``free_slots``
        are per-site arrays.  Returns the winning first action (or None
        for *stay*) and updates ``flows``/``reserved`` on a commit."""
        t = state.t
        stay = self._run_cost_g(fc, site, t, rem, soc, batt)
        best_cost = float("inf")
        best: Optional[Tuple] = None
        if rem >= self.min_park_compute_s:
            for cost, _start in self._park_branches(fc, site, rem, t,
                                                    self.max_park_s,
                                                    soc, batt):
                if cost < best_cost:
                    best_cost, best = cost, ("pause",)
        for d in range(state.n_sites):
            if d == site or not ok_row[d]:
                continue
            if free_slots[d] - reserved[d] <= 0:
                continue
            rate = state.post_admission_bps(site, d, flows)
            if rate <= 0.0:
                continue
            t_arr = t + 8.0 * ckpt_bytes / rate
            # plan-ahead's arrival checks: land inside the destination
            # window with margin, before any forecast outage on the link
            if t_arr + self.arrival_margin_s > t + float(window_s[d]):
                continue
            nxt = fc.next_outage_start_after(site, d, t)
            if self.fault_aware:
                nxt = min(nxt, fc.next_fault_start_after(site, d, t))
            if nxt < t_arr:
                continue
            transfer_g = fz.P_SYS_KW / 3600.0 * fc.carbon_integral(
                site, t, t_arr)
            if self.price_weight_g_per_usd > 0.0:
                # the $ the simulator will bill for the transfer leg — the
                # same weighting _run_cost_g applies to the run legs
                transfer_g += (self.price_weight_g_per_usd
                               * fz.P_SYS_KW / 3600.0
                               * fc.price_integral(site, t, t_arr))
            cost = (transfer_g
                    + self._run_cost_g(fc, d, t_arr, rem, soc, batt)
                    + self.delay_cost_g_per_s * (t_arr - t))
            if cost < best_cost:
                best_cost, best = cost, ("migrate", d)
        if best is None or not best_cost < stay - self.min_benefit_g:
            return None
        if best[0] == "pause":
            return Pause(jid)
        d = best[1]
        flows.append((site, d))
        reserved[d] += 1
        return Migrate(jid, d)

    # ---- vectorized decide -------------------------------------------------
    def decide(self, state: ClusterState) -> List[Action]:
        """SoA fast path (emits exactly :meth:`decide_scalar`'s Action
        list): candidate masks, feasibility and the demand-response
        power targets are whole-grid numpy passes; the K-branch plan
        search runs per surviving candidate through the shared cost
        helpers (few candidates pass the masks on a typical tick)."""
        t = state.t
        fc = state.forecast
        soa = state.soa
        st = soa.state
        out: List[Action] = []
        acted: set = set()
        m = len(soa)
        if m == 0:
            return out
        green_j = state.site_renewable[soa.site]
        soc, batt = self._battery_ctx(state)

        # ---- stage 1: plan search for grid-powered running jobs
        if fc is not None and soa.count(STATE_RUNNING):
            cand = ((st == STATE_RUNNING) & soa.eligible
                    & ~green_j).nonzero()[0]
            if len(cand):
                s_i = soa.site[cand]
                bw = state.bandwidth_bps[s_i, :]
                if self.fault_aware:
                    lu = state.__dict__.get("link_up")
                    if lu is not None:
                        # dead links (hard failure / blacked-out endpoint)
                        # plan at rate 0 — infeasible like a dark brownout
                        bw = np.where(lu[s_i, :], bw, 0.0)
                ok, _tt = feasibility_grid_arrays(
                    soa.ckpt_bytes[cand][:, None],
                    soa.t_load_s[cand][:, None],
                    bw,
                    state.site_window_s[None, :], alpha=self.alpha)
                flows = list(state.transfers)
                reserved = {s: 0 for s in range(state.n_sites)}
                for act in self._plan_grid(state, fc, cand, s_i, ok,
                                           flows, reserved, soc, batt):
                    out.append(act)
                    acted.add(act.jid)

        # ---- stage 2: paused jobs — resume, or keep waiting (re-planned)
        if soa.count(STATE_PAUSED):
            paused = (st == STATE_PAUSED).nonzero()[0]
            if fc is None:
                resume = np.ones(len(paused), dtype=bool)
            else:
                # batched _should_stay_parked: keep waiting only while
                # some park branch is still strictly cheaper than
                # resuming now (same no-margin hysteresis)
                sites_p = soa.site[paused]
                rem_p = soa.remaining_s[paused]
                stay_p = self._run_cost_g_rows(
                    fc, sites_p, np.full(len(paused), t), rem_p, soc, batt)
                pcost, _ = self._park_cost_rows(fc, sites_p, rem_p, t,
                                                self.max_park_s, soc, batt)
                keep = ((rem_p >= self.min_park_compute_s)
                        & (pcost < stay_p[:, None]).any(axis=1))
                resume = green_j[paused] | ~keep
            for i, r in zip(paused, resume):
                if r:
                    out.append(Resume(int(soa.jids[i])))

        # ---- stage 3: queued jobs — Defer to the cheapest nearby window
        if fc is not None and soa.count(STATE_QUEUED):
            queued = ((st == STATE_QUEUED) & ~(soa.defer_until_s > t)
                      & ~green_j).nonzero()[0]
            if len(queued):
                sites_q = soa.site[queued]
                rem_q = soa.remaining_s[queued]
                stay_q = self._run_cost_g_rows(
                    fc, sites_q, np.full(len(queued), t), rem_q, soc, batt)
                pcost, pstart = self._park_cost_rows(fc, sites_q, rem_q, t,
                                                     self.max_wait_s,
                                                     soc, batt)
                kq = np.argmin(pcost, axis=1)
                rr = np.arange(len(queued))
                bc, bs = pcost[rr, kq], pstart[rr, kq]
                go = np.isfinite(bs) & (bc < stay_q - self.min_benefit_g)
                for i, g, s0 in zip(queued, go, bs):
                    if g:
                        out.append(Defer(int(soa.jids[i]), float(s0)))

        # ---- stage 4: demand response — throttle through peaks/DR spans
        if soa.count(STATE_RUNNING):
            if fc is None:
                carb = np.zeros(state.n_sites)
                cfrac = np.ones(state.n_sites)
            else:
                carb = fc.carbon_grid(t)
                cfrac = fc.curtail_frac_grid(t)
            green_s = state.site_renewable
            # one _want_power per site (n_sites is small), not a numpy
            # re-implementation — a single copy of the target logic is
            # what keeps the two decide paths in lockstep by construction
            want_site = np.array([
                self._want_power(bool(green_s[s]), float(cfrac[s]),
                                 float(carb[s]))
                for s in range(state.n_sites)])
            want_j = want_site[soa.site]
            mask = ((st == STATE_RUNNING)
                    & (np.abs(soa.power_frac - want_j) > 1e-9))
            for i in mask.nonzero()[0]:
                jid = int(soa.jids[i])
                if jid not in acted:
                    out.append(Throttle(jid, float(want_j[i])))
        return out

    # ---- scalar oracle -----------------------------------------------------
    def decide_scalar(self, state: ClusterState) -> List[Action]:
        """The per-job reference implementation (parity oracle for
        :meth:`decide`)."""
        t = state.t
        fc = state.forecast
        out: List[Action] = []
        acted: set = set()
        soc, batt = self._battery_ctx(state)

        # ---- stage 1: plan search for grid-powered running jobs
        if fc is not None:
            cands = [j for j in state.migratable()
                     if not state.site(j.site).renewable_active]
            if cands:
                bw = None
                if self.fault_aware:
                    lu = state.__dict__.get("link_up")
                    if lu is not None:
                        s_c = np.array([j.site for j in cands],
                                       dtype=np.int64)
                        bw = np.where(
                            lu[s_c, :],
                            np.asarray(state.bandwidth_bps)[s_c, :], 0.0)
                ok_grid, _tt = algorithm1_grid(state, cands,
                                               alpha=self.alpha, bw_grid=bw)
                window_s = [s.window_remaining_s for s in state.sites]
                free_slots = [s.free_slots for s in state.sites]
                flows = list(state.transfers)
                reserved = {s.sid: 0 for s in state.sites}
                for i, job in enumerate(cands):
                    act = self._plan_one(
                        state, fc, job.jid, job.site, job.ckpt_bytes,
                        job.remaining_compute_s, ok_grid[i], window_s,
                        free_slots, flows, reserved, soc, batt)
                    if act is not None:
                        out.append(act)
                        acted.add(act.jid)

        # ---- stage 2: paused jobs — resume, or keep waiting (re-planned)
        for job in state.paused():
            green = state.site(job.site).renewable_active
            if green or fc is None or not self._should_stay_parked(
                    fc, job.site, job.remaining_compute_s, t, soc, batt):
                out.append(Resume(job.jid))

        # ---- stage 3: queued jobs — Defer to the cheapest nearby window
        if fc is not None:
            for job in state.queued():
                if job.held(t):
                    continue
                if state.site(job.site).renewable_active:
                    continue
                rem = job.remaining_compute_s
                stay = self._run_cost_g(fc, job.site, t, rem, soc, batt)
                best_cost, best_start = float("inf"), None
                for cost, start in self._park_branches(fc, job.site, rem, t,
                                                       self.max_wait_s,
                                                       soc, batt):
                    if cost < best_cost:
                        best_cost, best_start = cost, start
                if best_start is not None and \
                        best_cost < stay - self.min_benefit_g:
                    out.append(Defer(job.jid, best_start))

        # ---- stage 4: demand response — throttle through peaks/DR spans
        for job in state.running():
            if job.jid in acted:
                continue
            green = state.site(job.site).renewable_active
            if fc is None:
                cfrac, carbon = 1.0, 0.0
            else:
                c = fc.active_curtail(job.site, t)
                cfrac = c.power_frac if c is not None else 1.0
                carbon = fc.carbon_value(job.site, t)
            want = self._want_power(green, cfrac, carbon)
            if abs(job.power_frac - want) > 1e-9:
                out.append(Throttle(job.jid, want))
        return out


@register_policy("defer-to-window", config=DeferConfig)
@dataclass
class DeferToWindowPolicy(Policy):
    """Beyond-paper: hold queued jobs at dark sites until the site's next
    forecast window start (bounded by ``max_wait_s``), so they begin on
    renewable power.  Exercises the ``Defer`` action."""

    max_wait_s: float = 4 * 3600.0

    def decide(self, state: ClusterState) -> List[Action]:
        t = state.t
        soa = state.soa
        if soa.count(STATE_QUEUED) == 0:
            return []
        start = state.site_next_window_s[soa.site]
        # held jobs (defer_until_s still in the future) are skipped —
        # re-issuing Defer every tick is pure action noise (one Defer per
        # (job, window); a job resurfaces here when the hold expires)
        mask = ((soa.state == STATE_QUEUED) & ~(soa.defer_until_s > t)
                & ~state.site_renewable[soa.site]
                & (start > t) & (start <= t + self.max_wait_s))
        return [Defer(int(j), float(s))
                for j, s in zip(soa.jids[mask], start[mask])]

    def decide_scalar(self, state: ClusterState) -> List[Action]:
        """Per-job reference implementation (parity oracle)."""
        out: List[Action] = []
        for job in state.queued():
            if job.held(state.t):
                continue
            site = state.site(job.site)
            if site.renewable_active:
                continue
            start = site.next_window_start_s
            if state.t < start <= state.t + self.max_wait_s:
                out.append(Defer(job.jid, start))
        return out


__all__ = [
    "Action", "ClusterState", "DeferConfig", "DeferToWindowPolicy",
    "EnergyOnlyPolicy", "FeasibilityAwarePolicy", "FeasibilityConfig",
    "GridThrottlePolicy", "JobView", "OraclePolicy", "OrchestratorContext",
    "PlanAheadConfig", "PlanAheadPolicy", "Policy", "PolicyConfig",
    "RecedingHorizonConfig", "RecedingHorizonPolicy", "SiteView",
    "StaticPolicy", "ThrottleConfig", "available_policies",
    "benefit_grid_arrays", "feasibility_grid_arrays", "make_policy",
    "pick_best_grid", "policy_config_cls", "register_policy",
]
