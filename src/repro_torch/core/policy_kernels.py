"""Batched Algorithm-1 decide: padded row batches scored by the K4 kernel.

The per-tick hot loop of every migration policy is the fused
feasibility + benefit + lexicographic-argbest pass of
Algorithm 1 (the JAX package's ``repro.core.orchestrator.score_migrations``)
— a ``(jobs × sites)`` grid evaluated once per simulator tick.  This module
stacks many cells' candidate rows into one padded
``(cells × jobs × sites)`` batch (``build_batch`` / ``batch_from_states``)
and scores it in one call to ``kernels/ops.decide_dest``: the
hand-written CUDA kernel (``csrc/decide.cu``) on the card, its plain
PyTorch version on the CPU, both in float64.

* **batching** — at sweep scale (thousands of Monte-Carlo cells) one
  launch answers every cell of a round;
* **bucketed padding** — job counts are padded to the next power of two
  (min 8) and site counts to a multiple of 8, so job-count drift between
  ticks reuses a handful of shapes (``pad_jobs`` / ``pad_sites``).

``_score_numpy`` is the float64 numpy pass the kernel reproduces
bit for bit; it is the parity oracle of the tests and of
``chip_smoke.py`` and never runs on the decide path.  The kernel returns
only the argbest destination per row; the rare reservation-aware commit
path recomputes the numpy feasibility grids lazily (see
``FeasibilityAwarePolicy._commit``).

Padding-lane invariants (why masked lanes can never win):  padded site
columns carry ``bw == 0`` and ``window == 0`` so ``t_transfer = inf``
fails every feasibility gate; padded job rows carry ``bw == 0`` across
all sites (and ``ckpt == 1.0``, never 0, so no ``0/0`` NaN) and resolve
to destination ``-1``.  All reductions use exact neutral elements
(``-inf`` for max, ``+inf`` for min), and ``argmax`` keeps numpy's
first-occurrence rule, preserving the scalar tie-break key
``(-benefit, t_transfer, sid)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import feasibility as fz
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Shared scalar helpers
# ---------------------------------------------------------------------------

_PPF_CACHE: Dict[float, float] = {}


def _norm_ppf_cached(eps: float) -> float:
    """Standard-normal inverse CDF, memoized (the stochastic gate's
    eps-quantile; kept here so kernels never import the policy module)."""
    got = _PPF_CACHE.get(eps)
    if got is None:
        import statistics

        got = _PPF_CACHE[eps] = statistics.NormalDist().inv_cdf(eps)
    return got


# ---------------------------------------------------------------------------
# Row extraction + padded batching
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScoreParams:
    """The scalar knobs of the fused kernel (one immutable bundle so a
    batch group can assert every cell shares them)."""

    alpha: float
    gamma: float
    beta: float
    queue_penalty_s: float
    min_benefit_s: float
    eps: float = 0.0
    forecast_sigma_s: float = 0.0

    @property
    def use_stoch(self) -> bool:
        return self.eps > 0.0 and self.forecast_sigma_s > 0.0

    @property
    def ppf_sigma(self) -> float:
        return (_norm_ppf_cached(self.eps) * self.forecast_sigma_s
                if self.use_stoch else 0.0)


@dataclass
class StateRows:
    """One cell's candidate rows, gathered from the SoA columns — the
    exact inputs the decide reads, params-free so one
    extraction serves every device.  ``k`` jobs × ``n`` sites."""

    sizes: np.ndarray      # (k,)  ckpt_bytes
    t_loads: np.ndarray    # (k,)
    rem: np.ndarray        # (k,)  remaining_s
    cur_green: np.ndarray  # (k,)  renewable window at the source, else 0
    load_src: np.ndarray   # (k,)  site_load at the source
    s_i: np.ndarray        # (k,)  source sid
    bw: np.ndarray         # (k, n) bandwidth_bps rows
    W: np.ndarray          # (n,)  site_window_s
    bq_load: np.ndarray    # (n,)
    free_slots: np.ndarray  # (n,)
    # (n,) battery state-of-charge kWh when the cell reports storage,
    # else None.  Carried for battery-aware compiled scoring; the
    # numpy scorer ignores it, so scores stay bit-identical either way.
    soc: Optional[np.ndarray] = None

    @property
    def k(self) -> int:
        return len(self.sizes)

    @property
    def n(self) -> int:
        return len(self.W)


def rows_from_state(state, cand: np.ndarray,
                    bw_grid: Optional[np.ndarray] = None) -> StateRows:
    """Gather one cell's :class:`StateRows` from a ``ClusterState`` and
    its candidate index array."""
    soa = state.soa
    W = state.site_window_s
    s_i = soa.site[cand]
    if bw_grid is None:
        bw_grid = state.bandwidth_bps[s_i, :]
    return StateRows(
        sizes=soa.ckpt_bytes[cand], t_loads=soa.t_load_s[cand],
        rem=soa.remaining_s[cand],
        cur_green=np.where(state.site_renewable[s_i], W[s_i], 0.0),
        load_src=state.site_load[s_i], s_i=s_i, bw=bw_grid, W=W,
        bq_load=state.site_bq_load, free_slots=state.site_free_slots,
        soc=(state.site_battery_soc if state.battery is not None else None))


def pad_jobs(k: int) -> int:
    """Job-axis padding bucket: next power of two, floor 8."""
    p = 8
    while p < k:
        p <<= 1
    return p


def pad_sites(n: int) -> int:
    """Site-axis padding bucket: next multiple of 8."""
    return ((n + 7) // 8) * 8


@dataclass
class ScoreBatch:
    """Padded, stacked rows for ``B`` cells: ``(B, K)`` job columns,
    ``(B, S)`` site columns, ``(B, K, S)`` bandwidth.  Padding values are
    chosen so masked lanes are infeasible (see module docstring)."""

    sizes: np.ndarray      # (B, K) pad 1.0
    t_loads: np.ndarray    # (B, K) pad 0.0
    rem: np.ndarray        # (B, K) pad 0.0
    cur_green: np.ndarray  # (B, K) pad 0.0
    load_src: np.ndarray   # (B, K) pad 0.0
    s_i: np.ndarray        # (B, K) int32, pad 0
    bw: np.ndarray         # (B, K, S) pad 0.0
    W: np.ndarray          # (B, S) pad 0.0
    bq_load: np.ndarray    # (B, S) pad 0.0
    free_slots: np.ndarray  # (B, S) pad 1
    n_jobs: Tuple[int, ...]
    n_sites: Tuple[int, ...]
    # (B, S) battery SoC kWh, pad 0.0 — None unless some cell reports
    # storage (reserved for battery-aware compiled scoring; unused by
    # the numpy scorer so batch scores never depend on it)
    soc: Optional[np.ndarray] = None


def _ragged_idx(lens: np.ndarray, stride: int) -> np.ndarray:
    """Flat scatter positions for ragged rows: row ``b``'s ``lens[b]``
    elements land at ``b*stride + [0..lens[b])``."""
    total = int(lens.sum())
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return np.repeat(np.arange(len(lens)) * stride, lens) + within


def build_batch(rows: Sequence[StateRows]) -> ScoreBatch:
    """Stack cells into one bucket-padded :class:`ScoreBatch`.

    Ragged rows are placed with one concatenate + one flat scatter per
    column (constant dispatch count per batch) rather than B slice
    assignments per column — at sweep scale (B ~ 1000 tiny cells) the
    python stacking loop would otherwise dominate the fused kernel.
    """
    B = len(rows)
    ks = np.fromiter((r.k for r in rows), np.int64, B)
    ns = np.fromiter((r.n for r in rows), np.int64, B)
    K = pad_jobs(int(ks.max()))
    S = pad_sites(int(ns.max()))
    jidx = _ragged_idx(ks, K)
    sidx = _ragged_idx(ns, S)

    def jcol(vals, fill, dtype=np.float64):
        out = np.full(B * K, fill, dtype=dtype)
        out[jidx] = np.concatenate(vals)
        return out.reshape(B, K)

    def scol(vals, fill, dtype=np.float64):
        out = np.full(B * S, fill, dtype=dtype)
        out[sidx] = np.concatenate(vals)
        return out.reshape(B, S)

    # bw is ragged in both axes: element (b, j, s) lives at flat
    # (b*K + j)*S + s — jidx already enumerates (b*K + j) per real job
    widths = np.repeat(ns, ks)  # sites per (cell, job) row
    bw = np.zeros(B * K * S)
    bw[np.repeat(jidx * S, widths)
       + _ragged_idx(widths, 0)] = np.concatenate(
           [r.bw.ravel() for r in rows])
    return ScoreBatch(
        sizes=jcol([r.sizes for r in rows], 1.0),
        t_loads=jcol([r.t_loads for r in rows], 0.0),
        rem=jcol([r.rem for r in rows], 0.0),
        cur_green=jcol([r.cur_green for r in rows], 0.0),
        load_src=jcol([r.load_src for r in rows], 0.0),
        s_i=jcol([r.s_i for r in rows], 0, np.int32),
        bw=bw.reshape(B, K, S),
        W=scol([r.W for r in rows], 0.0),
        bq_load=scol([r.bq_load for r in rows], 0.0),
        free_slots=scol([r.free_slots for r in rows], 1, np.int64),
        n_jobs=tuple(int(k) for k in ks),
        n_sites=tuple(int(n) for n in ns),
        soc=(scol([(r.soc if r.soc is not None else np.zeros(r.n))
                   for r in rows], 0.0)
             if any(r.soc is not None for r in rows) else None))


def batch_from_states(states: Sequence, cands: Sequence[np.ndarray],
                      bw_grids: Optional[Sequence[np.ndarray]] = None,
                      ) -> ScoreBatch:
    """Build a :class:`ScoreBatch` straight from many ``ClusterState``
    snapshots with CROSS-CELL vectorized gathers: one concatenate + one
    fancy-index per column over all cells at once, instead of ~9 tiny
    numpy dispatches per cell (:func:`rows_from_state`) — at sweep scale
    the per-cell dispatch cost would dominate the fused kernel itself.
    Values are gathered with the exact same index arithmetic, so the
    resulting batch is element-identical to the per-cell path.

    ``bw_grids`` optionally carries per-cell pre-hardened bandwidth rows
    (plan-ahead's forecast-outage hardening); otherwise rows are gathered
    from each state's advertised ``bandwidth_bps`` matrix.
    """
    B = len(states)
    ks = np.fromiter((len(c) for c in cands), np.int64, B)
    ns = np.fromiter((s.n_sites for s in states), np.int64, B)
    K = pad_jobs(int(ks.max()))
    S = pad_sites(int(ns.max()))
    job_lens = np.fromiter((len(s.soa.jids) for s in states), np.int64, B)
    job_offs = np.cumsum(job_lens) - job_lens
    site_offs = np.cumsum(ns) - ns
    cand_g = np.concatenate(cands) + np.repeat(job_offs, ks)
    sizes = np.concatenate([s.soa.ckpt_bytes for s in states])[cand_g]
    t_loads = np.concatenate([s.soa.t_load_s for s in states])[cand_g]
    rem = np.concatenate([s.soa.remaining_s for s in states])[cand_g]
    s_i = np.concatenate([s.soa.site for s in states])[cand_g]
    W_cat = np.concatenate([s.site_window_s for s in states])
    s_g = s_i + np.repeat(site_offs, ks)
    cur_green = np.where(
        np.concatenate([s.site_renewable for s in states])[s_g],
        W_cat[s_g], 0.0)
    load_src = np.concatenate([s.site_load for s in states])[s_g]

    widths = np.repeat(ns, ks)  # destination count per (cell, job) row
    if bw_grids is not None:
        bw_vals = np.concatenate([g.ravel() for g in bw_grids])
    else:
        # gather each job's bandwidth row out of the cells' flattened
        # (n, n) matrices: row base = cell offset + s_i * n
        mat_lens = ns * ns
        row_base = (np.repeat(np.cumsum(mat_lens) - mat_lens, ks)
                    + s_i * widths)
        bw_vals = np.concatenate(
            [np.asarray(s.bandwidth_bps).ravel() for s in states])[
                np.repeat(row_base, widths) + _ragged_idx(widths, 0)]

    jidx = _ragged_idx(ks, K)
    sidx = _ragged_idx(ns, S)

    def jcol(vals, fill, dtype=np.float64):
        out = np.full(B * K, fill, dtype=dtype)
        out[jidx] = vals
        return out.reshape(B, K)

    def scol(vals, fill, dtype=np.float64):
        out = np.full(B * S, fill, dtype=dtype)
        out[sidx] = np.concatenate(vals)
        return out.reshape(B, S)

    bw = np.zeros(B * K * S)
    bw[np.repeat(jidx * S, widths) + _ragged_idx(widths, 0)] = bw_vals
    return ScoreBatch(
        sizes=jcol(sizes, 1.0), t_loads=jcol(t_loads, 0.0),
        rem=jcol(rem, 0.0), cur_green=jcol(cur_green, 0.0),
        load_src=jcol(load_src, 0.0), s_i=jcol(s_i, 0, np.int32),
        bw=bw.reshape(B, K, S),
        W=scol([s.site_window_s for s in states], 0.0),
        bq_load=scol([s.site_bq_load for s in states], 0.0),
        free_slots=scol([s.site_free_slots for s in states], 1, np.int64),
        n_jobs=tuple(int(k) for k in ks),
        n_sites=tuple(int(n) for n in ns),
        soc=(scol([s.site_battery_soc for s in states], 0.0)
             if any(s.battery is not None for s in states) else None))


def score_states(states: Sequence, cands: Sequence[np.ndarray],
                 params: ScoreParams,
                 bw_grids: Optional[Sequence[np.ndarray]] = None,
                 device: DeviceLike = None) -> List[np.ndarray]:
    """Batch + score many cells' candidate rows in one fused pass;
    returns one un-padded ``(k_i,)`` destination array per cell — or
    ``None`` for a cell where no row found a destination, so callers
    skip their commit path without even a per-cell ``any()`` (the
    no-migration tick is the overwhelmingly common case at sweep
    scale, and the check is one batched reduction here)."""
    if not states:
        return []
    dest = score_batch(batch_from_states(states, cands, bw_grids),
                       params, device)
    live = (dest >= 0).any(axis=1)
    return [dest[b, :len(c)] if live[b] else None
            for b, c in enumerate(cands)]


# ---------------------------------------------------------------------------
# numpy pass — the parity oracle of the K4 kernel and its plain version
# ---------------------------------------------------------------------------


def _score_numpy(batch: ScoreBatch, params: ScoreParams) -> np.ndarray:
    """The fused kernel with a leading batch axis, op-for-op identical to
    the per-cell numpy pass ``score_migrations`` of the JAX package
    (every operation is elementwise or
    a per-lane reduction with exact neutral elements, so real lanes are
    bit-identical to the unbatched pass).  Returns ``(B, K)`` argbest
    destinations, ``-1`` where no destination is valid."""
    with np.errstate(divide="ignore"):
        tt = 8.0 * batch.sizes[:, :, None] / batch.bw
    W = batch.W[:, None, :]
    t_cost = tt + batch.t_loads[:, :, None] + fz.T_DOWNTIME_S
    energy_ok = (fz.P_SYS_KW / fz.P_NODE_KW) * tt < W
    not_c = tt < fz.CLASS_B_MAX_S
    if params.use_stoch:
        window_lo = W + params.ppf_sigma
        time_ok = t_cost < params.alpha * np.maximum(window_lo, 0.0)
    else:
        time_ok = t_cost < params.alpha * W
    ok = time_ok & energy_ok & not_c
    rem = batch.rem[:, :, None]
    avoided = np.maximum(
        0.0, np.minimum(W, rem) - np.minimum(batch.cur_green[:, :, None], rem))
    benefit = (params.gamma * avoided
               - (params.beta * params.queue_penalty_s)
               * (batch.bq_load[:, None, :] - batch.load_src[:, :, None]))
    benefit = benefit + np.where(batch.free_slots <= 0,
                                 -params.queue_penalty_s, 0.0)[:, None, :]
    sid = np.arange(batch.W.shape[1])
    valid = (ok
             & (sid[None, None, :] != batch.s_i[:, :, None])
             & (benefit > np.maximum(t_cost, params.min_benefit_s)))
    b = np.where(valid, benefit, -np.inf)
    mb = b.max(axis=2)
    tie = valid & (b == mb[..., None])
    ttm = np.where(tie, tt, np.inf)
    tie = tie & (ttm == ttm.min(axis=2)[..., None])
    return np.where(np.isfinite(mb), tie.argmax(axis=2), -1)


# ---------------------------------------------------------------------------
# Public entry points: the K4 kernel on ``device``
# ---------------------------------------------------------------------------


def kernel_scalars(params: ScoreParams) -> Dict[str, float]:
    """The scalar arguments of ``ops.decide_dest``, computed on the host
    in Python float exactly as :func:`_score_numpy` computes them."""
    return dict(
        alpha=float(params.alpha), gamma=float(params.gamma),
        betaqp=float(params.beta * params.queue_penalty_s),
        queue_penalty_s=float(params.queue_penalty_s),
        min_benefit_s=float(params.min_benefit_s),
        ppf_sigma=float(params.ppf_sigma), use_stoch=params.use_stoch,
        energy_ratio=fz.P_SYS_KW / fz.P_NODE_KW,
        t_downtime_s=fz.T_DOWNTIME_S, class_c_s=fz.CLASS_B_MAX_S)


def pack_batch(batch: ScoreBatch) -> Tuple[np.ndarray, np.ndarray]:
    """The batch's job columns as one float64 ``(B, K, 6)`` array
    (sizes, t_loads, rem, cur_green, load_src, s_i) and its site columns
    as one float64 ``(B, S, 3)`` array (W, bq_load, free_slots): with
    ``bw`` that makes three host-to-device copies per decide.  Site ids
    and slot counts are small integers, exact in float64."""
    jobs = np.stack([batch.sizes, batch.t_loads, batch.rem, batch.cur_green,
                     batch.load_src, batch.s_i.astype(np.float64)], axis=-1)
    sites = np.stack([batch.W, batch.bq_load,
                      batch.free_slots.astype(np.float64)], axis=-1)
    return jobs, sites


def score_batch(batch: ScoreBatch, params: ScoreParams,
                device: DeviceLike = None) -> np.ndarray:
    """Score a padded batch with K4 on ``device`` (``None``: the card; the
    CUDA kernel there, its plain version on the CPU); ``(B, K)`` int64
    argbest destinations (``-1`` = stay put), padded job rows included."""
    device = resolve(device)
    jobs, sites = pack_batch(batch)
    dest = ops.decide_dest(
        torch.from_numpy(jobs).to(device), torch.from_numpy(sites).to(device),
        torch.from_numpy(np.ascontiguousarray(batch.bw)).to(device),
        **kernel_scalars(params))
    return dest.cpu().numpy()


def score_rows(rows: Sequence[StateRows], params: ScoreParams,
               device: DeviceLike = None) -> List[np.ndarray]:
    """Batch + score many cells' rows in one K4 call; returns one
    un-padded ``(k_i,)`` destination array per cell."""
    if not rows:
        return []
    dest = score_batch(build_batch(rows), params, device)
    return [dest[b, :r.k] for b, r in enumerate(rows)]


__all__ = [
    "ScoreBatch", "ScoreParams", "StateRows", "batch_from_states",
    "build_batch", "kernel_scalars", "pack_batch", "pad_jobs", "pad_sites",
    "rows_from_state", "score_batch", "score_rows", "score_states",
]
