"""Feasibility-domain model for migratory AI workloads (paper §IV + §VI);
port of ``repro/core/feasibility.py``.

A workload w = (S, τ) migrating from site s to site d over WAN bandwidth
B_{s,d} is governed by:

  time:     T_transfer + T_load + T_downtime < α · T_energy(d)      (eq. 1)
  energy:   T_breakeven = P_sys · T_transfer / P_node < T_energy(d) (§IV.D)

with T_transfer = 8·S / B  (S bytes, B bits/s).  Classification (§VI.D):

  class A:  T_transfer < 60 s      (freely migratable)
  class B:  60 s ≤ T_transfer < 300 s  (conditional: needs α-window check)
  class C:  T_transfer ≥ 300 s     (never migrated)

Inputs are floats or numpy arrays and broadcast.  Zero bandwidth (no link)
yields an infinite transfer time, i.e. infeasible, without warnings.  This
float64 numpy path is what the orchestrator evaluates every tick.

The Fig. 2 phase diagram, the size bands and the §VI.F-G utility model run
in float32 on a ``device`` (``None`` = the card), as the JAX package
computes them in float32 with ``jnp``: ``phase_diagram`` and
``feasible_destinations`` return numpy, ``classify_by_size`` and
``site_utility`` return tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve

ArrayLike = Union[float, np.ndarray]

# --- paper constants (Table V + §IV) ---------------------------------------
ALPHA = 0.1  # acceptable disruption fraction of the renewable window
T_DOWNTIME_S = 0.4  # stop-the-world (PhoenixOS [17])
T_LOAD_S = 10.3  # checkpoint load (ServerlessLLM [19])
P_SYS_KW = 1.8  # combined system power during transfer (§IV.D)
P_NODE_KW = 0.75  # compute-node power (§IV.D)
CLASS_A_MAX_S = 60.0
CLASS_B_MAX_S = 300.0

GB = 1e9


class FeasibilityVerdict(NamedTuple):
    feasible: ArrayLike  # bool: time AND energy constraints hold
    time_ok: ArrayLike
    energy_ok: ArrayLike
    t_transfer_s: ArrayLike
    t_cost_s: ArrayLike  # transfer + load + downtime
    t_breakeven_s: ArrayLike
    workload_class: ArrayLike  # 0=A, 1=B, 2=C


def transfer_time_s(size_bytes: ArrayLike, bandwidth_bps: ArrayLike) -> ArrayLike:
    """T_transfer = 8 S / B  (paper §V).  B = 0 (no link) -> inf."""
    size = np.asarray(size_bytes, dtype=np.float64)
    bw = np.asarray(bandwidth_bps, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return 8.0 * size / bw


def migration_cost_s(
    size_bytes: ArrayLike,
    bandwidth_bps: ArrayLike,
    t_load_s: ArrayLike = T_LOAD_S,
    t_downtime_s: float = T_DOWNTIME_S,
) -> ArrayLike:
    return transfer_time_s(size_bytes, bandwidth_bps) + t_load_s + t_downtime_s


def migration_energy_kwh(
    size_bytes: ArrayLike, bandwidth_bps: ArrayLike, p_sys_kw: float = P_SYS_KW
) -> ArrayLike:
    """E_mig = P_sys · T_transfer  (eq. 2)."""
    return p_sys_kw * transfer_time_s(size_bytes, bandwidth_bps) / 3600.0


def breakeven_time_s(
    size_bytes: ArrayLike,
    bandwidth_bps: ArrayLike,
    p_sys_kw: float = P_SYS_KW,
    p_node_kw: float = P_NODE_KW,
) -> ArrayLike:
    """T_BE = E_mig / P_node — minimum renewable runtime to amortize the
    migration energy (§IV.D / §VI.B)."""
    return (p_sys_kw / p_node_kw) * transfer_time_s(size_bytes, bandwidth_bps)


def _classify_from_time(t_transfer: ArrayLike) -> np.ndarray:
    """§VI.D class from a precomputed T_transfer (0=A, 1=B, 2=C)."""
    return np.where(t_transfer < CLASS_A_MAX_S, 0,
                    np.where(t_transfer < CLASS_B_MAX_S, 1, 2)).astype(np.int32)


def classify(size_bytes: ArrayLike, bandwidth_bps: ArrayLike) -> np.ndarray:
    """0=A, 1=B, 2=C per the §VI.D T_transfer thresholds."""
    return _classify_from_time(np.asarray(transfer_time_s(size_bytes, bandwidth_bps)))


def classify_by_size(size_bytes, *, device: DeviceLike = None) -> torch.Tensor:
    """Table IV size bands (equivalent to the time thresholds at ~1 Gbps):
    A < 10 GB, B 10–100 GB, C > 100 GB.  Sizes and thresholds in float32,
    so a size that rounds to 100 GB there is class B."""
    dev = resolve(device)
    s = torch.as_tensor(size_bytes, dtype=torch.float32, device=dev)
    a_max, b_max = (_f32(10 * GB, dev), _f32(100 * GB, dev))
    return torch.where(s < a_max, 0, torch.where(s <= b_max, 1, 2)).to(torch.int32)


def evaluate(
    size_bytes: ArrayLike,
    bandwidth_bps: ArrayLike,
    window_s: ArrayLike,
    *,
    alpha: float = ALPHA,
    t_load_s: ArrayLike = T_LOAD_S,
    t_downtime_s: float = T_DOWNTIME_S,
    p_sys_kw: float = P_SYS_KW,
    p_node_kw: float = P_NODE_KW,
) -> FeasibilityVerdict:
    """Full feasibility verdict for (w, s→d) triples. Broadcasts."""
    t_transfer = transfer_time_s(size_bytes, bandwidth_bps)
    t_cost = t_transfer + t_load_s + t_downtime_s
    t_be = (p_sys_kw / p_node_kw) * t_transfer  # = breakeven_time_s
    cls = _classify_from_time(t_transfer)
    time_ok = t_cost < alpha * np.asarray(window_s)
    energy_ok = t_be < window_s
    feasible = np.logical_and(np.logical_and(time_ok, energy_ok), cls != 2)
    return FeasibilityVerdict(feasible, time_ok, energy_ok, t_transfer, t_cost, t_be, cls)


def stochastic_feasible(
    size_bytes: ArrayLike,
    bandwidth_bps: ArrayLike,
    window_forecast_s: ArrayLike,
    window_sigma_s: ArrayLike,
    *,
    eps: float = 0.05,
    alpha: float = ALPHA,
    t_load_s: float = T_LOAD_S,
    t_downtime_s: float = T_DOWNTIME_S,
) -> np.ndarray:
    """P[T_mig + T_load + T_dt < α·T̃_d | T̂_d] ≥ 1 − ε with a Gaussian
    forecast-error model T̃ ~ N(T̂, σ²) (§VI.H): equivalent to checking the
    deterministic condition against the lower ε-quantile of the window."""
    import statistics

    t_cost = migration_cost_s(size_bytes, bandwidth_bps, t_load_s, t_downtime_s)
    ppf = statistics.NormalDist().inv_cdf(eps)
    window_lo = (np.asarray(window_forecast_s, dtype=np.float64)
                 + ppf * np.asarray(window_sigma_s, dtype=np.float64))
    return t_cost < alpha * np.maximum(window_lo, 0.0)


# ---------------------------------------------------------------------------
# Phase diagram (Fig. 2) and utility model (§VI.F-G), in float32
# ---------------------------------------------------------------------------


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _evaluate_f32(bits, bw, window, alpha: float = ALPHA) -> FeasibilityVerdict:
    """``evaluate`` on float32 tensors from ``bits`` = 8·S, one rounding
    per operation in the reference's order; every constant rounded to
    float32 first."""
    dev = bits.device
    t_transfer = bits / bw
    t_cost = t_transfer + _f32(T_LOAD_S, dev) + _f32(T_DOWNTIME_S, dev)
    t_be = _f32(P_SYS_KW / P_NODE_KW, dev) * t_transfer
    cls = torch.where(t_transfer < _f32(CLASS_A_MAX_S, dev), 0,
                      torch.where(t_transfer < _f32(CLASS_B_MAX_S, dev), 1, 2)).to(torch.int32)
    time_ok = t_cost < _f32(alpha, dev) * window
    energy_ok = t_be < window
    feasible = time_ok & energy_ok & (cls != 2)
    return FeasibilityVerdict(feasible, time_ok, energy_ok, t_transfer, t_cost, t_be, cls)


def phase_diagram(
    sizes_gb: np.ndarray,
    bandwidths_gbps: np.ndarray,
    window_s: float = 2.5 * 3600,
    alpha: float = ALPHA,
    *,
    device: DeviceLike = None,
):
    """Grid of (class, T_transfer, feasible) over checkpoint-size × WAN-bw —
    the paper's Fig. 2. Returns dict of (len(sizes), len(bws)) arrays."""
    dev = resolve(device)
    S = _f32(np.asarray(sizes_gb), dev)[:, None] * _f32(GB, dev)
    B = _f32(np.asarray(bandwidths_gbps), dev)[None, :] * _f32(1e9, dev)
    v = _evaluate_f32(_f32(8.0, dev) * S, B, _f32(window_s, dev), alpha)
    return {
        "t_transfer_s": v.t_transfer_s.cpu().numpy(),
        "class": v.workload_class.cpu().numpy(),
        "feasible": v.feasible.cpu().numpy(),
        "t_breakeven_s": v.t_breakeven_s.cpu().numpy(),
    }


@dataclass(frozen=True)
class UtilityWeights:
    gamma: float = 1.0  # renewable-availability weight  (§VI.F)
    beta: float = 1.0  # congestion/load weight


def site_utility(renewable, load, w: UtilityWeights = UtilityWeights(), *,
                 device: DeviceLike = None) -> torch.Tensor:
    """U(w, d) = γ·R(d) − β·L(d)."""
    dev = resolve(device)
    return (_f32(w.gamma, dev) * _f32(np.asarray(renewable), dev)
            - _f32(w.beta, dev) * _f32(np.asarray(load), dev))


def feasible_destinations(
    size_bytes: float,
    bandwidths_bps: np.ndarray,  # (n_sites,) from current site
    windows_s: np.ndarray,  # (n_sites,) remaining renewable windows
    *,
    alpha: float = ALPHA,
    device: DeviceLike = None,
) -> np.ndarray:
    """D_feasible(w, s) = {d | class(w) != C  ∧  T_mig < α·T_d}  (§VI.E).
    8·S is taken in float64 and then rounded to float32, as the JAX
    package rounds its Python scalar."""
    dev = resolve(device)
    v = _evaluate_f32(_f32(8.0 * size_bytes, dev),
                      _f32(np.asarray(bandwidths_bps), dev),
                      _f32(np.asarray(windows_s), dev), alpha)
    return v.feasible.cpu().numpy()
