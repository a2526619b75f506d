"""Quickstart: the feasibility-domain model + one orchestration decision
through the typed Action / ClusterState API (port of
``examples/quickstart.py``).  Algorithm 1's decision scores with the K4
decide kernel on ``--device``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.core import feasibility as fz
from repro_torch.core import (
    ClusterState, FeasibilityAwarePolicy, JobView, SiteView, make_policy,
    available_policies, available_scenarios,
)
from repro_torch.device import resolve

GB = 1e9


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    # --- 1. the paper's core equations ------------------------------------
    for size_gb in (1, 6, 40, 280):
        v = fz.evaluate(size_gb * GB, 10e9, window_s=2.5 * 3600)
        print(
            f"{size_gb:>4} GB @10Gbps: T_transfer={float(v.t_transfer_s):7.1f}s  "
            f"T_cost={float(v.t_cost_s):7.1f}s  T_breakeven={float(v.t_breakeven_s):6.1f}s  "
            f"class={'ABC'[int(v.workload_class)]}  feasible={bool(v.feasible)}"
        )

    # --- 2. one Algorithm-1 decision ---------------------------------------
    # ClusterState.build is the one snapshot constructor shared by the
    # simulator, the dry-run planner and the serve router. With no in-flight
    # transfers the advertised bandwidth matrix is the full per-NIC rate.
    job = JobView(jid=0, site=0, ckpt_bytes=6 * GB, remaining_compute_s=4 * 3600)
    sites = [
        SiteView(0, slots=4, busy=3, queued=2, renewable_active=False, window_remaining_s=0),
        SiteView(1, slots=4, busy=1, queued=0, renewable_active=True, window_remaining_s=3 * 3600),
        SiteView(2, slots=4, busy=4, queued=3, renewable_active=True, window_remaining_s=8 * 3600),
    ]
    state = ClusterState.build(t=0.0, jobs=[job], sites=sites, nic_bps=10e9)
    actions = FeasibilityAwarePolicy(device=device).decide(state)
    print("\nAlgorithm 1 decision:", actions,
          "-> Migrate to the green, *uncongested* site (site 1), not the greener"
          " but congested site 2")

    # --- 3. the policy & scenario registries -------------------------------
    print("\nregistered policies: ", ", ".join(available_policies()))
    print("registered scenarios:", ", ".join(available_scenarios()))
    throttle = make_policy("grid-throttle", power_frac=0.4)
    print("grid-throttle on a dark site:",
          throttle.decide(ClusterState.build(
              t=0.0,
              jobs=[JobView(7, 0, 2 * GB, 3600.0, state="running")],
              sites=[SiteView(0, 4, 1, 0, False, 0.0)],
              nic_bps=10e9)))

    # --- 4. stochastic feasibility (§VI.H) ---------------------------------
    for eps in (0.5, 0.05, 0.01):
        ok = bool(fz.stochastic_feasible(40 * GB, 1e9, window_forecast_s=3600,
                                         window_sigma_s=900, eps=eps))
        print(f"40GB@1Gbps, 1h±15min window, eps={eps}: migrate={ok}")
    return actions


if __name__ == "__main__":
    main()
