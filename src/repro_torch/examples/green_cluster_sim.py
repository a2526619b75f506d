"""Green-cluster simulation driven by the scenario registry: renewable-
window timeline + the paper's policy comparison (Table VI/VIII) on one
shared trace, for any registered scenario (port of
``examples/green_cluster_sim.py``).  The K4-scoring policies decide on
``--device``; a serving scenario runs the chunked serving engine.

  PYTHONPATH=src python -m repro_torch.examples.green_cluster_sim
  PYTHONPATH=src python -m repro_torch.examples.green_cluster_sim --scenario flaky-wan
  PYTHONPATH=src python -m repro_torch.examples.green_cluster_sim --list
"""
from __future__ import annotations

import argparse

from repro_torch.core import (
    available_scenarios, generate_trace, get_scenario, run_policy_comparison,
    trace_stats,
)
from repro_torch.device import resolve

HOUR = 3600.0


def ascii_timeline(traces, days, width=96):
    total = days * 24 * HOUR
    lines = []
    for tr in traces:
        cells = []
        for i in range(width):
            t = total * i / width
            cells.append("#" if tr.active(t) else ".")
        lines.append(f"site{tr.site} |{''.join(cells)}|")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", default="paper-table6",
                    help=f"one of: {', '.join(available_scenarios())}")
    ap.add_argument("--list", action="store_true", help="list scenarios and exit")
    ap.add_argument("--days", type=int, default=None)
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--wan", type=float, default=None,
                    help="override the scenario's per-NIC Gbps (tip: 1.0 on "
                         "paper-table6 is the paper's sharpest ordering "
                         "regime)")
    ap.add_argument("--dt", type=float, default=None,
                    help="fixed-dt engine step (only with --engine fixed-dt)")
    ap.add_argument("--engine", default=None, choices=["event", "fixed-dt"],
                    help="time stepping: next-event (default) or legacy fixed-dt")
    ap.add_argument("--failures", type=float, default=None,
                    help="node failures per slot-hour (overrides the scenario)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    if args.list:
        for name in available_scenarios():
            scn = get_scenario(name)
            print(f"{name:<18} {scn.description}")
        return None

    scn = get_scenario(args.scenario)
    print(f"scenario {scn.name!r}: {scn.description}")
    overrides = {}
    if args.wan is not None:
        overrides["wan_gbps"] = args.wan
    if args.dt is not None:
        overrides["dt_s"] = args.dt
    if args.engine is not None:
        overrides["engine"] = args.engine
    if args.days is not None:
        overrides["days"] = args.days
    if args.jobs is not None:
        overrides["n_jobs"] = args.jobs
    if args.failures is not None:
        overrides["failure_rate_per_slot_hour"] = args.failures
    cfg = scn.sim_config(**overrides)

    traces = generate_trace(cfg.n_sites, cfg.days, seed=cfg.seed, profile=cfg.trace)
    print("renewable-surplus windows (# = surplus):")
    print(ascii_timeline(traces, cfg.days))
    print("trace stats:", trace_stats(traces))

    print("\nrunning 4 policies on the shared trace ...")
    results = run_policy_comparison(cfg, device=device)
    print(f"{'policy':<18} {'nonrenew':>8} {'JCT':>6} {'migr-ovh':>9} "
          f"{'stalls':>7} {'renew%':>7} {'migr':>5} {'failed':>6}")
    base = results["static"]
    for name, r in results.items():
        print(f"{name:<18} {r.grid_kwh/base.grid_kwh:>8.2f} "
              f"{r.mean_jct_s/base.mean_jct_s:>6.2f} {r.migration_overhead:>9.1%} "
              f"{r.stall_overhead:>7.1%} {r.renewable_fraction:>7.1%} "
              f"{r.migrations:>5d} {r.failed_migrations:>6d}")
    print("\npaper Table VI: static 1.00/1.00/0% | energy-only 0.62/1.35/18% |")
    print("               feasibility-aware 0.48/0.82/<2% | oracle 0.40/0.79/<2%")
    return results


if __name__ == "__main__":
    main()
