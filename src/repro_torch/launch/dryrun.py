"""Orchestration plan preview (port of the ``--plan`` half of
``repro/launch/dryrun.py``).

``--plan`` materializes a registered scenario at a chosen sim-time, builds
the same ClusterState snapshot the simulator hands to policies (one shared
constructor, ``repro_torch.core.state.ClusterState.build``) and prints the
typed actions a policy would emit — a what-would-happen preview without
running the sim.  A policy that scores with the K4 decide kernel
(feasibility-aware, oracle, plan-ahead) runs it on ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --plan --scenario flaky-wan \\
      --policy feasibility-aware --at-hour 36

Runs on the card unless ``--device cpu`` is given.  The other half of the
JAX launcher, lowering every (architecture × shape × mesh) cell on a TPU
pod mesh, is not ported (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import argparse
from typing import Tuple

from repro_torch.device import DeviceLike, resolve


def plan_orchestration(
    scenario: str = "paper-table6",
    policy: str = "feasibility-aware",
    at_hour: float = 36.0,
    fill: float = 0.5,
    transfers: Tuple[Tuple[int, int], ...] = (),
    *,
    device: DeviceLike = None,
):
    """Orchestration dry-run: scenario state at sim-time ``at_hour`` ->
    ClusterState (via the shared constructor) -> the policy's typed actions.

    Placement is synthetic but scenario-faithful: the earliest-arrived jobs
    run at their home sites, up to ``fill`` of each site's slots;
    ``transfers`` injects synthetic in-flight ``(src, dst)`` migrations so
    the preview can be taken under WAN load.  Every ``Migrate`` the policy
    proposes is re-checked at the **post-admission** ``(flows+1)`` rate —
    the advertised matrix is the current grant, systematically optimistic
    for a transfer the plan itself would add — and moves that are
    infeasible at the diluted rate are dropped from the plan.  ``device``
    (``None`` = the card) is where a K4-scoring policy decides.  Returns
    (state, actions)."""
    from repro_torch.core import feasibility as fz
    from repro_torch.core.actions import Migrate
    from repro_torch.core.orchestrator import make_policy
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.simulator import generate_jobs
    from repro_torch.core.state import ClusterState, JobView, site_views_from_traces

    scn = get_scenario(scenario)
    cfg = scn.sim_config()
    traces = scn.build_traces()
    t = at_hour * 3600.0
    cap = max(1, int(round(cfg.slots_per_site * fill)))
    per_site = [0] * cfg.n_sites
    views = []
    for j in generate_jobs(cfg):
        if j.arrival_s > t or per_site[j.home_site] >= cap:
            continue
        views.append(JobView(j.jid, j.home_site, j.ckpt_bytes, j.compute_s))
        per_site[j.home_site] += 1
    sites = site_views_from_traces(traces, t, slots=cfg.slots_per_site,
                                   busy=per_site)
    # the same WanTopology the simulator materializes for this scenario
    # (per-link caps, asymmetric NICs, brownout calendar at sim-time t),
    # plus the forecast horizon (σ=0: the planner reads the calendar as-is)
    state = ClusterState.build(t, views, sites, wan=scn.build_wan(),
                               transfers=transfers, traces=traces,
                               signals=scn.build_signals(),
                               battery=cfg.battery)
    jobs_by_id = {j.jid: j for j in state.jobs}
    flows = list(transfers)
    actions = []
    for a in make_policy(policy, device=device).decide(state):
        if isinstance(a, Migrate):
            j = jobs_by_id[a.jid]
            rate = state.post_admission_bps(j.site, a.dest, flows)
            v = fz.evaluate(j.ckpt_bytes, rate,
                            state.site(a.dest).window_remaining_s,
                            t_load_s=j.t_load_s)
            if not bool(v.feasible):
                continue  # optimistic under load: drop from the plan
            flows.append((j.site, a.dest))
        actions.append(a)
    return state, actions


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", action="store_true",
                    help="orchestration plan preview (the only mode ported)")
    ap.add_argument("--scenario", default="paper-table6")
    ap.add_argument("--policy", default="feasibility-aware")
    ap.add_argument("--at-hour", type=float, default=36.0)
    ap.add_argument("--transfers", default="",
                    help="synthetic in-flight migrations for --plan as "
                         "src:dst pairs, e.g. '0:2,0:3' — proposed moves "
                         "are admission-checked at the diluted "
                         "post-admission rate")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    if not args.plan:
        raise NotImplementedError(
            "the mesh-lowering dry-run is not ported to PyTorch yet (ROADMAP "
            "Queue 1, item 12); only --plan is")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

    device = resolve(args.device)
    transfers = tuple(
        (int(s), int(d)) for s, d in
        (pair.split(":") for pair in args.transfers.split(",") if pair))
    state, actions = plan_orchestration(args.scenario, args.policy,
                                        args.at_hour, transfers=transfers,
                                        device=device)
    print(f"[plan] scenario={args.scenario} policy={args.policy} "
          f"t={args.at_hour:.1f}h jobs={len(state.jobs)}")
    if state.battery is not None:
        b = state.battery
        sell = (f" sellback={b.sellback_kw:.1f}kW"
                f"@floor=${b.sellback_price_floor:.2f}/kWh"
                if b.sellback_kw > 0.0 else "")
        print(f"[plan] battery: {b.capacity_kwh:.0f} kWh/site, "
              f"charge<={b.max_charge_kw:.1f}kW "
              f"discharge<={b.max_discharge_kw:.1f}kW "
              f"rte={b.round_trip_efficiency:.2f} "
              f"dark-discharge>={b.discharge_threshold_g:.0f}g/kWh"
              f"{sell}")
    for s in state.sites:
        print(f"[plan]   site{s.sid}: busy={s.busy} "
              f"{'GREEN' if s.renewable_active else 'grid '} "
              f"window={s.window_remaining_s / 3600:.2f}h")
    if not actions:
        print("[plan] no actions")
    for a in actions:
        print(f"[plan]   {a}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
