"""Serving launcher (port of ``repro/launch/serve.py``): batched greedy
decode with a KV cache, plus a green request router over the shared
ClusterState snapshot.

The router is the serving-side analogue of the training orchestrator (cf.
Heron's renewable-aware routing in *AI Greenferencing*): inference batches
are steered toward sites inside renewable windows, load-balanced across
free slots, using the same ``ClusterState.build`` constructor the simulator
and the dry-run planner use.  ``--green-route`` then plays the same burst
through the simulator's serving plane (the chunked engine by default) over
a short simulated horizon.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch micro-lm --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --green-route 64 \
      --scenario solar-heavy --at-hour 12

Runs on the card unless ``--device cpu`` is given: decode runs the model
there, and the simulated horizon's simulator is made for that device.  The
weights are drawn on that device too, by a generator there seeded with
``--seed``: a draw on the card and one on the CPU give different weights
from the same seed (the JAX package's ``jax.random`` gives the same values
on every device).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models.model import build_model


def build_serving_state(scenario: str = "paper-table6", at_hour: float = 12.0,
                        busy: Tuple[int, ...] = (),
                        transfers: Tuple[Tuple[int, int], ...] = ()):
    """Snapshot of the serving fleet at sim-time ``at_hour`` for a
    registered scenario, through the shared ClusterState constructor.
    ``transfers`` injects in-flight ``(src, dst)`` WAN flows so the router
    sees a loaded fabric."""
    from repro_torch.core.scenarios import get_scenario
    from repro_torch.core.state import ClusterState, site_views_from_traces

    scn = get_scenario(scenario)
    cfg = scn.sim_config()
    traces = scn.build_traces()
    t = at_hour * 3600.0
    busy_full = [busy[s] if s < len(busy) else 0 for s in range(cfg.n_sites)]
    sites = site_views_from_traces(traces, t, slots=cfg.slots_per_site,
                                   busy=busy_full)
    # the scenario's materialized WanTopology — identical to what the
    # simulator's transfer loop and the dry-run planner consume — plus the
    # forecast horizon (windows + outage calendar + grid signals) for
    # lookahead / carbon-aware routing
    return ClusterState.build(t, [], sites, wan=scn.build_wan(),
                              transfers=transfers, traces=traces,
                              signals=scn.build_signals())


def green_route(state, n_requests: int, *, origin: int = None,
                min_gbps: float = 0.0, lookahead_s: float = 0.0) -> List[int]:
    """Assign each request to the greenest feasible site: renewable sites
    with free slots first (longest remaining window wins), then spill by
    least relative load once renewable capacity is exhausted.

    With ``lookahead_s`` > 0 the router consumes ``state.forecast``
    instead of only the current snapshot: once current-green capacity is
    exhausted, free-slot sites whose forecast window *starts within the
    lookahead* take the next tier (soonest start wins — the request rides
    the window that is about to open), and the final grid spill breaks
    load ties by the current carbon signal (cleanest grid first; zeros
    when the run carries no signals, reducing to the reactive order).

    With ``origin`` set, each request must ship its batch/KV state from
    ``origin`` to the chosen site, and a remote site is only admissible if
    the **post-admission** ``(flows+1)`` rate on (origin, site) — counting
    both the snapshot's in-flight transfers and the requests this call
    already routed — stays at or above ``min_gbps``.  The advertised
    matrix is the pre-admission grant and is systematically optimistic
    for exactly this check: a saturated uplink that still advertises its
    current share flips the verdict once the request's own dilution is
    counted."""
    load = {s.sid: s.busy for s in state.sites}
    flows = list(state.transfers)
    fc = state.forecast if lookahead_s > 0.0 else None
    next_start = (
        {s.sid: fc.next_window_start_s(s.sid, state.t) for s in state.sites}
        if fc is not None else {})
    carbon = state.site_carbon if lookahead_s > 0.0 else None

    def admissible(s) -> bool:
        if origin is None or s.sid == origin or min_gbps <= 0.0:
            return True
        return state.post_admission_bps(origin, s.sid, flows) >= min_gbps * 1e9

    out: List[int] = []
    for _ in range(n_requests):
        free_green = [s for s in state.sites
                      if s.renewable_active and load[s.sid] < s.slots
                      and admissible(s)]
        if free_green:
            best = max(free_green,
                       key=lambda s: (s.window_remaining_s, -load[s.sid], -s.sid))
        else:
            best = None
            if fc is not None:
                # upcoming-window tier: a site about to turn green beats a
                # grid spill — the request runs mostly inside the window
                soon = [s for s in state.sites
                        if load[s.sid] < s.slots and admissible(s)
                        and state.t < next_start[s.sid]
                        <= state.t + lookahead_s]
                if soon:
                    best = min(soon, key=lambda s: (
                        next_start[s.sid], load[s.sid] / max(s.slots, 1),
                        s.sid))
            if best is None:
                # non-empty: the origin site (or, with no origin, every
                # site) is always admissible
                spill = [s for s in state.sites if admissible(s)]
                best = min(spill, key=lambda s: (
                    load[s.sid] / max(s.slots, 1),
                    not s.renewable_active,
                    float(carbon[s.sid]) if carbon is not None else 0.0,
                    s.sid))
        load[best.sid] += 1
        if origin is not None and best.sid != origin:
            flows.append((origin, best.sid))
        out.append(best.sid)
    return out


@torch.inference_mode()
def greedy_decode(model, params, prompt_tokens: torch.Tensor, max_new: int, cache_len: int):
    """Feed the prompt one token at a time through ``decode_step`` (as the
    JAX launcher does), then ``max_new`` argmax tokens.  Returns
    (B, P + max_new) tokens on the prompt's device."""
    B, P = prompt_tokens.shape
    cache = model.init_cache(B, cache_len, device=prompt_tokens.device)
    tok = prompt_tokens[:, 0]
    out = [tok]
    for i in range(P + max_new - 1):
        logits, cache = model.decode_step(params, cache, {"token": tok, "index": i})
        nxt = torch.argmax(logits, dim=-1).to(prompt_tokens.dtype)
        tok = prompt_tokens[:, i + 1] if i + 1 < P else nxt
        out.append(tok)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="micro-lm")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced() config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--green-route", type=int, default=0, metavar="N",
                    help="route N inference requests across the scenario's "
                         "sites and exit")
    ap.add_argument("--scenario", default="paper-table6")
    ap.add_argument("--at-hour", type=float, default=12.0)
    ap.add_argument("--origin", type=int, default=None,
                    help="site requests originate from; remote routing then "
                         "requires post-admission bandwidth >= --min-gbps")
    ap.add_argument("--min-gbps", type=float, default=0.0)
    ap.add_argument("--lookahead-h", type=float, default=2.0,
                    help="route by *upcoming* forecast windows within this "
                         "many hours (and break grid-spill ties by the "
                         "carbon signal); 0 = reactive snapshot only")
    ap.add_argument("--router", default="green-first",
                    help="serving-plane router for the simulated horizon "
                         "(see repro_torch.core.serving.available_routers)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    if args.green_route > 0:
        # t=0 view: the snapshot router over one shared ClusterState
        state = build_serving_state(args.scenario, args.at_hour)
        routes = green_route(state, args.green_route, origin=args.origin,
                             min_gbps=args.min_gbps,
                             lookahead_s=args.lookahead_h * 3600.0)
        counts = {s.sid: routes.count(s.sid) for s in state.sites}
        carbon = state.site_carbon
        print(f"[serve] green routing {args.green_route} requests "
              f"({args.scenario} @ t={args.at_hour:.1f}h, "
              f"lookahead={args.lookahead_h:.1f}h):")
        for s in state.sites:
            tag = "GREEN" if s.renewable_active else "grid "
            nxt = (state.forecast.next_window_start_s(s.sid, state.t)
                   if state.forecast is not None else float("inf"))
            nxt_h = ((nxt - state.t) / 3600.0) if nxt < float("inf") else -1.0
            print(f"[serve]   site{s.sid} {tag} "
                  f"window={s.window_remaining_s / 3600:.2f}h "
                  f"next_window_in={nxt_h:+.2f}h "
                  f"carbon={carbon[s.sid]:.0f}g/kWh "
                  f"-> {counts[s.sid]} requests")
        # then play the same burst through the event-driven serving plane:
        # replica queues, batch formation, WAN transfer of remote batches,
        # SLO accounting — over a short simulated horizon
        import math

        from repro_torch.core.scenarios import get_scenario
        from repro_torch.core.serving import ServingProfile
        from repro_torch.core.simulator import ClusterSimulator

        n_sites = len(state.sites)
        t0 = args.at_hour * 3600.0
        trace = tuple(
            (t0 + 1e-3 * i,
             args.origin if args.origin is not None else i % n_sites)
            for i in range(args.green_route))
        prof = ServingProfile(arrival_trace=trace)
        # keep the scenario's own horizon so the simulator's traces are
        # the exact ones the t=0 view above was built from
        days = max(get_scenario(args.scenario).days,
                   math.ceil(args.at_hour / 24.0 + 0.5))
        sim = ClusterSimulator.from_scenario(
            args.scenario, "static",
            overrides=dict(n_jobs=0, engine="event", days=days,
                           serving=prof, serving_router=args.router),
            device=device)
        res = sim.run()
        plane = sim.serving
        p50, p95, _ = plane.latency_percentiles()
        print(f"[serve] simulated horizon (router={args.router}): "
              f"served={res.requests_served}/{res.requests_arrived} "
              f"dropped={res.requests_dropped} "
              f"slo_violations={res.slo_violations} "
              f"p50={p50:.2f}s p95={p95:.2f}s "
              f"request_gco2={res.request_gco2:.1f}g")
        for sid in range(n_sites):
            print(f"[serve]   site{sid} routed={plane.site_routed[sid]} "
                  f"served={plane.site_served[sid]} "
                  f"gco2={plane.site_request_gco2[sid]:.1f}g")
        return 0

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.is_encdec or cfg.input_mode == "embeddings":
        raise SystemExit("serve demo targets token-input decoder-only archs")
    model = build_model(cfg)
    params = model.init(generator=torch.Generator(device=device).manual_seed(args.seed),
                        device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen).to(device)
    t0 = time.time()
    seqs = greedy_decode(model, params, prompt, args.tokens, args.prompt_len + args.tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_new = args.batch * args.tokens
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s batched) on {where}")
    print("[serve] sample:", seqs[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
