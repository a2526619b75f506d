"""End-to-end example: train a ~100M-parameter LM for a few hundred steps
with periodic checkpointing and ONE live feasibility-gated migration between
two micro-datacenter sites mid-run (port of ``examples/train_micro_lm.py``).
Site A trains until preempted at mid-run, the gate reads the measured
checkpoint bytes, ``migrate_job`` moves the checkpoint, site B restores it
on ``--device`` and finishes.  Asserted: the gate passes, site B resumes at
the preempted step, and the loss falls across the migration.  The
checkpoint directories are removed at the end.

Full run (the deliverable shape; ~100M params, 300 steps):
  PYTHONPATH=src python -m repro_torch.examples.train_micro_lm --arch micro-lm-100m --steps 300

CPU demo (seconds):
  PYTHONPATH=src python -m repro_torch.examples.train_micro_lm --demo --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import flatten_with_paths
from repro_torch.core import feasibility as fz
from repro_torch.core.migration import migrate_job
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import resolve
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_trainer(model, cfg, root, site, steps, batch, seq, lr, device):
    data = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=0)
    ckpt = CheckpointManager(os.path.join(root, site), job="lm100m", mode="full")
    return Trainer(
        model, data, ckpt,
        TrainerConfig(
            total_steps=steps, save_every=max(steps // 6, 10), log_every=max(steps // 12, 5),
            step_cfg=TrainStepConfig(opt=AdamWConfig(lr=lr), total_steps=steps,
                                     warmup_steps=max(steps // 20, 3)),
        ),
        device=device,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="micro-lm-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--demo", action="store_true", help="tiny CPU demo config")
    ap.add_argument("--wan-gbps", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = get_config(args.arch)
    if args.demo:
        cfg = get_config("micro-lm").reduced()
        args.steps = min(args.steps, 60)
    model = build_model(cfg)

    with tempfile.TemporaryDirectory(prefix="greenflow_sites_") as root:
        mid = args.steps // 2

        # --- site A: train until the renewable window closes at mid-run ----
        a = make_trainer(model, cfg, root, "siteA", args.steps, args.batch, args.seq, args.lr,
                         device)
        a.init_state()
        n_params = sum(x.numel() for _, x in flatten_with_paths(a.params))
        print(f"[example] arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps}")
        a.preempt_signal = lambda step: step >= mid
        t0 = time.time()
        sa = a.run()
        print(f"[example] site A preempted at step {sa['step']} "
              f"(loss {sa['loss']:.3f}, {time.time()-t0:.1f}s)")

        # --- orchestrator: feasibility gate on the MEASURED checkpoint -----
        S = a.ckpt.latest_bytes
        verdict = fz.evaluate(S, args.wan_gbps * 1e9, window_s=2.5 * 3600)
        print(f"[example] checkpoint S={S/1e6:.1f} MB, class "
              f"{'ABC'[int(verdict.workload_class)]}, T_cost={float(verdict.t_cost_s):.1f}s, "
              f"feasible={bool(verdict.feasible)}")
        assert bool(verdict.feasible), "migration must be feasible for this job size"

        dst, report = migrate_job(a.ckpt, os.path.join(root, "siteB"),
                                  bandwidth_bps=args.wan_gbps * 1e9, window_s=2.5 * 3600)
        print(f"[example] migrated: T_transfer={report.t_transfer_s:.2f}s modeled, "
              f"serialize={report.t_serialize_s:.2f}s measured, class "
              f"{'ABC'[report.workload_class]}")

        # --- site B: restore and finish ------------------------------------
        b = make_trainer(model, cfg, root, "siteB", args.steps, args.batch, args.seq, args.lr,
                         device)
        b.ckpt = dst
        resumed = b.restore()
        assert resumed == mid
        sb = b.run()
        print(f"[example] site B finished at step {sb['step']} (loss {sb['loss']:.3f})")
    hist = a.history + b.history
    print("[example] loss curve:", json.dumps(
        [{"step": h["step"], "loss": round(h["loss"], 3)} for h in hist]))
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first, "loss must decrease across the migration"
    print(f"[example] OK: loss {first:.3f} -> {last:.3f} across a live migration")
    return dict(site_a=sa, site_b=sb, history=hist, saves=a.saves + b.saves, nbytes=S,
                verdict=verdict, report=report)


if __name__ == "__main__":
    main()
