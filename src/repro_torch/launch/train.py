"""Training launcher (port of ``repro/launch/train.py``): builds the model,
synthetic data pipeline, checkpoint manager and preemption-aware trainer,
and runs ``--steps`` steps.

  PYTHONPATH=src python -m repro_torch.launch.train --arch micro-lm --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 6 --device cpu

Runs on the card unless ``--device cpu`` is given.  The weights are drawn
on that device, by a generator there seeded with ``TrainerConfig.seed``: a
draw on the card and one on the CPU give different weights from the same
seed (the JAX package's ``jax.random`` gives the same values on every
device).
"""
from __future__ import annotations

import argparse
import json
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.traces import generate_trace
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import resolve
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import TrainStepConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="micro-lm")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--ckpt-mode", default="full", choices=["full", "int8", "delta-int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--preempt-with-trace", action="store_true",
                    help="preempt when the site's renewable window closes")
    ap.add_argument("--scenario", default=None,
                    help="drive the preemption trace from a registered "
                         "scenario (see repro_torch.core.scenarios)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    data = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)
    root = args.ckpt_dir or tempfile.mkdtemp(prefix="greenflow_ckpt_")
    ckpt = CheckpointManager(root, job=cfg.name, mode=args.ckpt_mode)

    preempt = None
    if args.scenario:
        from repro_torch.core.scenarios import get_scenario

        scn = get_scenario(args.scenario)
        trace = scn.build_traces()[0]
        print(f"[train] scenario {scn.name!r}: {scn.description}")
        # 1 training step ~ 1 simulated minute, clocked from the site's
        # first surplus window so the demo trains until it closes
        t0 = trace.windows[0].start_s if trace.windows else 0.0
        preempt = lambda step: not trace.active(t0 + step * 60.0)  # noqa: E731
    elif args.preempt_with_trace:
        trace = generate_trace(1, days=1, seed=0)[0]
        preempt = lambda step: not trace.active(step * 60.0)  # noqa: E731

    trainer = Trainer(
        model, data, ckpt,
        TrainerConfig(
            total_steps=args.steps,
            save_every=args.save_every,
            ckpt_mode=args.ckpt_mode,
            step_cfg=TrainStepConfig(
                opt=AdamWConfig(lr=args.lr),
                grad_compress=args.grad_compress,
                total_steps=max(args.steps, 1),
                warmup_steps=max(args.steps // 10, 1),
            ),
        ),
        preempt_signal=preempt,
        device=device,
        generator=torch.Generator(device=device),
    )
    if args.resume:
        try:
            step = trainer.restore()
            print(f"[train] resumed from step {step}")
        except FileNotFoundError:
            trainer.init_state()
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[train] {cfg.name} on {where}: {args.steps} steps of {args.batch} x {args.seq} tokens")
    status = trainer.run()
    print("[train] history:")
    for row in trainer.history:
        print("  ", json.dumps(row))
    print("[train] status:", json.dumps(status))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
