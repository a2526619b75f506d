"""Preemption-aware trainer with checkpoint/restart and migration hooks
(port of ``repro/train/trainer.py``).

This is the single-job execution engine that the paper's orchestrator
manages: it trains until (a) step budget, (b) a preemption signal (renewable
window closing / node failure), or (c) a migration order, checkpointing at
a bounded interval so at most ``save_every`` steps are ever lost.

``state_tree()`` is the reference's ``{"params", "opt", "step"}``, so a
GRNCKPT1 training checkpoint written by either package restores in the
other.  The trainer runs on ``device`` (default: the card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.checkpoint.manager import CheckpointInfo, CheckpointManager
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model import Model
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.train_step import TrainStepConfig, make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 200
    save_every: int = 50
    ckpt_mode: str = "full"  # 'full' | 'int8' | 'delta-int8'
    log_every: int = 25
    seed: int = 0
    step_cfg: TrainStepConfig = field(default_factory=TrainStepConfig)


class Trainer:
    def __init__(
        self,
        model: Model,
        dataset: SyntheticLMDataset,
        ckpt: CheckpointManager,
        cfg: TrainerConfig,
        *,
        preempt_signal: Optional[Callable[[int], bool]] = None,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``generator`` draws the params in ``init_state``, seeded with
        ``cfg.seed`` each time; by default a CPU one, so that a trainer on
        any device starts from the same params.  One on the card draws
        there (``launch/train.py`` passes one on its device): other
        values from the same seed."""
        self.model = model
        self.dataset = dataset
        self.ckpt = ckpt
        self.cfg = cfg
        self.device = resolve(device)
        self.preempt_signal = preempt_signal or (lambda step: False)
        self.generator = generator
        self.train_step = make_train_step(model, cfg.step_cfg)
        self.params = None
        self.opt_state = None
        self.step = 0
        self.history: List[Dict[str, float]] = []
        self.saves: List[CheckpointInfo] = []  # every save's bytes and wall time

    # -- state ---------------------------------------------------------------
    def init_state(self):
        gen = self.generator if self.generator is not None else torch.Generator()
        self.params = self.model.init(generator=gen.manual_seed(self.cfg.seed), device=self.device)
        self.opt_state = init_opt_state(self.params)
        self.step = 0

    def state_tree(self):
        return {"params": self.params, "opt": self.opt_state, "step": np.int32(self.step)}

    def restore(self, shardings=None) -> int:
        """Resume from the newest checkpoint onto the trainer's device (crash
        restart or migration arrival); with ``shardings`` (a
        ``NamedSharding`` tree like ``state_tree()``'s, e.g. of
        ``param_pspecs``), onto that mesh: the elastic restore, after which
        the trainer steps on DTensors.  Returns the restored step."""
        if self.params is None:
            self.init_state()
        tree, _ = self.ckpt.restore(self.state_tree(), device=self.device, shardings=shardings)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.step = int(tree["step"])
        return self.step

    def save(self):
        self.saves.append(self.ckpt.save(self.step, self.state_tree(), mode=self.cfg.ckpt_mode))

    # -- loop ----------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Train until budget or preemption.  Returns a status dict.  Each
        step lies in the span ``trainer.step``, its batch in ``trainer.batch``
        and the logged metrics' reads in ``trainer.log``."""
        if self.params is None:
            self.init_state()
        budget = min(
            self.cfg.total_steps,
            self.step + (max_steps if max_steps is not None else self.cfg.total_steps),
        )
        status = "done"
        while self.step < budget:
            if self.preempt_signal(self.step):
                self.save()
                status = "preempted"
                break
            with spans.span("trainer.step"):
                with spans.span("trainer.batch"):
                    batch = self.dataset.batch(self.step)
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch
                )
                self.step += 1
                if self.step % self.cfg.log_every == 0 or self.step == budget:
                    with spans.span("trainer.log"):  # float() waits for the card
                        row = {k: float(v) for k, v in metrics.items()}
                    row["step"] = self.step
                    self.history.append(row)
            if self.step % self.cfg.save_every == 0:
                self.save()
        if status == "done" and self.step >= self.cfg.total_steps:
            self.save()
        return {
            "status": status,
            "step": self.step,
            "loss": self.history[-1]["loss"] if self.history else float("nan"),
            "ckpt_bytes": self.ckpt.latest_bytes,
        }
