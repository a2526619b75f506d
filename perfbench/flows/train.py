"""Steady training: the window runs the trainer one step a call until
``--seconds`` have passed, and ends when the card has finished the last
step.  A ``--trace 1`` run profiles ``trace_steps`` more steps after it."""
import time

import torch

TRACE_WINDOW = False


def window(run, t0: float, deadline: float):
    trainer = run.trainer
    step0 = trainer.step
    while True:
        trainer.run(max_steps=1)
        if time.perf_counter() >= deadline:
            break
    if run.dev.type == "cuda":
        torch.cuda.synchronize(run.dev)
    run.hist = trainer.history[len(trainer.history) - (trainer.step - step0):]
    run.live = trainer


def after_first(run):
    run.live = run.trainer
